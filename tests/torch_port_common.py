"""Shared helpers for the tests that hold gpmpc_tpu_torch against gpmpc_tpu.

Inputs are made with numpy from a seed and handed to both packages; arrays
cross between them as numpy. The JAX side runs on the CPU with x64 on
(tests/conftest.py), the port with device='cpu'.
"""

import numpy as np
import torch

import jax.numpy as jnp

from gpmpc_tpu.gp import state as gs
from gpmpc_tpu_torch.convert import FIELDS, gp_state_from_numpy

F64 = torch.float64


def t64(a):
    """numpy / JAX array -> float64 CPU tensor."""
    return torch.tensor(np.asarray(a), dtype=F64)


def np_(t):
    return t.detach().cpu().numpy()


def port_gp(jgp, dtype=F64):
    """The port's GPState carrying a JAX GPState's posterior (no refit)."""
    return gp_state_from_numpy({k: np.asarray(getattr(jgp, k)) for k in FIELDS},
                               tied_lambdas=bool(jgp.config.tied_lambdas),
                               device='cpu', dtype=dtype)


def gp_data(n=24, ds=2, da=1, seed=0):
    """Small pendulum-like transition data: x (n, ds+da), next states (n, ds)."""
    rng = np.random.default_rng(seed)
    states = rng.uniform(-1, 1, (n, ds))
    actions = rng.uniform(-1, 1, (n, da))
    next_states = states + 0.1 * actions + 0.05 * np.sin(states)
    return np.concatenate([states, actions], axis=1), next_states


def jax_gp(n=24, cap=32, ds=2, da=1, seed=0, log_lambdas=None, sigma_n=1e-2,
           dtype=jnp.float64):
    """A JAX GPState on gp_data; tied lengthscales 2 unless given."""
    x, y = gp_data(n, ds, da, seed)
    if log_lambdas is None:
        log_lambdas = np.log([2.0] * (ds + da))
    cfg = gs.GPConfig(capacity=cap, x_dim=ds + da, out_dim=ds)
    return gs.make_gp(cfg, x, y, log_lambdas=log_lambdas, log_sigma_f=0.0,
                      log_sigma_n=np.log(sigma_n), dtype=dtype)


def mpc_problem(b, seed=0):
    """A small MPC problem on gp_data's GP (ds = 2, da = 1), as numpy: x0s
    (b, 2) and the cost leaves with a (b,) gamma sweep over [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    return dict(x0s=rng.uniform(-1, 1, (b, 2)),
                params=dict(Q=2.0 * np.eye(2), R=0.01 * np.eye(1),
                            gamma=np.linspace(-0.5, 0.5, b),
                            x_ref=np.zeros(2), u_ref=np.zeros(1)))


def cost_params_pair(leaves):
    """(gpmpc_tpu CostParams, gpmpc_tpu_torch CostParams) of numpy leaves."""
    from gpmpc_tpu.mpc.cost import CostParams as JCostParams
    from gpmpc_tpu_torch.mpc.cost import CostParams as TCostParams
    return (JCostParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            TCostParams(**{k: t64(v) for k, v in leaves.items()}))


def untied_log_lambdas(ds=2, da=1):
    """Per-output lengthscales that differ (the untied K2 path)."""
    return np.log(np.array([[2.0, 1.5, 3.0], [1.2, 2.5, 1.8]])[:ds, :ds + da])


def spd(rng, shape, d, scale=0.1):
    """Random SPD matrices of shape (*shape, d, d)."""
    m = rng.normal(size=tuple(shape) + (d, d))
    return m @ np.swapaxes(m, -1, -2) * scale + np.eye(d)


def sym(rng, e, n, scale=0.003):
    """Random symmetric (E, N, N) stand-in for b_lam."""
    br = rng.normal(size=(e, n, n)) * scale
    return br + np.swapaxes(br, -1, -2)


def jit_solve(fn, *args):
    """fn(*args) under jax.jit: JAX's eager while loops re-trace on every
    call, so a jitted solve compiles once and runs in milliseconds. args are
    pytrees of arrays; configs go in fn's closure."""
    import jax
    return jax.jit(fn)(*args)


def assert_same_solve(tres, jres, rtol=1e-8, atol=1e-10, pg_atol=1e-7):
    """A port SolveResult against JAX's: u and cost at rtol / atol (the solve
    tolerance of tests/test_batched.py by default), iters and converged
    equal (converged None on both for Adam), and pg_norm, a residual below
    the solver's tol at the stop, within pg_atol."""
    np.testing.assert_allclose(np_(tres.u), np.asarray(jres.u), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(np_(tres.cost), np.asarray(jres.cost),
                               rtol=rtol, atol=atol)
    np.testing.assert_array_equal(np_(tres.iters), np.asarray(jres.iters))
    np.testing.assert_allclose(np_(tres.pg_norm), np.asarray(jres.pg_norm),
                               rtol=1e-6, atol=pg_atol)
    if jres.converged is None:
        assert tres.converged is None
    else:
        np.testing.assert_array_equal(np_(tres.converged),
                                      np.asarray(jres.converged))


A_NOM = np.array([[0.9, 0.1], [-0.08, 0.85]])
B_NOM = np.array([[0.0], [0.12]])


def nominal_gp_pair(n=30, cap=32, seed=23):
    """A residual GP over an affine nominal model (tests/test_nominal.py's
    plant), in both packages from the same numpy data: (JAX GPState, port
    GPState, rng after the draws)."""
    from gpmpc_tpu_torch.gp.state import GPConfig, make_gp

    def nominal_j(xs):
        return (xs[:, :2] @ jnp.asarray(A_NOM).T
                + xs[:, 2:] @ jnp.asarray(B_NOM).T)

    def nominal_t(xs):
        return xs[:, :2] @ t64(A_NOM).T + xs[:, 2:] @ t64(B_NOM).T

    rng = np.random.default_rng(seed)
    s = rng.uniform(-2, 2, (n, 2))
    a = rng.uniform(-1, 1, (n, 1))
    nxt = s @ A_NOM.T + a @ B_NOM.T + 0.25 * np.stack(
        [np.sin(s[:, 0]), np.cos(2 * s[:, 1])], axis=1)
    x = np.concatenate([s, a], axis=1)
    kw = dict(log_lambdas=np.log([2.0] * 3), log_sigma_f=np.log(0.5),
              log_sigma_n=np.log(0.05))
    jgp = gs.make_gp(gs.GPConfig(capacity=cap, x_dim=3, out_dim=2,
                                 nominal_fn=nominal_j), x, nxt,
                     dtype=jnp.float64, **kw)
    tgp = make_gp(GPConfig(capacity=cap, x_dim=3, out_dim=2,
                           nominal_fn=nominal_t), x, nxt,
                  dtype=torch.float64, device='cpu', **kw)
    return jgp, tgp, rng


# The stand-in CUDA graphs live in torch_stand_in.py (no JAX there, so that
# the ranks of tests/torch_dist_worker.py can use them too).
from torch_stand_in import (REPLAYING, StandInGraph, StandInLoop,  # noqa: E402,F401
                            stand_in_capture, use_stand_in_graphs)
