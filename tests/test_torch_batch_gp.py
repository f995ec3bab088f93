"""gpmpc_tpu_torch.parallel.batch.solve_batch_gp and stack_gps against
gpmpc_tpu's at f64 (tests/test_parallel.py:68-76): one GP draw a lane, each
lane solved on the single-scenario route."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.gp import state as gs
from gpmpc_tpu.mpc.cost import CostParams as JCostParams
from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.parallel import batch as jbatch
from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.parallel.batch import solve_batch_gp, stack_gps
from torch_port_common import assert_same_solve, jit_solve, np_, t64

torch.set_num_threads(1)
SOLVER = dict(max_iters=40, tol=1e-6)


def _draw(seed, pkg):
    """A per-draw GP: 24 transitions of seed `seed`, tied lengthscales 2,
    sigma_n 0.05 (f64)."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, (24, 2))
    a = rng.uniform(-1, 1, (24, 1))
    nxt = s + 0.1 * np.concatenate([s[:, 1:], -np.sin(s[:, :1]) + a], axis=1)
    x = np.concatenate([s, a], axis=1)
    kw = dict(log_lambdas=np.log([2.0] * 3), log_sigma_f=0.0,
              log_sigma_n=np.log(0.05))
    if pkg == 'jax':
        return gs.make_gp(gs.GPConfig(capacity=32, x_dim=3, out_dim=2), x,
                          nxt, dtype=jnp.float64, **kw)
    return make_gp(GPConfig(capacity=32, x_dim=3, out_dim=2), x, nxt,
                   dtype=torch.float64, device='cpu', **kw)


def _leaves(gamma):
    return dict(Q=2.0 * np.eye(2), R=0.01 * np.eye(1), gamma=np.asarray(gamma),
                x_ref=np.zeros(2), u_ref=np.zeros(1))


def test_solve_batch_gp_matches_jax():
    """Three draws with a per-lane gamma: equal to JAX's solve_batch_gp,
    and the draws give different controls."""
    jgps = jbatch.stack_gps([_draw(s, 'jax') for s in range(3)])
    tgps = stack_gps([_draw(s, 'torch') for s in range(3)])
    assert tgps.x.shape == (3, 32, 3) and tgps.kinv.shape == (3, 2, 32, 32)
    x0s = np.tile([0.5, -0.5], (3, 1))
    leaves = _leaves((-0.5, 0.0, 0.5))
    jres = jit_solve(lambda g, x0s_j, p: jbatch.solve_batch_gp(
        g, 2, 1, x0s_j, p, 4, -1.0, 1.0, JSolverConfig(**SOLVER)), jgps,
        jnp.asarray(x0s),
        JCostParams(**{k: jnp.asarray(v) for k, v in leaves.items()}))
    tres = solve_batch_gp(tgps, 2, 1, t64(x0s),
                          CostParams(**{k: t64(v) for k, v in leaves.items()}),
                          4, -1.0, 1.0, SolverConfig(**SOLVER))
    # The trace cancels, so the packages' f64 variances agree to ~1e-9
    # relative; 40 L-BFGS iterations carry that into the controls at up to
    # ~3e-7 (tests/test_torch_controller.py's bar); pg_norm is of the order
    # of tol there.
    assert_same_solve(tres, jres, rtol=1e-6, atol=1e-7, pg_atol=1e-6)
    assert not np.allclose(np_(tres.u[0]), np_(tres.u[1]), atol=1e-8)


def test_solve_batch_gp_shared_gamma():
    """A shared gamma broadcasts to every lane: the same solves as a (B,)
    gamma of equal entries."""
    tgps = stack_gps([_draw(s, 'torch') for s in range(2)])
    x0s = t64(np.tile([0.5, -0.5], (2, 1)))
    res = [solve_batch_gp(tgps, 2, 1, x0s, CostParams(
        **{k: t64(v) for k, v in _leaves(gamma).items()}), 4, -1.0, 1.0,
        SolverConfig(**SOLVER)) for gamma in (0.2, (0.2, 0.2))]
    for k in ('u', 'cost', 'iters'):
        torch.testing.assert_close(getattr(res[0], k), getattr(res[1], k),
                                   rtol=0, atol=0)


def test_stack_gps_needs_one_config():
    a = _draw(0, 'torch')
    b = make_gp(GPConfig(capacity=16, x_dim=3, out_dim=2), dtype=torch.float64,
                device='cpu')
    with pytest.raises(ValueError, match='config'):
        stack_gps([a, b])
