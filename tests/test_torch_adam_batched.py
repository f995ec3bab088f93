"""The lockstep projected Adam (gpmpc_tpu_torch.mpc.solver.
solve_trajectory_batched with method='adam') at f64 on the CPU, against JAX's jax.vmap of
gpmpc_tpu.mpc.solver._solve_adam: lanes that stop at different iterations
(their carries frozen, their own step counts and bias corrections), lanes
that reach the cap, a lane whose gradient is not finite, and the polish on
every lane with its own max|g|; u, cost and pg_norm at rtol 1e-8,
iterations equal. Lane b of the batch equals the single solve
(solve_trajectory, the B = 1 case) of lane b to the bit; a state with every
lane done is a fixed point of the step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.mpc.solver import _solve_adam as jadam
from gpmpc_tpu_torch.mpc import solver
from gpmpc_tpu_torch.mpc.solver import (AdamState, SolverConfig,
                                        solve_trajectory,
                                        solve_trajectory_batched)
from torch_port_common import assert_same_solve, np_, t64

torch.set_num_threads(1)
B, H, DA = 5, 4, 2
LB, UB = -1.0, 1.5


def _lane_data():
    """Per-lane curvature w (B,), target c (B, H, DA) and ripple a (B,):
    the stiff lanes stop within a few iterations, the flat ones run to the
    cap; lane 3's target lies outside the box (bound-active coordinates);
    lane 4 starts on the lower bound where its sqrt term has an infinite
    gradient (zeroed in the steps: it stops after one)."""
    rng = np.random.default_rng(4)
    w = np.array([8.0, 0.05, 2.0, 0.5, 1.0])
    c = rng.uniform(-0.8, 1.2, (B, H, DA))
    c[3, 0] = [2.5, -1.7]
    a = np.array([0.1, 0.3, 0.0, 0.2, 0.1])
    u0 = rng.uniform(-0.5, 0.5, (B, H, DA))
    u0[4] = LB
    return w, c, a, u0


def _objective(xp, w, c, a, sqrt_lane):
    """One lane's f(u (H, DA)) -> (): a weighted quadratic, a sine ripple
    and, on the sqrt lane, sum sqrt(u - LB), in numpy-like namespace xp."""
    def f(u):
        val = (w * xp.sum((u - c) ** 2) + a * xp.sum(xp.sin(3.0 * u)))
        if sqrt_lane:
            val = val + 0.1 * xp.sum(xp.sqrt(u - LB))
        return val
    return f


def _torch_objective_b(w, c, a):
    wt, ct, at = t64(w), t64(c), t64(a)

    def f(u):                                        # (B, H, DA) -> (B,)
        val = (wt * torch.sum((u - ct) ** 2, dim=(1, 2))
               + at * torch.sum(torch.sin(3.0 * u), dim=(1, 2)))
        on = (torch.arange(B) == 4)[:, None, None]
        # Double where: the other lanes' sqrt sees 1, so no 0 * inf.
        sq = torch.sum(torch.sqrt(torch.where(on, u - LB, 1.0)), dim=(1, 2))
        return val + 0.1 * torch.where(on[:, 0, 0], sq, 0.0)
    return f


CFGS = {
    'plain': dict(method='adam', max_iters=60, tol=0.2, learning_rate=0.1),
    'polish': dict(method='adam', max_iters=60, tol=0.1, learning_rate=0.2,
                   polish_iters=6),
    'cap_all': dict(method='adam', max_iters=7, tol=1e-12,
                    learning_rate=0.05, polish_iters=2),
}


def _jax_solve(cfg):
    w, c, a, u0 = _lane_data()

    def one(u0_b, w_b, c_b, a_b, sq_b):
        def f(u):
            val = (w_b * jnp.sum((u - c_b) ** 2)
                   + a_b * jnp.sum(jnp.sin(3.0 * u)))
            sq = jnp.sum(jnp.sqrt(jnp.where(sq_b, u - LB, 1.0)))
            return val + 0.1 * jnp.where(sq_b, sq, 0.0)
        return jadam(f, u0_b, LB, UB, JSolverConfig(**cfg))

    return jax.jit(jax.vmap(one))(jnp.asarray(u0), jnp.asarray(w),
                                  jnp.asarray(c), jnp.asarray(a),
                                  jnp.arange(B) == 4)


@pytest.mark.parametrize('name', list(CFGS))
def test_batched_adam_matches_jax_vmap(name):
    """The lockstep Adam of B lanes against JAX's vmapped single Adam: u,
    cost and pg_norm at rtol 1e-8 (NaN where JAX's is), iterations equal
    lane for lane, converged None on both; the lanes stop at different
    iterations ('plain' and 'polish'), and some reach the cap (all but the
    stuck lane 4 in 'cap_all')."""
    cfg = CFGS[name]
    w, c, a, u0 = _lane_data()
    jres = _jax_solve(cfg)
    tres = solve_trajectory_batched(_torch_objective_b(w, c, a), t64(u0), LB,
                                    UB, SolverConfig(**cfg))
    assert_same_solve(tres, jres, rtol=1e-8, atol=1e-12, pg_atol=1e-12)
    iters = np_(tres.iters)
    if name != 'cap_all':
        assert len(set(iters.tolist())) >= 3
        assert iters.max() == cfg['max_iters'] > iters.min()
    else:
        assert (iters[:4] == cfg['max_iters']).all()
    assert iters[4] == 1


@pytest.mark.parametrize('name', ['plain', 'polish'])
def test_each_lane_equals_its_single_solve(name):
    """Lane b of the lockstep solve equals solve_trajectory(method='adam')
    on lane b alone (the B = 1 case) to the bit: a frozen lane keeps its
    carry exactly, whatever the other lanes do."""
    cfg = SolverConfig(**CFGS[name])
    w, c, a, u0 = _lane_data()
    res = solve_trajectory_batched(_torch_objective_b(w, c, a), t64(u0), LB,
                                   UB, cfg)
    for b in range(B):
        one = solve_trajectory(
            _objective(torch, t64(w[b]), t64(c[b]), t64(a[b]), b == 4),
            t64(u0[b]), LB, UB, cfg)
        for k in ('u', 'cost', 'iters', 'pg_norm'):
            got, want = getattr(res, k)[b], getattr(one, k)
            assert torch.equal(got, want) or (
                not bool(torch.isfinite(want))
                and not bool(torch.isfinite(got))), (b, k)
        assert one.converged is None


def test_done_state_is_a_fixed_point():
    """`_adam_step` on a state with every lane done returns every field
    unchanged (the loop index t included)."""
    w, c, a, u0 = _lane_data()
    cfg = SolverConfig(**CFGS['plain'])
    obj = _torch_objective_b(w, c, a)
    n = H * DA
    lb, ub = (torch.full((B, n), v, dtype=torch.float64) for v in (LB, UB))
    p = solver._Problem(
        val_and_grad=lambda x: solver._value_and_grad(obj, x, (B, H, DA)),
        lb=lb, ub=ub, zero=torch.zeros((), dtype=torch.float64), config=cfg,
        method='adam')
    s = solver._adam_init(p, t64(u0).reshape(B, n))
    for _ in range(5):
        s = solver._adam_step(p, s)
    s = s._replace(done=torch.ones_like(s.done))
    s2 = solver._adam_step(p, s)
    for name, x, y in zip(AdamState._fields, s2, s):
        assert torch.equal(x, y), name


def test_unknown_method_raises():
    with pytest.raises(ValueError, match='unknown method'):
        solve_trajectory_batched(lambda u: u.sum((1, 2)),
                                 torch.zeros((2, 3, 1)), -1.0, 1.0,
                                 SolverConfig(method='sgd'))


def test_adam_with_an_external_val_and_grad_raises():
    """An external (f, g) oracle runs under L-BFGS only: Adam with one
    raises rather than running another method."""
    def vg(u):
        return u.sum((1, 2)), torch.ones_like(u)

    with pytest.raises(ValueError, match='L-BFGS only'):
        solve_trajectory_batched(None, torch.zeros((2, 3, 1)), -1.0, 1.0,
                                 SolverConfig(method='adam'), val_and_grad=vg)
