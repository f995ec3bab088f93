"""gpmpc_tpu_torch.parallel.batch's multistart pieces against gpmpc_tpu's:
`_tile_params` and `_gather_params` (the rank rule, B = 1 and da == B
included), `_shift_u_batch`, `_multistart_phase0` in both surrogate modes
and `solve_batch_multistart` with its frozen pre-refinement and pruned
time-shift phase, at f64. Both sides get n_starts = 1 (u = 0) plus the same
numpy extra_starts, so their start sets are identical; the port's own seeded
draws are held to the JAX package's counts and box.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu import dynamics as jd
from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.parallel import batch as jbatch
from gpmpc_tpu_torch import dynamics as td
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.parallel import batch as tbatch
from torch_port_common import (cost_params_pair, jax_gp, mpc_problem, np_,
                               port_gp, t64)

torch.set_num_threads(1)


def _leaves(case):
    """Cost leaves (numpy) and B for each rank-rule case."""
    rng = np.random.default_rng(0)
    if case == 'shared':
        return 4, dict(Q=np.eye(2), R=np.eye(1), gamma=np.array(0.1),
                       x_ref=np.zeros(2), u_ref=np.zeros(1))
    if case == 'per_lane':
        b = 4
        return b, dict(Q=np.tile(np.eye(2), (b, 1, 1)) * rng.uniform(1, 2, (b, 1, 1)),
                       R=np.eye(1), gamma=rng.normal(size=b),
                       x_ref=rng.normal(size=(b, 2)),
                       u_ref=rng.normal(size=(b, 1)), R_delta=np.eye(1),
                       u_prev=rng.normal(size=(b, 1)))
    if case == 'b1':
        return 1, dict(Q=np.eye(2)[None], R=np.eye(1), gamma=np.array([0.3]),
                       x_ref=rng.normal(size=(1, 2)),
                       u_ref=rng.normal(size=(1, 1)), R_delta=np.eye(1),
                       u_prev=rng.normal(size=(1, 1)))
    # da == B: u_ref, u_prev (da,) and R (da, da) are shared although their
    # leading size equals B; gamma (B,) is per lane.
    return 2, dict(Q=np.eye(2), R=np.eye(2), gamma=np.array([-0.2, 0.2]),
                   x_ref=np.zeros(2), u_ref=rng.normal(size=2),
                   R_delta=np.eye(2), u_prev=rng.normal(size=2))


def _assert_params_equal(tp, jp):
    for name in tp._fields:
        t, j = getattr(tp, name), getattr(jp, name)
        assert (t is None) == (j is None), name
        if t is not None:
            np.testing.assert_array_equal(np_(t), np.asarray(j), err_msg=name)


CASES = ['shared', 'per_lane', 'b1', 'da_eq_b']


@pytest.mark.parametrize('case', CASES)
def test_tile_params_matches_jax(case):
    b, leaves = _leaves(case)
    jp, tp = cost_params_pair(leaves)
    _assert_params_equal(tbatch._tile_params(tp, 3),
                         jbatch._tile_params(jp, b, 3))


@pytest.mark.parametrize('case', CASES)
def test_gather_params_matches_jax(case):
    b, leaves = _leaves(case)
    jp, tp = cost_params_pair(leaves)
    idx = np.array([b - 1, 0, b - 1])
    _assert_params_equal(tbatch._gather_params(tp, torch.as_tensor(idx)),
                         jbatch._gather_params(jp, b, jnp.asarray(idx)))


@pytest.mark.parametrize('k', [1, -1, 2, -2])
def test_shift_u_batch_matches_jax(k):
    u = np.random.default_rng(1).normal(size=(3, 6, 2))
    np.testing.assert_array_equal(np_(tbatch._shift_u_batch(t64(u), k)),
                                  np.asarray(jbatch._shift_u_batch(
                                      jnp.asarray(u), k)))


B, H = 6, 5


@pytest.fixture(scope='module')
def pendulum():
    jgp = jax_gp(n=24, cap=32, seed=0)
    prob = mpc_problem(B, seed=5)
    extra = np.random.default_rng(6).uniform(-0.8, 0.8, (3, B, H, 1))
    return jgp, port_gp(jgp), prob, extra


@pytest.mark.parametrize('mode', ['mean', 'frozen'])
def test_phase0_matches_jax_f64(pendulum, mode):
    """Surrogate descent, pruning after round 0 (frozen) and the
    finite-guarded full-objective argmin pick the same u0."""
    jgp, tgp, prob, extra = pendulum
    jp, tp = cost_params_pair(prob['params'])
    kw = dict(horizon=H, action_dim=1, lb=-1.0, ub=1.0,
              surrogate_mode=mode, frozen_rounds=2, start_scale=0.6, seed=0,
              delta=False, n_zero_starts=0, zero_jitter=0.02, prune_to=2,
              n_starts=1)
    cfg = dict(max_iters=6, tol=1e-3)
    jfn = jax.jit(lambda gp, x0s, params, extra_starts:
                  jbatch._multistart_phase0(
                      jd.build_rollout_cache(gp, 2, 1), x0s, params,
                      surrogate=JSolverConfig(**cfg),
                      extra_starts=extra_starts, **kw))
    j_u0 = jfn(jgp, jnp.asarray(prob['x0s']), jp, jnp.asarray(extra))
    t_u0 = tbatch._multistart_phase0(
        td.build_rollout_cache(tgp, 2, 1), t64(prob['x0s']), tp,
        surrogate=SolverConfig(**cfg), extra_starts=t64(extra), **kw)
    np.testing.assert_allclose(np_(t_u0), np.asarray(j_u0), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize('n_starts,n_zero', [(8, 0), (6, 2), (3, 5)])
def test_port_start_draws(n_starts, n_zero):
    """The port's own draws: JAX's counts (u = 0, min(n_zero, n_starts - 1)
    jittered zeros, the rest wide, then the extra starts), wide draws inside
    start_scale of the box, jittered ones small; the same for a seed, other
    for another seed."""
    b, lb, ub, scale, jitter = 5, -2.0, 3.0, 0.6, 0.02
    x0s = torch.zeros((b, 2), dtype=torch.float64)
    extra = torch.full((2, b, H, 1), 0.25, dtype=torch.float64)

    def draw(seed):
        return np_(tbatch._multistart_starts(x0s, H, 1, lb, ub, n_starts,
                                             n_zero, jitter, scale, seed,
                                             extra))

    s = draw(7)
    nz = min(n_zero, n_starts - 1)
    assert s.shape == (n_starts + 2, b, H, 1)
    assert np.all(s[0] == 0.0)
    mid, span = 0.5 * (lb + ub), 0.5 * (ub - lb)
    jit_rows, wide_rows = s[1:1 + nz], s[1 + nz:n_starts]
    assert np.all(jit_rows != 0.0)
    assert np.all(np.abs(jit_rows) < 8 * jitter * span)
    assert np.all(np.abs(wide_rows - mid) <= scale * span)
    assert wide_rows.size == 0 or np.abs(wide_rows - mid).max() > 8 * jitter * span
    np.testing.assert_array_equal(s[n_starts:], np_(extra))
    np.testing.assert_array_equal(draw(7), s)
    assert not np.array_equal(draw(8)[1:n_starts], s[1:n_starts])


MULTISTART = dict(n_starts=1, frozen_rounds=2, prune_to=2,
                  refine_frozen_rounds=1, refine_frozen_iters=3,
                  shift_set=(1, -1, 2), shift_iters=6, shift_prune=2,
                  shift_prune_frozen_iters=2)


@pytest.mark.parametrize('shift_prune', [2, 0])
def test_solve_batch_multistart_matches_jax_f64(pendulum, shift_prune):
    """Phase 0, the frozen pre-refinement round, the full solve and the
    time-shift phase (pruned after frozen smoothing, or not) with the
    incumbent guard: costs rtol 1e-6, u atol 1e-6, iters and converged
    equal."""
    jgp, tgp, prob, extra = pendulum
    jp, tp = cost_params_pair(prob['params'])
    kw = dict(MULTISTART, shift_prune=shift_prune)
    cfg = dict(max_iters=20, tol=1e-4)
    jfn = jax.jit(functools.partial(
        jbatch.solve_batch_multistart, state_dim=2, action_dim=1, horizon=H,
        lb=-1.0, ub=1.0, solver=JSolverConfig(**cfg), **kw))
    jres = jfn(jgp, x0s=jnp.asarray(prob['x0s']), params=jp,
               extra_starts=jnp.asarray(extra))
    tres = tbatch.solve_batch_multistart(
        tgp, 2, 1, t64(prob['x0s']), tp, H, -1.0, 1.0, SolverConfig(**cfg),
        extra_starts=t64(extra), **kw)
    np.testing.assert_allclose(np_(tres.cost), np.asarray(jres.cost),
                               rtol=1e-6)
    np.testing.assert_allclose(np_(tres.u), np.asarray(jres.u), atol=1e-6)
    np.testing.assert_array_equal(np_(tres.iters), np.asarray(jres.iters))
    np.testing.assert_array_equal(np_(tres.converged),
                                  np.asarray(jres.converged))
