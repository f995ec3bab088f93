"""gpmpc_tpu_torch.parallel.batch.solve_batch_multistart_retired and
solve_batch_staged against gpmpc_tpu's.

The cases of tests/test_retired.py run on the port with the same integrator
GP; at f64 on a small pendulum problem the retired recipe, entering every
phase (tail chunks, exchange rounds with shifts, neighbours, shifted
neighbours and the smoothed incumbent, rescue and polish), with and without
the pre-gate, matches JAX's per-lane cost at rtol 1e-6, u at atol 1e-6, and
iters, converged and the diag counters exactly; and solve_batch_staged
likewise. Port-only cases hold the reference-side faults the port does not
copy: pregate with prefilter=0 raises, and a rescue lane padded with repeats
of itself keeps its best candidate.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.gp import state as gp_state
from gpmpc_tpu.mpc.cost import CostParams as JCostParams
from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.parallel import batch as jbatch
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import SolverConfig, SolveResult
from gpmpc_tpu_torch.parallel import batch as tbatch
from torch_port_common import (cost_params_pair, jax_gp, mpc_problem, np_,
                               port_gp, t64)

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(scope='module')
def integrator_problem():
    """tests/test_retired.py's integrator GP, carried across to the port."""
    rng = np.random.default_rng(0)
    s = rng.uniform(-10, 10, (80, 1))
    a = rng.uniform(-1, 1, (80, 1))
    cfg = gp_state.GPConfig(capacity=80, x_dim=2, out_dim=1)
    gp = gp_state.make_gp(cfg, dtype=jnp.float64)
    gp = gp_state.append(gp, np.concatenate([s, a], 1), s + a)
    gp = gp_state.set_hyperparams(gp, [2.0, 2.0], 3.0, 1e-5)
    b = 6
    params = CostParams(Q=2 * torch.eye(1, dtype=F64),
                        R=torch.zeros((1, 1), dtype=F64),
                        gamma=torch.full((b,), 1e-5, dtype=F64),
                        x_ref=torch.zeros(1, dtype=F64),
                        u_ref=torch.zeros(1, dtype=F64))
    return port_gp(gp), torch.full((b, 1), 5.0, dtype=F64), params


def _integrator_solver(max_iters):
    return SolverConfig(max_iters=max_iters, tol=1e-6, noise_rel=3e-4,
                        progress_window=10)


def test_known_answer_all_lanes(integrator_problem):
    """u* = [-1]*H from x0 = 5 in [-1, 1] through every phase of the port's
    retired driver (tail continuation + gated shift refinement)."""
    gp, x0s, params = integrator_problem
    diag = {}
    res = tbatch.solve_batch_multistart_retired(
        gp, 1, 1, x0s, params, 5, -1.0, 1.0, _integrator_solver(40),
        n_starts=4, prune_to=2, budget1=20, tail_divisor=3,
        shift_set=(1, -1), shift_iters=10, shift_top=2,
        shift_smooth_iters=3, shift_margin=0.05, diag=diag)
    np.testing.assert_allclose(np_(res.u), -np.ones((6, 5, 1)), atol=5e-3)
    assert bool(torch.isfinite(res.cost).all())
    assert 'n_tail' in diag and 'n_shift_worthy' in diag


def test_never_worse_than_phase_a_incumbent(integrator_problem):
    """With budget1 == max_iters phase A is the same with and without the
    shift phase, which applies only strict improvements."""
    gp, x0s, params = integrator_problem
    kw = dict(n_starts=4, prune_to=2, budget1=30, tail_divisor=3)
    solver = _integrator_solver(30)
    c0 = np_(tbatch.solve_batch_multistart_retired(
        gp, 1, 1, x0s, params, 5, -1.0, 1.0, solver, shift_set=(),
        **kw).cost)
    c1 = np_(tbatch.solve_batch_multistart_retired(
        gp, 1, 1, x0s, params, 5, -1.0, 1.0, solver, shift_set=(1, -1),
        shift_iters=8, shift_top=2, shift_smooth_iters=2, shift_margin=1.0,
        **kw).cost)
    assert np.all(c1 <= c0 + 1e-12), (c0, c1)


@pytest.mark.parametrize('pregate', [False, True])
def test_pregate_and_legacy_solve_known_answer(integrator_problem, pregate):
    gp, x0s, params = integrator_problem
    res = tbatch.solve_batch_multistart_retired(
        gp, 1, 1, x0s, params, 5, -1.0, 1.0, _integrator_solver(30),
        pregate=pregate, n_starts=4, prune_to=2, budget1=30, tail_divisor=3,
        shift_set=(1, -1), shift_iters=8, shift_top=2, shift_smooth_iters=2,
        shift_margin=1.0)
    np.testing.assert_allclose(np_(res.u), -np.ones((6, 5, 1)), atol=5e-3)


def test_rescue_phase_improves_only(integrator_problem):
    gp, x0s, params = integrator_problem
    kw = dict(n_starts=4, prune_to=2, budget1=30, tail_divisor=3,
              shift_set=())
    solver = _integrator_solver(30)
    c0 = np_(tbatch.solve_batch_multistart_retired(
        gp, 1, 1, x0s, params, 5, -1.0, 1.0, solver, **kw).cost)
    diag = {}
    c1 = np_(tbatch.solve_batch_multistart_retired(
        gp, 1, 1, x0s, params, 5, -1.0, 1.0, solver, rescue_lanes=3,
        rescue_starts=3, rescue_iters=10, diag=diag, **kw).cost)
    assert np.all(c1 <= c0 + 1e-12), (c0, c1)
    assert 'n_rescue' in diag


# The pendulum problem at f64: b = 8 lanes, H = 5. Both sides get
# n_starts = 1 (u = 0) and the same numpy extra_starts, so their start sets
# are identical. The configuration enters every phase of the recipe.
B, H = 8, 5
SOLVER = dict(max_iters=30, tol=1e-6, noise_rel=3e-4, progress_window=6)
RECIPE = dict(n_starts=1, prune_to=2, frozen_rounds=2, budget1=8,
              tail_divisor=2, shift_set=(1, -1), shift_iters=6, shift_top=2,
              shift_smooth_iters=2, shift_margin=0.05,
              shift_lanes_per_chunk=4, shift_rounds=2, shift_max_lanes=3,
              neighbor_set=2, neighbor_shifted=1, propose_smoothed=True,
              rescue_lanes=1, rescue_starts=2, rescue_iters=6,
              polish_lanes=2, polish_iters=8)


@pytest.fixture(scope='module')
def pendulum():
    jgp = jax_gp(n=24, cap=32, seed=0)
    prob = mpc_problem(B, seed=3)
    extra = np.random.default_rng(4).uniform(-0.8, 0.8, (2, B, H, 1))
    return jgp, port_gp(jgp), prob, extra


def _both_retired(pendulum, **kw):
    jgp, tgp, prob, extra = pendulum
    jp, tp = cost_params_pair(prob['params'])
    cfg = dict(RECIPE, **kw)
    jdiag, tdiag = {}, {}
    jres = jbatch.solve_batch_multistart_retired(
        jgp, 2, 1, jnp.asarray(prob['x0s']), jp, H, -1.0, 1.0,
        JSolverConfig(**SOLVER), extra_starts=jnp.asarray(extra), diag=jdiag,
        **cfg)
    tres = tbatch.solve_batch_multistart_retired(
        tgp, 2, 1, t64(prob['x0s']), tp, H, -1.0, 1.0, SolverConfig(**SOLVER),
        extra_starts=t64(extra), diag=tdiag, **cfg)
    return jres, jdiag, tres, tdiag


def _assert_result_matches(jres, tres):
    np.testing.assert_allclose(np_(tres.cost), np.asarray(jres.cost),
                               rtol=1e-6)
    np.testing.assert_allclose(np_(tres.u), np.asarray(jres.u), atol=1e-6)
    np.testing.assert_array_equal(np_(tres.iters), np.asarray(jres.iters))
    np.testing.assert_array_equal(np_(tres.converged),
                                  np.asarray(jres.converged))


@pytest.mark.parametrize('pregate', [False, True])
def test_retired_matches_jax_f64(pendulum, pregate):
    jres, jdiag, tres, tdiag = _both_retired(pendulum, pregate=pregate)
    assert tdiag == jdiag
    # Every phase ran: a tail, exchange rounds, a rescue lane, the polish.
    assert tdiag['n_tail'] > 0 and tdiag['n_shift_worthy'] > 0
    assert tdiag['n_rescue'] == RECIPE['rescue_lanes']
    assert tdiag['n_polish'] == RECIPE['polish_lanes']
    _assert_result_matches(jres, tres)


def test_staged_matches_jax_f64(pendulum):
    jgp, tgp, prob, _ = pendulum
    jp, tp = cost_params_pair(prob['params'])
    kw = dict(budget1=4, budget_total=30, tail_divisor=3)
    jres = jbatch.solve_batch_staged(jgp, 2, 1, jnp.asarray(prob['x0s']), jp,
                                     H, -1.0, 1.0,
                                     JSolverConfig(max_iters=30, tol=1e-4),
                                     **kw)
    tres = tbatch.solve_batch_staged(tgp, 2, 1, t64(prob['x0s']), tp, H,
                                     -1.0, 1.0,
                                     SolverConfig(max_iters=30, tol=1e-4), **kw)
    assert not np.all(np.asarray(jres.iters) <= kw['budget1'])
    _assert_result_matches(jres, tres)


def test_prefilter_zero_with_pregate_raises(pendulum):
    _, tgp, prob, _ = pendulum
    _, tp = cost_params_pair(prob['params'])
    with pytest.raises(ValueError):
        tbatch.solve_batch_multistart_retired(
            tgp, 2, 1, t64(prob['x0s']), tp, H, -1.0, 1.0, pregate=True,
            prefilter=0)


def test_padded_rescue_keeps_best_duplicate(pendulum, monkeypatch):
    """Rescue pads its lanes with repeats of the first, each with its own
    draws. A stub refinement gives every repeat of that lane a different
    improving cost: the lane keeps the best (the JAX package keeps the
    last). The other phases are off; phase A's stub result is the
    incumbent."""
    _, tgp, prob, _ = pendulum
    _, tp = cost_params_pair(prob['params'])
    x0s = t64(prob['x0s'])
    inc_cost = torch.ones(B, dtype=F64)
    inc_cost[5] = 100.0                          # the one genuine outlier

    def phase_a(*args, **kw):
        return SolveResult(u=torch.zeros((B, H, 1), dtype=F64), cost=inc_cost,
                           iters=torch.zeros(B, dtype=torch.long),
                           pg_norm=torch.zeros(B, dtype=F64),
                           converged=torch.ones(B, dtype=torch.bool))

    calls = []

    def refine(cache, x0s_c, params_c, u_init_c, lb, ub, cfg, delta):
        # Cost of a start: 50 minus its column's index (the later the
        # repeat, the lower), so that the best candidate is not the last
        # improving one; u carries its column.
        n = u_init_c.shape[0]
        n_r = 4
        col = torch.arange(n) % n_r
        cost = 50.0 - col.to(F64)
        cost[col == 2] = 10.0                    # the best repeat
        cost[col == 3] = 40.0                    # the last, improving too
        calls.append(n)
        return SolveResult(u=col.to(F64)[:, None, None].expand(n, H, 1),
                           cost=cost, iters=torch.full((n,), 3),
                           pg_norm=torch.zeros(n, dtype=F64),
                           converged=torch.ones(n, dtype=torch.bool))

    monkeypatch.setattr(tbatch, '_retired_phase_a', phase_a)
    monkeypatch.setattr(tbatch, '_refine_chunk', refine)
    diag = {}
    res = tbatch.solve_batch_multistart_retired(
        tgp, 2, 1, x0s, tp, H, -1.0, 1.0, SolverConfig(max_iters=4),
        budget1=4, shift_set=(), rescue_lanes=4, rescue_starts=2, diag=diag)
    assert diag['n_rescue'] == 1 and len(calls) == 1
    cost = np_(res.cost)
    assert cost[5] == 10.0 and np.all(np_(res.u)[5] == 2.0)
    others = np.delete(np.arange(B), 5)
    np.testing.assert_array_equal(cost[others], 1.0)
    assert int(res.iters[5]) == 3 and int(res.iters[others].max()) == 0


@pytest.mark.parametrize('driver', ['multistart', 'retired', 'staged'])
def test_x0s_on_another_device_raises(pendulum, driver):
    _, tgp, prob, _ = pendulum
    _, tp = cost_params_pair(prob['params'])
    fn = dict(multistart=tbatch.solve_batch_multistart,
              retired=tbatch.solve_batch_multistart_retired,
              staged=tbatch.solve_batch_staged)[driver]
    with pytest.raises(ValueError, match='device|lies on'):
        fn(tgp, 2, 1, t64(prob['x0s']).to('meta'), tp, H, -1.0, 1.0)


def test_recipe_quality_probe_runs_on_cpu(monkeypatch):
    """benchmarks/recipe_quality's path at b = 2 with the recipe's budgets
    and chunks cut: a row for the seed and for each diagnostic, each
    scored (finite) and through the phases it runs; the trace swaps end
    with their rows."""
    from gpmpc_tpu_torch.benchmarks import recipe_quality as rq
    monkeypatch.setattr(rq, 'RECIPE', dict(
        rq.RECIPE, surrogate=SolverConfig(max_iters=2), frozen_rounds=1,
        shift_iters=2, shift_smooth_iters=1, shift_lanes_per_chunk=2,
        polish_iters=2))
    monkeypatch.setattr(rq, 'REFINE', dict(rq.REFINE, max_iters=3))
    k1 = rq.vt.variance_trace_batched_tied
    out = rq.run(device='cpu', b=2, seeds=(0,))
    assert rq.vt.variance_trace_batched_tied is k1
    assert set(out['rows']) == {'seed 0', 'f64 seed 0', 'trace64 seed 0',
                                'phase_a', 'k1_f32', 'fwd64', 'plain32'}
    # The default f32 path is the f64 trace rounded: trace64 to the digit.
    for k in ('p50', 'p90', 'max', 'lanes_above_1pct'):
        assert out['rows']['trace64 seed 0'][k] == out['rows']['seed 0'][k]
    assert out['rows']['phase_a']['diag'] == {'n_tail': out['rows'][
        'phase_a']['diag']['n_tail']}
    for key, row in out['rows'].items():
        assert np.isfinite([row['p50'], row['p90'], row['max']]).all()
        if key != 'phase_a':
            assert row['diag']['n_polish'] == 2
            assert 'n_shift_worthy' in row['diag']
