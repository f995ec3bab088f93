"""The solver's kept programs (gpmpc_tpu_torch/mpc/solver.py), the port's
counterpart of jax.jit's compiled-program cache, on the CPU with stand-ins
for the CUDA graphs (torch_port_common.use_stand_in_graphs): every call of a
kept program equals a fresh solve and the eager loop to the bit while its
inputs change; each key field makes a new program and the same key is a
hit; no result is a view of a program's buffer; the LRU bounds and
clear_programs(); the eager swap never touches the cache; every key of a
recipe is captured once across calls; and three controller steps with
appends between them on one program equal JAX's controller at f64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.mpc.controller import RiskSensitiveMPC as JMPC
from gpmpc_tpu.mpc.solver import SolverConfig as JConfig
from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.gp import state as gp_state
from gpmpc_tpu_torch.mpc import solver
from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC as TMPC
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.parallel import batch
from gpmpc_tpu_torch.problems import make_headline_problem
from gpmpc_tpu_torch.utils import replay_counts
from torch_port_common import (REPLAYING, StandInGraph, gp_data,
                               untied_log_lambdas, use_stand_in_graphs)

torch.set_num_threads(2)

F64 = torch.float64
CFG = SolverConfig(max_iters=12, tol=1e-6)


def _problem(b=4, horizon=3, dtype=F64, untied=False):
    p = make_headline_problem(b=b, n_train=24, capacity=32, horizon=horizon,
                              dtype=dtype, device='cpu')
    if untied:
        n = int(p.gp.count)
        p = p._replace(gp=gp_state.make_gp(
            p.gp.config, p.gp.x[:n].numpy(), p.gp.y[:, :n].T.numpy(),
            log_lambdas=untied_log_lambdas(), log_sigma_f=0.0,
            log_sigma_n=np.log(0.1), dtype=dtype, device='cpu'))
        assert not p.gp.config.tied_lambdas
    return p


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}.get(t.dtype, t.dtype))


def _same(a, b):
    for name, x, y in zip(a._fields, a, b):
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(_bits(x), _bits(y)), name


def _stand_in_capture(record, s, pool=None):
    """torch_port_common.stand_in_capture for a state of any method
    (LbfgsState, AdamState): the host calls run once on a copy."""
    before = replay_counts.snapshot()
    record(type(s)(*(x.clone() for x in s)))
    return StandInGraph(record, s), replay_counts.Replays(
        before, replay_counts.snapshot(), [])


@pytest.fixture
def captures(monkeypatch):
    """Stand-in graphs; yields the list of captures the solver takes."""
    use_stand_in_graphs(monkeypatch)
    seen = []

    def counted(record, s, pool=None):
        seen.append(record)
        return _stand_in_capture(record, s, pool)

    monkeypatch.setattr(solver, '_capture', counted)
    yield seen
    solver.clear_programs()


def _three_ways(solve):
    """solve() reused (the cache as it is), fresh (the cache emptied first)
    and eager (the loop swapped for the eager one, as chip_smoke's
    eager_loop does): the three results, equal to the bit."""
    reused = solve()
    kept = dict(solver._PROGRAMS)
    solver._PROGRAMS.clear()
    fresh = solve()
    solver.clear_programs()
    solver._PROGRAMS.update(kept)
    graphed = solver._run_graphed
    solver._run_graphed = solver._run_eager
    try:
        eager = solve()
    finally:
        solver._run_graphed = graphed
    _same(reused, fresh)
    _same(reused, eager)
    return reused


def test_program_calls_equal_fresh_solves(captures):
    """One program over five calls of solve_batch whose x0s, per-lane gamma,
    GP (an append), box and u_init change between calls: each call equals
    a fresh solve and the eager loop to the bit; the program is captured
    once (step and init) and hit on every later call; a tally of the
    objective's Python calls counts 1 + iterations value-and-grads on
    every call, replays included."""
    p = _problem()
    rng = np.random.default_rng(1)
    calls = {'vg': 0}
    orig = batch.rollout_batched

    def counted(*args, **kw):
        if not REPLAYING[0]:
            calls['vg'] += 1
        return orig(*args, **kw)

    def add(delta):
        for k, n in delta.items():
            calls[k] += n

    gp, x0s, params = p.gp, p.x0s, p.params
    lb, ub, u_init = p.lb, p.ub, None
    with replay_counts.registered(lambda: dict(calls), add):
        batch.rollout_batched = counted
        try:
            for call in range(5):
                if call == 1:
                    x0s = torch.tensor(rng.uniform(-1, 1, (4, 2)))
                    params = params._replace(
                        gamma=torch.tensor(rng.uniform(-0.5, 0.5, 4)))
                elif call == 2:
                    gp = gp_state.append(gp, rng.uniform(-1, 1, (2, 3)),
                                         rng.uniform(-1, 1, (2, 2)))
                elif call == 3:
                    lb, ub = -0.7, 0.4
                elif call == 4:
                    u_init = torch.tensor(rng.uniform(-0.5, 0.5, (4, 3, 1)))
                n0 = len(captures)
                calls['vg'] = 0
                res = batch.solve_batch(gp, 2, 1, x0s, params, p.horizon, lb,
                                        ub, CFG, u_init=u_init)
                assert calls['vg'] == 1 + int(res.iters.max()), call
                assert len(captures) == n0 + (2 if call == 0 else 0)
                _three_ways(lambda: batch.solve_batch(
                    gp, 2, 1, x0s, params, p.horizon, lb, ub, CFG,
                    u_init=u_init))
        finally:
            batch.rollout_batched = orig
    assert len(solver._PROGRAMS) == 1
    assert int(res.iters.max()) >= 3


def _objective_solve(field):
    """A solve through batch_objective with one key field changed from the
    base ('base' changes none)."""
    p = _problem(b=3 if field == 'B' else 4,
                 horizon=4 if field == 'H' else 3,
                 dtype=torch.float32 if field == 'dtype' else F64,
                 untied=field == 'untied')
    params = p.params
    if field == 'R_delta':
        params = params._replace(R_delta=0.1 * torch.eye(1, dtype=F64))
    obj = batch.batch_objective(
        build_rollout_cache(p.gp, 2, 1), p.x0s, params,
        delta=field == 'delta', full_cov=field == 'full_cov',
        action_var=2e-3 if field == 'action_var' else 1e-3)
    u0 = p.x0s.new_zeros((p.x0s.shape[0], p.horizon, 1))
    cfg = CFG.replace(max_iters=9) if field == 'config' else CFG
    return solver.solve_trajectory_batched(obj, u0, p.lb, p.ub, cfg)


KEY_FIELDS = ('untied', 'full_cov', 'delta', 'B', 'H', 'dtype', 'config',
              'R_delta', 'action_var', 'sym')


@pytest.mark.parametrize('field', KEY_FIELDS)
def test_each_key_field_makes_a_program(captures, monkeypatch, field):
    """The base solve twice is one program, captured once; a change of one
    key field (tied or untied lengthscales, full_cov, delta, B, H, dtype,
    the SolverConfig, R_delta set, action_var, GPMPC_SYM_KERNEL) makes a
    second program, and its result equals a fresh solve and the eager loop
    to the bit: a stale program is never replayed."""
    if field != 'sym':
        monkeypatch.delenv('GPMPC_SYM_KERNEL', raising=False)
    _objective_solve('base')
    _objective_solve('base')
    assert len(solver._PROGRAMS) == 1 and len(captures) == 2
    if field == 'sym':
        monkeypatch.setenv('GPMPC_SYM_KERNEL', '1')
    res = _objective_solve(field)
    assert len(solver._PROGRAMS) == 2 and len(captures) == 4
    assert bool(torch.isfinite(res.cost).all())
    _same(res, _three_ways(lambda: _objective_solve(field)))


def _storages(ts):
    return {t.untyped_storage().data_ptr() for t in ts if t is not None}


def test_no_result_aliases_a_program_buffer(captures):
    """A result shares no storage with its program's buffers, and stays as
    it was when a later call on the same program overwrites them."""
    p = _problem()

    def solve(x0s):
        return batch.solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb,
                                 p.ub, CFG)

    res = solve(p.x0s)
    first = [t.clone() for t in res]
    (prog,) = solver._PROGRAMS.values()
    buffers = _storages((*prog.inputs, prog.u0, prog.p.lb, prog.p.ub,
                         *prog.state))
    assert not _storages(res) & buffers
    solve(p.x0s.flip(0))
    for a, b in zip(first, res):
        assert torch.equal(_bits(a), _bits(b))


def test_lru_eviction_and_clear_programs(captures, monkeypatch):
    """While the cache holds more than MAX_PROGRAM_BYTES the least recently
    used programs go, each evicted program's graphs reset, the newest
    always stays; clear_programs() resets and drops them all; an evicted
    key is captured again."""
    probs = {b: _problem(b=b) for b in (2, 3, 4)}

    def solve(b):
        q = probs[b]
        return batch.solve_batch(q.gp, 2, 1, q.x0s, q.params, q.horizon,
                                 q.lb, q.ub, CFG)

    def lanes():
        return [k[2][0] for k in solver._PROGRAMS]           # u0's rows: B

    size = {}
    for b in (2, 3, 4):
        solve(b)
        size[b] = solver._PROGRAMS[next(reversed(solver._PROGRAMS))].bytes
    assert size[2] < size[3] < size[4]
    assert solver.program_stats()['bytes'] == sum(size.values())
    solver.clear_programs()
    captures.clear()
    monkeypatch.setattr(solver, 'MAX_PROGRAM_BYTES', size[2] + size[4])
    solve(2)
    solve(3)
    first = next(iter(solver._PROGRAMS.values()))
    solve(2)                                  # a hit: 2 is now the newest
    assert len(captures) == 4 and lanes() == [3, 2]
    solve(4)                                  # over the bound: 3 goes
    assert lanes() == [2, 4] and len(captures) == 6
    assert all(g.resets == 0 for g in first.graphs)
    solve(3)                                  # captured again: 2, then 4 go
    assert lanes() == [3] and len(captures) == 8
    assert all(g.resets == 1 for g in first.graphs)
    (kept,) = solver._PROGRAMS.values()
    assert solver.program_stats() == dict(programs=1, bytes=kept.bytes,
                                          pool_bytes=0)
    graphs = list(kept.graphs)
    solver.clear_programs()
    assert not solver._PROGRAMS and solver.program_stats()['programs'] == 0
    assert len(graphs) == 2 and all(g.resets == 1 for g in graphs)


def test_eager_swap_bypasses_the_cache(captures):
    """With _run_graphed replaced by _run_eager (chip_smoke's eager_loop,
    compare_solves' 'eager' mode) a solve captures nothing and leaves the
    cache as it was."""
    p = _problem()
    graphed = solver._run_graphed
    solver._run_graphed = solver._run_eager
    try:
        eager = batch.solve_batch(p.gp, 2, 1, p.x0s, p.params, p.horizon,
                                  p.lb, p.ub, CFG)
    finally:
        solver._run_graphed = graphed
    assert not solver._PROGRAMS and not captures
    _same(eager, batch.solve_batch(p.gp, 2, 1, p.x0s, p.params, p.horizon,
                                   p.lb, p.ub, CFG))


def test_recipe_keys_captured_once(captures):
    """solve_batch_staged and solve_batch_multistart_retired twice each:
    every key is captured once (a step and an init graph a program, none on
    the second call; chunks of one width share a program), and the second
    call equals the first, a fresh solve and the eager loop to the bit."""
    p = _problem(b=8)
    args = (p.gp, 2, 1, p.x0s, p.params, p.horizon, p.lb, p.ub)

    def staged():
        return batch.solve_batch_staged(*args, CFG, budget1=2,
                                        budget_total=10, tail_divisor=4)

    def retired():
        return batch.solve_batch_multistart_retired(
            *args, SolverConfig(max_iters=10, tol=1e-6), n_starts=3,
            prune_to=2, frozen_rounds=2, budget1=3, tail_divisor=4,
            shift_set=(1, -1), shift_iters=3, shift_smooth_iters=2,
            neighbor_set=2, polish_lanes=2, polish_iters=2)

    for solve in (staged, retired):
        solver.clear_programs()
        captures.clear()
        first = solve()
        n = len(captures)
        assert n == 2 * len(solver._PROGRAMS)
        second = solve()
        assert len(captures) == n
        _same(first, second)
        _three_ways(solve)


def _controllers():
    args = dict(gamma=0.3, horizon=4, state_dim=2, input_dim=1,
                Q=np.diag([2.0, 1.0]), R=0.1 * np.eye(1),
                R_delta=0.05 * np.eye(1), capacity=32, delta_dynamics=True)
    cfg = dict(max_iters=30, tol=1e-4)
    j = JMPC(dtype=jnp.float64, solver=JConfig(**cfg), **args)
    t = TMPC(dtype=F64, solver=SolverConfig(**cfg), device='cpu', **args)
    x, ns = gp_data(n=20)
    for mpc in (j, t):
        mpc.set_ub([1.5])
        mpc.set_lb([-1.5])
        mpc.set_gp_hyperparams(lambdas=[2.0, 2.0, 2.0], sigma_f=1.0,
                               sigma_n=1e-2)
        mpc.dynamics.append_train_data(x[:, :2], x[:, 2], ns)
    return j, t


def test_controller_steps_on_one_program_match_jax(captures):
    """Three consecutive control steps of route (b) with an append between
    them, on one kept program (captured at the first step, hit at the
    others): actions, costs and iterations equal JAX's controller at f64
    within tests/test_torch_controller.py's tolerances."""
    rtol, atol = 1e-6, 1e-7
    j, t = _controllers()
    x0 = np.array([0.4, -0.2])
    for step in range(3):
        uj = j.get_optimal_trajectory(x0)
        ut = t.get_optimal_trajectory(x0)
        np.testing.assert_allclose(ut, uj, rtol=rtol, atol=atol,
                                   err_msg=f'step {step}')
        assert int(t.last_result.iters) == int(j.last_result.iters)
        np.testing.assert_allclose(float(t.last_result.cost),
                                   float(j.last_result.cost), rtol=rtol)
        assert len(solver._PROGRAMS) == 1 and len(captures) == 2
        nxt = x0 + 0.1 * np.array([x0[1], uj[0, 0]])
        for mpc in (j, t):
            mpc.dynamics.append_train_data(x0, uj[0], nxt)
        x0 = nxt
    assert int(t.gp.count) == 23


# ------------------------------------------------ the per-scenario routes --
ADAM = SolverConfig(method='adam', max_iters=12, tol=1e-3,
                    learning_rate=0.05, polish_iters=3)


def _gp_draws(b):
    """b GP draws of the small headline problem (seeds 0..b-1), stacked."""
    return batch.stack_gps([make_headline_problem(
        b=1, seed=s, n_train=24, capacity=32, horizon=3, dtype=F64,
        device='cpu').gp for s in range(b)])


ROUTES = ('vmap', 'adam', 'gp_draws', 'vmap_full_cov')


def _route_solve(route, p, x0s, gps=None):
    if route == 'gp_draws':
        return batch.solve_batch_gp(gps, 2, 1, x0s, p.params, p.horizon,
                                    p.lb, p.ub, CFG)
    return batch.solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb,
                             p.ub, ADAM if route == 'adam' else CFG,
                             full_cov=route == 'vmap_full_cov', impl='vmap')


@pytest.mark.parametrize('route', ROUTES)
def test_lanes_route_program_reused(captures, route):
    """The per-scenario routes, one lockstep solve of all lanes on
    lanes_objective (impl='vmap' by L-BFGS, with a diagonal and a full
    covariance, projected Adam, solve_batch_gp over GP draws), over three
    calls with other x0s: one program, captured once (a step and an init
    graph, and Adam's polish step), hit by the later calls; each call equals a
    fresh capture and the eager loop to the bit."""
    p = _problem()
    gps = _gp_draws(4) if route == 'gp_draws' else None
    rng = np.random.default_rng(5)
    graphs = 3 if route == 'adam' else 2
    for call in range(3):
        x0s = p.x0s if call == 0 else torch.tensor(rng.uniform(-1, 1, (4, 2)))
        n0 = len(captures)
        res = _route_solve(route, p, x0s, gps)
        assert len(captures) == n0 + (graphs if call == 0 else 0), call
        assert bool(torch.isfinite(res.cost).all())
        _same(res, _three_ways(lambda: _route_solve(route, p, x0s, gps)))
    (prog,) = solver._PROGRAMS.values()
    assert len(prog.graphs) == graphs
    assert (res.converged is None) == (route == 'adam')


def _lanes_solve(field, gps, p):
    """A solve through lanes_objective with one key field changed from the
    base ('base' changes none; 'lane_cache' takes one GP a lane in place of
    the shared one)."""
    cache = build_rollout_cache(gps if field == 'lane_cache' else p.gp, 2, 1)
    params = p.params
    if field == 'R_delta':
        params = params._replace(R_delta=0.1 * torch.eye(1, dtype=F64))
    obj = batch.lanes_objective(
        cache, p.x0s, params, delta=field == 'delta',
        full_cov=field == 'full_cov')
    u0 = p.x0s.new_zeros((4, p.horizon, 1))
    return solver.solve_trajectory_batched(obj, u0, p.lb, p.ub,
                                           ADAM if field == 'adam' else CFG)


LANES_KEY_FIELDS = ('full_cov', 'delta', 'lane_cache', 'R_delta', 'adam')


@pytest.mark.parametrize('field', LANES_KEY_FIELDS)
def test_lanes_objective_key_makes_a_program(captures, field):
    """lanes_objective's key is complete: the base solve twice is one
    program; a change of one of its fields (full_cov, delta, R_delta set),
    of the cache's kind (one GP a lane, told apart by its inputs' shapes)
    or of the method makes a second program whose result equals a fresh
    solve and the eager loop to the bit."""
    p, gps = _problem(), _gp_draws(4)
    _lanes_solve('base', gps, p)
    _lanes_solve('base', gps, p)
    assert len(solver._PROGRAMS) == 1 and len(captures) == 2
    res = _lanes_solve(field, gps, p)
    assert len(solver._PROGRAMS) == 2
    assert bool(torch.isfinite(res.cost).all())
    _same(res, _three_ways(lambda: _lanes_solve(field, gps, p)))


@pytest.mark.parametrize('field', ['full_cov', 'delta'])
def test_lanes_key_without_a_field_replays_a_stale_program(captures, field):
    """The check above has teeth: a copy of lanes_objective whose key drops
    full_cov (or delta) replays the base program for a call that changes
    it, and its result differs from the fresh solve. (A cache of one GP a
    lane needs no key field: it has a rank more in every input, so the
    inputs' shapes in the key tell the two apart.)"""
    p, gps = _problem(), _gp_draws(4)
    orig = batch.lanes_objective

    def dropped(*args, **kw):
        obj = orig(*args, **kw)
        key = tuple(v for i, v in enumerate(obj.key)
                    if i != {'delta': 2, 'full_cov': 3}[field])
        return obj._replace(key=key)

    _lanes_solve('base', gps, p)
    batch.lanes_objective = dropped
    try:
        _lanes_solve('base', gps, p)
        stale = _lanes_solve(field, gps, p)
    finally:
        batch.lanes_objective = orig
    assert len(solver._PROGRAMS) == 2
    solver.clear_programs()
    fresh = _lanes_solve(field, gps, p)
    assert not torch.equal(_bits(stale.u), _bits(fresh.u))


@pytest.mark.parametrize('case', ['adam', 'nominal'])
def test_route_c_steps_on_one_program(captures, case):
    """Three control steps of the controller's route (c) (Adam, or L-BFGS
    on a GP with the pendulum's nominal model) with an append between
    them: one program, captured at the first step and replayed at the
    others, each step equal to the eager loop to the bit."""
    from gpmpc_tpu_torch.models import pendulum
    cfg = ADAM if case == 'adam' else CFG
    x, ns = gp_data(n=20)

    def controller():
        mpc = TMPC(gamma=0.3, horizon=3, state_dim=2, input_dim=1,
                   Q=np.diag([2.0, 1.0]), R=0.1 * np.eye(1),
                   R_delta=0.05 * np.eye(1), capacity=32, dtype=F64,
                   solver=cfg, device='cpu')
        if case == 'nominal':
            mpc.gp = gp_state.make_gp(gp_state.GPConfig(
                capacity=32, x_dim=3, out_dim=2,
                nominal_fn=pendulum.nominal_residual_fn), dtype=F64,
                device='cpu')
        mpc.set_ub([1.5])
        mpc.set_lb([-1.5])
        mpc.dynamics.append_train_data(x[:, :2], x[:, 2], ns)
        return mpc

    kept, eager = controller(), controller()
    x0 = np.array([0.4, -0.2])
    graphed = solver._run_graphed
    for step in range(3):
        u = kept.get_optimal_trajectory(x0)
        solver._run_graphed = solver._run_eager
        try:
            ue = eager.get_optimal_trajectory(x0)
        finally:
            solver._run_graphed = graphed
        np.testing.assert_array_equal(u, ue, err_msg=f'step {step}')
        _same(kept.last_result, eager.last_result)
        assert len(solver._PROGRAMS) == 1
        assert len(captures) == (3 if case == 'adam' else 2)
        nxt = x0 + 0.1 * np.array([x0[1], u[0, 0]])
        for mpc in (kept, eager):
            mpc.dynamics.append_train_data(x0, u[0], nxt)
        x0 = nxt
