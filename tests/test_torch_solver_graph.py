"""The lockstep L-BFGS as one iteration function (gpmpc_tpu_torch/mpc/
solver.py): the eager loop over `_lbfgs_step` against gpmpc_tpu's
solve_trajectory_batched at f64 in every mode of the step; a state with
every lane done is a fixed point of the step; the in-place form that a CUDA
graph records equals the rebinding form to the bit; the graphed loop's
control flow and counts (with a stand-in for the graph, on the CPU); and
which callers ask for a captured loop."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.mpc.solver import solve_trajectory_batched as jsolve
from gpmpc_tpu_torch.gp import state as gp_state
from gpmpc_tpu_torch.mpc import controller, solver
from gpmpc_tpu_torch.mpc.solver import (LbfgsState, SolverConfig,
                                        solve_trajectory_batched)
from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
from gpmpc_tpu_torch.parallel import batch, model_sharded
from gpmpc_tpu_torch.problems import make_headline_problem
from gpmpc_tpu_torch.utils import replay_counts
from torch_port_common import (REPLAYING, assert_same_solve, jit_solve,
                               use_stand_in_graphs)

torch.set_num_threads(2)

B, H, DA = 5, 6, 2
TARGETS = np.random.default_rng(3).uniform(-1.5, 1.5, (B, H, DA))
TARGETS[0, 0, 0] = 1.0
U_TRAP = 0.3


def _objective(xp, trap=False):
    """Per-lane smooth nonconvex objectives (B, H, DA) -> (B,) in either
    package (xp: jnp or torch): a quadratic bowl off the box's centre with
    a ripple. With `trap`, lane 0 is NaN wherever u[0, 0] leaves U_TRAP, its
    start, where its gradient is not 0: every step is rejected until the
    step size underflows, twice into the restart branch and then into the
    stop."""
    if xp is jnp:
        tg, ripple = jnp.asarray(TARGETS), (lambda u: u[..., ::-1])
    else:
        tg = torch.tensor(TARGETS, dtype=torch.float64)
        ripple = (lambda u: u.flip(-1))

    def f(u):
        v = ((u - tg) ** 2 + 0.3 * xp.sin(3.0 * u) * ripple(u)).sum((1, 2))
        if not trap:
            return v
        off = (xp.abs(u[:, 0, 0] - U_TRAP) > 1e-13) & (xp.arange(B) == 0)
        return xp.where(off, xp.nan, v)
    return f


def _u0(trap=False):
    u0 = np.zeros((B, H, DA))
    if trap:
        u0[0] = U_TRAP
    return u0


MODES = {
    'monotone': dict(),
    'nonmonotone': dict(nonmonotone=3),
    'noise': dict(noise_rel=3e-4, progress_window=5),
    'noise_nonmonotone': dict(noise_rel=3e-4, progress_window=5,
                              nonmonotone=3),
}


@pytest.mark.parametrize('mode', list(MODES) + ['restart'])
def test_eager_loop_matches_jax_f64(mode):
    """(a) The loop over `_lbfgs_step` against JAX's lockstep solver at f64:
    u and cost at rtol 1e-8, iters and converged equal, in each mode of the
    step; 'restart' traps lane 0 (_objective), which takes both restarts
    and then stops, ~3 x 34 halvings of its step later."""
    trap = mode == 'restart'
    cfg = dict(max_iters=120 if trap else 60, tol=1e-6,
               **MODES.get(mode, {}))
    jres = jit_solve(lambda u0: jsolve(_objective(jnp, trap), u0, -1.0, 1.0,
                                       JSolverConfig(**cfg)),
                     jnp.asarray(_u0(trap)))
    tres = solve_trajectory_batched(_objective(torch, trap),
                                    torch.tensor(_u0(trap)), -1.0, 1.0,
                                    SolverConfig(**cfg))
    assert_same_solve(tres, jres)
    p, s = _init(SolverConfig(**cfg), trap)
    s = solver._run_eager(p, torch.tensor(_u0(trap)).reshape(B, -1))
    if trap:
        assert int(s.resets[0]) == 2 and bool(s.done[0])
        assert int(s.resets[1:].max()) == 0


def _init(cfg, trap=False):
    """(problem, initial state) of the solver on _objective."""
    obj = _objective(torch, trap)
    u = torch.tensor(_u0(trap))
    shape = u.shape
    n = u[0].numel()
    lb, ub = (torch.full((B, n), v, dtype=torch.float64) for v in (-1.0, 1.0))
    p = solver._Problem(
        val_and_grad=lambda x: solver._value_and_grad(obj, x, shape),
        lb=lb, ub=ub, zero=torch.zeros((), dtype=torch.float64), config=cfg)
    return p, solver._lbfgs_init(p, u.reshape(B, n))


def _same_bits(a: LbfgsState, b: LbfgsState):
    for name, x, y in zip(LbfgsState._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.is_floating_point():
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y), name


@pytest.mark.parametrize('mode', list(MODES))
def test_step_on_done_state_is_a_fixed_point(mode):
    """(b) `_lbfgs_step` on a state with every lane done returns every
    field bit for bit unchanged, t included."""
    p, s = _init(SolverConfig(max_iters=7, tol=1e-9, **MODES[mode]))
    for _ in range(7):
        s = solver._lbfgs_step(p, s)
    s = s._replace(done=torch.ones_like(s.done))
    _same_bits(solver._lbfgs_step(p, s), s)


@pytest.mark.parametrize('mode', list(MODES))
def test_in_place_step_equals_rebinding(mode):
    """(c) The static-buffer form, `_step_in_place` on distinct buffers
    (the code a CUDA graph records, on a program's static state), equals
    `s = _lbfgs_step(p, s)` bit for bit at every iteration."""
    p, s = _init(SolverConfig(max_iters=40, tol=1e-9, **MODES[mode]))
    s = solver._lbfgs_step(p, s)
    static = LbfgsState(*(x.clone() for x in s))
    for _ in range(25):
        s = solver._lbfgs_step(p, s)
        solver._step_in_place(p, static)
        _same_bits(static, s)


@pytest.mark.parametrize('max_iters', [0, 1, 2, 40])
@pytest.mark.parametrize('mode', ['monotone', 'noise'])
def test_graphed_loop_control_flow(monkeypatch, mode, max_iters):
    """_run_graphed on a closure (a program for one call) with stand-ins
    for the graphs (the CPU has none): the same state as the eager loop,
    bit for bit, and a counter that the objective bumps in Python counts
    the init's value-and-grad and one an iteration, as the eager loop's,
    though the step's Python runs once after iteration 1 (at capture) and
    the replays add the rest."""
    calls = {'vg': 0}
    cfg = SolverConfig(max_iters=max_iters, tol=1e-9, **MODES[mode])
    obj = _objective(torch)

    def counted(u):
        if not REPLAYING[0]:
            calls['vg'] += 1
        return obj(u)

    def run(loop):
        calls['vg'] = 0
        p, _ = _init(cfg)
        p = p._replace(val_and_grad=lambda x: solver._value_and_grad(
            counted, x, (B, H, DA)))
        with replay_counts.registered(lambda: dict(calls), _add(calls)):
            s = loop(p, torch.tensor(_u0()).reshape(B, -1))
        return s, calls['vg']

    use_stand_in_graphs(monkeypatch)
    s_e, n_e = run(solver._run_eager)
    s_g, n_g = run(solver._run_graphed)
    _same_bits(s_g, s_e)
    assert n_g == n_e == 1 + int(s_e.t)
    assert int(s_e.t) == max_iters or bool(s_e.done.all())


def _add(counts):
    def add(delta):
        for k, n in delta.items():
            counts[k] += n
    return add


# Kernel names as a CUDA graph's nodes give them (cuFuncGetName: mangled,
# the first as nvcc mangles K1's f64 scalar body on an H100, the others as
# g++ mangles the same templates), and demangled, with the counters each
# launch counts in.
_NAMES = {
    '_ZN59_GLOBAL__N__664151d1_26_variance_trace_tied_f64_cu_8664714c14rw_'
    'tied_kernelIdLi3ELi2ELNS_7VariantE0ELi2ELi32ELi64ELi4ELb0ELb1EEEvPKT_'
    'S4_S4_S4_S4_PS2_iiiiiii': ('LAUNCHES', 'LAUNCHES_F64'),
    '_ZN12_GLOBAL__N_114rw_tied_kernelIdLi3ELi2ELNS_7VariantE0ELi4ELi32ELi64'
    'ELi4ELb0ELb1EEEvPKT_S4_S4_S4_S4_PS2_iiiiiii':
        ('LAUNCHES', 'LAUNCHES_F64'),
    '_ZN12_GLOBAL__N_114rw_tied_kernelIfLi3ELi2ELNS_7VariantE0ELi4ELi32ELi64'
    'ELi4ELb0ELb1EEEvPKT_S4_S4_S4_S4_PS2_iiiiiii': ('LAUNCHES',),
    '_ZN12_GLOBAL__N_114rw_tied_kernelIdLi3ELi2ELNS_7VariantE0ELi4ELi32ELi64'
    'ELi4ELb1ELb0EEEvPKT_S4_S4_S4_S4_PS2_iiiiiii': ('LAUNCHES_UNTIED',),
    '_ZN12_GLOBAL__N_118rw_tied_mma_kernelILi2ELi1ELi4ENS_5K1CfgILi8EEEEEvPKd'
    'S4_S4_S4_S4_Pdi': ('LAUNCHES', 'LAUNCHES_F64'),
    '_ZN12_GLOBAL__N_118rw_sym_pair_kernelIdLi3ELi2ELb1EEEvPKT_S3_S3_PS1_PKi'
    'S6_iii': ('LAUNCHES_SYM',),
    '_ZN12_GLOBAL__N_117rw_sym_sum_kernelIfLi3EEEvPKT_S3_PS1_iiib': (),
    'void (anonymous namespace)::rw_tied_kernel<double, 3, 2, ((anonymous '
    'namespace)::Variant)0, 4, 32, 64, 4, true, false>(double const*, '
    'double const*, double const*, double const*, double const*, double*, '
    'int, int, int, int, int, int, int)': ('LAUNCHES_UNTIED',),
    'void (anonymous namespace)::rw_tied_kernel<float, 3, 2, ((anonymous '
    'namespace)::Variant)0, 4, 32, 64, 4, false, true>(float const*, '
    'float const*, float const*, float const*, float const*, float*, int, '
    'int, int, int, int, int, int)': ('LAUNCHES',),
    'void at::native::vectorized_elementwise_kernel<4, '
    'at::native::FillFunctor<double>, std::array<char*, 1ul> >(int, '
    'at::native::FillFunctor<double>, std::array<char*, 1ul>)': (),
}


@pytest.mark.parametrize('name', list(_NAMES))
def test_graph_counters_sort_kernel_names(name):
    """A graph's kernel node counts in the counters of the kernel it runs:
    K1's tied body (f32, f64 and the f64 tensor-core body), K2 (the same
    template, Untied), K4's pair kernel; no other kernel counts."""
    assert vt.graph_counters(name) == _NAMES[name]


_K1_F64 = next(n for n, k in _NAMES.items() if 'rw_tied_mma' in n)
_TORCH = next(n for n, k in _NAMES.items() if 'at::native' in n)


def test_replay_counts_count_each_replay():
    """The kernel counters of variance_trace are registered: a capture's
    launches are taken back (it ran nothing), and each replay adds the
    graph's kernel nodes, which must be what the wrappers counted."""
    before = replay_counts.snapshot()
    l0, f0 = vt.LAUNCHES, vt.LAUNCHES_F64
    vt.LAUNCHES += 20
    vt.LAUNCHES_F64 += 20
    counts = replay_counts.Replays(before, replay_counts.snapshot(),
                                   [_K1_F64] * 20 + [_TORCH] * 7)
    assert (vt.LAUNCHES, vt.LAUNCHES_F64) == (l0, f0)
    for _ in range(4):
        counts.replayed()
    assert (vt.LAUNCHES, vt.LAUNCHES_F64) == (l0 + 80, f0 + 80)


@pytest.mark.parametrize('nodes', [19, 21, 0])
def test_replay_counts_graph_must_hold_the_launches(nodes):
    """A graph whose kernel nodes are not the launches the wrappers counted
    during its capture (a launch that left no node, a node no wrapper
    counted) raises."""
    before = replay_counts.snapshot()
    vt.LAUNCHES += 20
    vt.LAUNCHES_F64 += 20
    try:
        with pytest.raises(RuntimeError, match='captured graph holds'):
            replay_counts.Replays(before, replay_counts.snapshot(),
                                  [_K1_F64] * nodes)
    finally:
        vt.LAUNCHES -= 20
        vt.LAUNCHES_F64 -= 20


def test_replay_counts_tally_repeats_the_capture():
    """A tally of Python calls (no kernel names) repeats, each replay, what
    it counted during the capture; a counter registered during a capture
    raises."""
    calls = {'rollouts': 0}
    with replay_counts.registered(lambda: dict(calls), _add(calls)):
        before = replay_counts.snapshot()
        calls['rollouts'] += 3
        counts = replay_counts.Replays(before, replay_counts.snapshot(), [])
        assert calls['rollouts'] == 0
        counts.replayed()
        counts.replayed()
        assert calls['rollouts'] == 6
        with pytest.raises(RuntimeError):
            with replay_counts.registered(lambda: {}, lambda d: None):
                replay_counts.Replays(before, replay_counts.snapshot(), [])


@contextlib.contextmanager
def _spy(module):
    """(asks for a captured loop, objective kind, method, lanes) of each
    solve_trajectory_batched call made through `module`: the kind is an
    Objective's key[0] ('batch_objective', 'lanes_objective'), else
    None."""
    seen = []
    orig = module.solve_trajectory_batched

    def spy(objective_b, u_init, lb, ub, config=SolverConfig(),
            val_and_grad=None, _graph=True):
        # solve_trajectory_batched's rule, CUDA aside: graphed unless
        # _graph=False or an external val_and_grad.
        kind = (objective_b.key[0]
                if isinstance(objective_b, solver.Objective) else None)
        seen.append((_graph and val_and_grad is None, kind, config.method,
                     u_init.shape[0]))
        return orig(objective_b, u_init, lb, ub, config, val_and_grad,
                    _graph=_graph)

    module.solve_trajectory_batched = spy
    try:
        yield seen
    finally:
        module.solve_trajectory_batched = orig


@pytest.mark.parametrize('case', ['diag', 'full_cov', 'vmap', 'adam',
                                  'staged', 'multistart', 'gp_draws'])
def test_route_rule_batch(case):
    """(d) Who asks for a captured loop: solve_batch with a diagonal or a
    full covariance (its PSD clip runs the sync-free eigensolver), the
    multistart recipes and solve_batch_staged do, through the lockstep
    L-BFGS on batch_objective; impl='vmap', Adam ('auto' -> 'vmap') and
    solve_batch_gp do too, as one lockstep solve of all B lanes of their
    method on lanes_objective, and none of them calls a per-lane solve
    (solve_trajectory's solve_trajectory_batched at B = 1)."""
    p = make_headline_problem(b=2, n_train=24, capacity=32, horizon=3,
                              dtype=torch.float64, device='cpu')
    args = (p.gp, 2, 1, p.x0s, p.params, p.horizon, p.lb, p.ub)
    cfg = SolverConfig(max_iters=2)
    with _spy(batch) as calls, _spy(solver) as single:
        if case in ('diag', 'full_cov'):
            batch.solve_batch(*args, cfg, full_cov=case == 'full_cov')
        elif case == 'vmap':
            batch.solve_batch(*args, cfg, impl='vmap')
        elif case == 'adam':
            batch.solve_batch(*args, cfg.replace(method='adam'))
        elif case == 'gp_draws':
            batch.solve_batch_gp(batch.stack_gps([p.gp, p.gp]), *args[1:],
                                 cfg)
        elif case == 'staged':
            batch.solve_batch_staged(*args, cfg, budget1=1, budget_total=2)
        else:
            batch.solve_batch_multistart(*args, cfg, n_starts=2,
                                         frozen_rounds=1, shift_set=(1,),
                                         shift_iters=1)
    if case in ('vmap', 'adam', 'gp_draws'):
        method = 'adam' if case == 'adam' else 'lbfgs'
        assert calls == [(True, 'lanes_objective', method, 2)]
    else:
        assert calls and all(c[0] and c[1] != 'lanes_objective'
                             and c[2] == 'lbfgs' for c in calls)
    assert single == []


@pytest.mark.parametrize('full_cov', [False, True])
def test_route_rule_controller(full_cov):
    """(d) The controller's route (b) asks for capture with a diagonal
    covariance and with full_cov=True."""
    mpc = controller.RiskSensitiveMPC(
        gamma=0.3, horizon=3, state_dim=2, input_dim=1, Q=np.eye(2),
        R=0.1 * np.eye(1), capacity=32, dtype=torch.float64,
        solver=SolverConfig(max_iters=2), full_cov=full_cov, device='cpu')
    rng = np.random.default_rng(0)
    mpc.dynamics.append_train_data(rng.uniform(-1, 1, (20, 2)),
                                   rng.uniform(-1, 1, (20, 1)),
                                   rng.uniform(-1, 1, (20, 2)))
    with _spy(controller) as seen:
        mpc.get_optimal_trajectory(np.array([0.1, -0.2]))
    assert seen == [(True, 'batch_objective', 'lbfgs', 1)]


@pytest.mark.parametrize('case', ['adam', 'nominal'])
def test_route_rule_controller_route_c(case):
    """(d) The controller's route (c), Adam or a nominal model: one lockstep
    solve of one lane on lanes_objective that asks for capture, and no
    eager per-lane solve (solve_trajectory)."""
    from gpmpc_tpu_torch.models import pendulum
    cfg = SolverConfig(max_iters=2, method='adam' if case == 'adam'
                       else 'lbfgs')
    mpc = controller.RiskSensitiveMPC(
        gamma=0.3, horizon=3, state_dim=2, input_dim=1, Q=np.eye(2),
        R=0.1 * np.eye(1), capacity=32, dtype=torch.float64, solver=cfg,
        device='cpu')
    if case == 'nominal':
        mpc.gp = gp_state.make_gp(dataclasses.replace(
            mpc.gp.config, nominal_fn=pendulum.nominal_residual_fn),
            dtype=torch.float64, device='cpu')
    rng = np.random.default_rng(0)
    mpc.dynamics.append_train_data(rng.uniform(-1, 1, (20, 2)),
                                   rng.uniform(-1, 1, (20, 1)),
                                   rng.uniform(-1, 1, (20, 2)))
    with _spy(controller) as lanes, _spy(solver) as per_lane:
        mpc.get_optimal_trajectory(np.array([0.1, -0.2]))
    assert per_lane == []
    assert lanes == [(True, 'lanes_objective', cfg.method, 1)]


def test_route_rule_external_val_and_grad():
    """(d) The model-sharded solve (solve_batch_2d on a (1, 1) gloo mesh in
    this process) hands the solver an external value-and-grad, with its
    collectives inside, and does not ask for capture."""
    import torch.distributed as dist
    from gpmpc_tpu_torch.parallel.distributed import free_port, initialize
    from gpmpc_tpu_torch.parallel.mesh import make_mesh
    p = make_headline_problem(b=2, n_train=24, capacity=32, horizon=3,
                              dtype=torch.float64, device='cpu')
    initialize(f'tcp://localhost:{free_port()}', world_size=1, rank=0,
               device='cpu', timeout_s=60.0)
    try:
        with _spy(model_sharded) as seen:
            model_sharded.solve_batch_2d(
                make_mesh(1, 1, device='cpu'), p.gp, 2, 1, p.x0s, p.params,
                p.horizon, p.lb, p.ub, SolverConfig(max_iters=2))
    finally:
        dist.destroy_process_group()
    assert seen == [(False, None, 'lbfgs', 2)]
