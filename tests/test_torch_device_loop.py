"""The solver's loop on the device (gpmpc_tpu_torch/ops/kernels/loop_cond.py,
mpc/solver.py's kept programs), on the CPU: what makes the device loop
equal to the host-read loop. Its WHILE node runs the step until the
condition t < max_iters and a lane live fails, read on the device; the
host-read loop reads all(done) on the host once an iteration. The two stop
at the same state because (1) a state whose lanes are all done is a fixed
point of every method's step, so a pass run past the end changes no bit,
and (2) the condition's plain version equals the host loop's `_go_on`. The
card tests (tests/test_torch_cuda.py) hold the device loop itself to the
host-read loop on every route."""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.mpc import solver
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.ops.kernels import loop_cond
from gpmpc_tpu_torch.utils import replay_counts

torch.set_num_threads(2)

B, H, DA = 4, 5, 2
TARGETS = np.random.default_rng(16).uniform(-1.5, 1.5, (B, H, DA))


def _objective(u):
    """Per-lane smooth objectives (B, H, DA) -> (B,): a bowl off the box's
    centre with a ripple."""
    tg = torch.tensor(TARGETS, dtype=torch.float64)
    return ((u - tg) ** 2 + 0.3 * torch.sin(3.0 * u) * u.flip(-1)).sum((1, 2))


def _problem(cfg):
    n = H * DA
    lb, ub = (torch.full((B, n), v, dtype=torch.float64) for v in (-1.0, 1.0))
    return solver._Problem(
        val_and_grad=lambda x: solver._value_and_grad(_objective, x,
                                                      (B, H, DA)),
        lb=lb, ub=ub, zero=torch.zeros((), dtype=torch.float64), config=cfg,
        method=cfg.method)


def _u0():
    return torch.tensor(np.random.default_rng(5).uniform(-1, 1, (B, H * DA)))


def _same_bits(a, b):
    for name, x, y in zip(type(a)._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if x.is_floating_point():
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y), name


CONFIGS = {
    'monotone': dict(max_iters=200, tol=1e-6),
    'nonmonotone': dict(max_iters=200, tol=1e-6, nonmonotone=3),
    'noise': dict(max_iters=200, tol=1e-6, noise_rel=3e-4,
                  progress_window=5),
    'adam_polish': dict(method='adam', max_iters=600, tol=2e-2,
                        learning_rate=0.05, polish_iters=3),
}


def _host_loop(p):
    """The host-read loop from the init: (state, iterations run)."""
    m = solver._METHODS[p.method]
    s, t = m.init(p, _u0()), 0
    while solver._go_on(s, t, p.config.max_iters):
        s = m.step(p, s)
        t += 1
    return s, t


def _device_loop(p):
    """The device loop's semantics on the CPU: the condition's plain
    version read after every pass (loop_cond.go_on, CPU tensors), the step
    run while it holds."""
    m = solver._METHODS[p.method]
    s = m.init(p, _u0())
    while bool(loop_cond.go_on(s.t, s.done, p.config.max_iters)):
        s = m.step(p, s)
    return s


@pytest.mark.parametrize('mode', list(CONFIGS))
def test_steps_after_the_host_loop_change_no_bit(mode):
    """After the host-read loop ends with every lane done, further steps
    (a device loop's passes past the end) leave every field of the state
    equal to the bit, t and the restart counters included (noise_rel > 0:
    f_best, u_best, no_prog too; Adam: its moments and step counts); s.t is
    the host loop's count; the polish then gives the same bits either
    way."""
    p = _problem(SolverConfig(**CONFIGS[mode]))
    s, t = _host_loop(p)
    assert bool(s.done.all()) and t < p.config.max_iters
    assert int(s.t) == t
    m = solver._METHODS[p.method]
    after = s
    for _ in range(3):
        after = m.step(p, after)
        _same_bits(after, s)
    if m.polish is not None:
        a, b = s, after
        for _ in range(p.config.polish_iters):
            a, b = m.polish(p, a), m.polish(p, b)
        _same_bits(a, b)


@pytest.mark.parametrize('mode', list(CONFIGS))
@pytest.mark.parametrize('cap', [1, 3, None])
def test_device_loop_semantics_equal_the_host_loop(mode, cap):
    """The loop driven by the condition's plain version (the device loop's
    rule) ends at the host loop's state to the bit, at the cap (1, 3
    iterations) and where every lane is done."""
    cfg = CONFIGS[mode] if cap is None else {**CONFIGS[mode], 'max_iters': cap}
    p = _problem(SolverConfig(**cfg))
    s_host, t = _host_loop(p)
    s_dev = _device_loop(p)
    _same_bits(s_dev, s_host)
    assert int(s_dev.t) == t == (cap if cap is not None else t)


def _go_on_cases():
    """(t, done, max_iters) of the condition: below, at and past the cap;
    no lane, every lane and a single lane live; one lane."""
    cases = []
    for b in (1, 5, 64):
        for kind in ('none done', 'all done', 'first live', 'last live',
                     'random'):
            done = torch.zeros(b, dtype=torch.bool)
            if kind == 'all done':
                done[:] = True
            elif kind == 'first live':
                done[1:] = True
            elif kind == 'last live':
                done[:-1] = True
            elif kind == 'random':
                done = torch.as_tensor(
                    np.random.default_rng(b).random(b) < 0.5)
            for t in (0, 1, 39, 40, 41):
                cases.append((t, done, 40))
    return cases


@pytest.mark.parametrize('case', range(len(_go_on_cases())))
def test_condition_plain_version_equals_go_on(case):
    """loop_cond.go_on_reference (the plain twin of the device loop's
    condition kernel) equals the host loop's `_go_on` at t below, at and
    past max_iters, with every lane done, none, and a single live lane;
    on CPU tensors go_on is the plain version."""
    t, done, cap = _go_on_cases()[case]
    tt = torch.tensor(t, dtype=torch.long)
    s = solver.LbfgsState(*([None] * 14), done=done, t=tt)
    want = solver._go_on(s, t, cap)
    assert bool(loop_cond.go_on_reference(tt, done, cap)) == want
    assert bool(loop_cond.go_on(tt, done, cap)) == want


def test_condition_after_init_and_at_the_cap():
    """A state whose lanes are all done after its init makes the condition
    false at t = 0 (a loop of 0 passes); t = max_iters makes it false with
    every lane live; one live lane keeps it true."""
    p = _problem(SolverConfig(max_iters=5, tol=1e-6))
    s = solver._lbfgs_init(p, _u0())
    assert bool(loop_cond.go_on(s.t, s.done, 5))
    assert not bool(loop_cond.go_on(s.t, torch.ones_like(s.done), 5))
    assert not bool(loop_cond.go_on(s.t + 5, s.done, 5))
    one = torch.ones_like(s.done)
    one[2] = False
    assert bool(loop_cond.go_on(s.t, one, 5))


def test_host_loop_counts_one_read_an_iteration():
    """The host-read loop reads all(done) once an iteration and once more
    to stop where every lane is done; at the cap it stops without a read
    (utils/replay_counts.HOST_READS)."""
    for cap, want in ((200, None), (3, 3)):
        p = _problem(SolverConfig(max_iters=cap, tol=1e-6))
        before = replay_counts.HOST_READS
        s, t = _host_loop(p)
        reads = replay_counts.HOST_READS - before
        assert reads == (t + 1 if want is None else want)


def test_watched_loops_settle_once():
    """A program that runs device loops is watched once, however many
    solves it runs: settle() asks it to count what ran since its last
    settle; snapshot(), replays_run() and unregister() settle first; a
    program that is gone is no longer watched. Replays.replayed(n) adds n
    replays in the counters still registered."""
    calls = {'rollouts': 0}

    def add(delta):
        for k, n in delta.items():
            calls[k] += n

    entry = replay_counts.register(lambda: dict(calls), add)
    before = replay_counts.snapshot()
    calls['rollouts'] += 2
    counts = replay_counts.Replays(before, replay_counts.snapshot(), [])
    assert calls['rollouts'] == 0

    class Loop:
        pending = 0

        def settle(self):
            counts.replayed(self.pending)
            self.pending = 0

    loop = Loop()
    for _ in range(3):
        replay_counts.watch(loop)
    assert list(replay_counts._LOOPS).count(loop) == 1
    loop.pending = 3
    replay_counts.settle()
    replay_counts.settle()
    assert calls['rollouts'] == 6
    loop.pending = 1
    replay_counts.snapshot()
    loop.pending = 1
    replay_counts.replays_run()
    assert calls['rollouts'] == 10
    loop.pending = 5
    replay_counts.unregister(entry)
    assert calls['rollouts'] == 20
    counts.replayed(0)
    assert replay_counts.replays_run()[counts] == 10
    del loop
    assert not [x for x in replay_counts._LOOPS if isinstance(x, Loop)]


def test_the_loop_is_chosen_by_version_and_kept_in_the_key(monkeypatch):
    """loop_form() follows loop_cond.supported(); a program on CUDA takes
    the device loop where it is 'while', the host-read loop inside
    _host_read_loop() (nested blocks restore it) and on the CPU; the loop is
    in the program's key, so the two kinds of program are kept apart."""
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    for ok, form in ((True, 'while'), (False, 'host')):
        monkeypatch.setattr(loop_cond, 'supported', lambda ok=ok: ok)
        assert solver.loop_form() == form
        assert solver._loop_of(cuda) == form
        assert solver._loop_of(cpu) == 'host'
    monkeypatch.setattr(loop_cond, 'supported', lambda: True)
    with solver._host_read_loop():
        with solver._host_read_loop():
            assert solver._loop_of(cuda) == 'host'
        assert solver._loop_of(cuda) == 'host'
    assert solver._loop_of(cuda) == 'while'
    p = _problem(SolverConfig(max_iters=5))._replace(
        program=(('k',), (), None))
    u0 = _u0().to('meta')
    key = solver._program_key(p, u0)
    with solver._host_read_loop():
        assert solver._program_key(p, u0) == key
    u0 = torch.empty((B, H * DA), dtype=torch.float64, device='meta')
    assert solver._program_key(p, u0)[-1] == 'host'


def _kept_objective():
    return solver.Objective(('device-loop test',),
                            (torch.tensor(TARGETS),),
                            lambda tg: lambda u: _objective(u))


@pytest.mark.parametrize('mode', ['monotone', 'adam_polish'])
def test_device_loop_program_counts_without_a_list(monkeypatch, mode):
    """A kept program on the device loop (stand-in graphs: a loop launch
    replays the step while the condition's plain version holds), called
    many times without a counter read: each call equals the eager solve to
    the bit; the program keeps one device sum of its passes and is watched
    once, nothing a call; settle() then counts every pass once in the
    step's counts, the condition kernel's launches once a launch and once
    a pass."""
    from torch_port_common import use_stand_in_graphs
    use_stand_in_graphs(monkeypatch)
    monkeypatch.setattr(solver, '_loop_of', lambda device: 'while')
    cfg = SolverConfig(**CONFIGS[mode])
    n = H * DA
    rng = np.random.default_rng(7)
    obj = _kept_objective()
    cond0 = loop_cond.LAUNCHES_COND
    iters, calls = [], 40
    try:
        for call in range(calls):
            u0 = torch.tensor(rng.uniform(-1, 1, (B, H, DA)))
            res = solver.solve_trajectory_batched(obj, u0, -1.0, 1.0, cfg)
            want = solver.solve_trajectory_batched(obj, u0, -1.0, 1.0, cfg,
                                                   _graph=False)
            for x, y in zip(res, want):
                if x is not None:
                    assert torch.equal(x, y)
            iters.append(int(res.iters.max()))
        progs = list(solver._PROGRAMS.values())
        assert len(progs) == 1
        prog = progs[0]
        assert list(replay_counts._LOOPS).count(prog) == 1
        # Nothing settled since the miss (Adam's polish capture settled it).
        assert prog.launched == calls - (mode == 'adam_polish')
        # Passes after iteration 1, which the miss runs eagerly.
        passes = sum(iters) - 1
        replay_counts.settle()
        assert prog.launched == 0 and int(prog.passes) == 0
        assert replay_counts.replays_run()[prog.step_counts] == passes
        assert loop_cond.LAUNCHES_COND - cond0 == calls + passes
    finally:
        solver.clear_programs()


def test_device_loop_refuses_cpu_tensors():
    """The loop graph and the kernel's plain launch take CUDA tensors only:
    on CPU tensors they raise (go_on takes the plain version there)."""
    t = torch.zeros((), dtype=torch.long)
    done = torch.zeros(3, dtype=torch.bool)
    with pytest.raises(ValueError):
        loop_cond.DeviceLoop(lambda: None, t, done, 5, None)
    with pytest.raises(ValueError):
        loop_cond.launch(t, done, 5, torch.zeros((), dtype=torch.int32))
