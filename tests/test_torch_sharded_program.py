"""The model-sharded solve (gpmpc_tpu_torch/parallel/model_sharded.py
solve_batch_2d) as a kept program (mpc/solver.py), on the CPU with the
stand-in CUDA graphs of torch_stand_in.py, gloo's collectives captured
(`capture_gloo`): the control flow of the NCCL program on the card.

In this process, on a (1, 1) gloo mesh: a first call keeps a program
(captures its step and init) and a later call on other x0s captures
nothing; both equal the eager solve to the bit and JAX's solve_batch
within tests/test_model_sharded.py's bars (u rtol 1e-6, cost rtol 1e-8);
the untied branch is kept too; a new process group never finds an old
group's program, and `destroy_group` releases the group's programs (and
only those); the capture rule (gloo and the CPU run eagerly). On a (1, 2)
mesh in two ranks of tests/torch_dist_worker.py: the same, both ranks equal
to the bit with equal step replays. B = 8, N = 48 in capacity 64, H = 5,
f64, as tests/test_torch_model_sharded.py.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gpmpc_tpu.gp import state as gs
from gpmpc_tpu.mpc.cost import CostParams as JCostParams
from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.parallel import batch as jbatch
from gpmpc_tpu_torch.convert import FIELDS
from gpmpc_tpu_torch.mpc import solver
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.parallel import batch
from gpmpc_tpu_torch.parallel.distributed import (destroy_group, free_port,
                                                  initialize, launch_ranks)
from gpmpc_tpu_torch.parallel.mesh import make_mesh
from gpmpc_tpu_torch.parallel.model_sharded import solve_batch_2d
from torch_port_common import np_, port_gp, t64
from torch_stand_in import capture_gloo, stand_in_capture, use_stand_in_graphs

torch.set_num_threads(2)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_dist_worker.py')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120
B, H, ITERS = 8, 5, 15
CFG = SolverConfig(max_iters=ITERS, tol=1e-6, history=4)
FIELDS_OUT = ('u', 'cost', 'iters', 'converged')


def _jgp(rng, tied, n=48, cap=64, e=2, d=3):
    """tests/test_model_sharded.py's GP, f64."""
    x = rng.uniform(-2, 2, (n, d))
    y = np.stack([np.sin(x[:, 0]) + 0.3 * x[:, 2], np.cos(x[:, 1])], axis=1)
    ll = np.log([1.5] * d) if tied else np.log(rng.uniform(1.0, 2.0, (e, d)))
    cfg = gs.GPConfig(capacity=cap, x_dim=d, out_dim=e)
    return gs.make_gp(cfg, x, y, log_lambdas=ll, log_sigma_f=np.log(0.8),
                      log_sigma_n=np.log(0.1), dtype=jnp.float64)


@pytest.fixture(scope='module')
def problem():
    """The tied and untied GPs, two batches of x0s, the cost leaves (a
    per-lane gamma) and JAX's solve_batch of the tied GP on the first."""
    rng = np.random.default_rng(7)
    jgp = _jgp(rng, True)
    untied = _jgp(rng, False)
    leaves = dict(Q=2.0 * np.eye(2), R=0.01 * np.eye(1),
                  gamma=np.linspace(-0.3, 0.3, B), x_ref=np.zeros(2),
                  u_ref=np.zeros(1))
    x0s = rng.uniform(-1, 1, (B, 2))
    x0s_2 = rng.uniform(-1, 1, (B, 2))
    ref = jbatch.solve_batch(
        jgp, 2, 1, jnp.asarray(x0s),
        JCostParams(**{k: jnp.asarray(v) for k, v in leaves.items()}), H,
        -1.0, 1.0, JSolverConfig(max_iters=ITERS, tol=1e-6, history=4))
    return dict(jgp=jgp, gp=port_gp(jgp), untied=port_gp(untied),
                leaves=leaves, x0s=x0s, x0s_2=x0s_2, jax=ref,
                params=CostParams(**{k: t64(v) for k, v in leaves.items()}))


@pytest.fixture
def mesh_1x1():
    """A (1, 1) mesh over a gloo group of this process alone, destroyed
    (with its programs) after the test."""
    initialize(f'tcp://localhost:{free_port()}', world_size=1, rank=0,
               device='cpu', timeout_s=60.0)
    try:
        yield make_mesh(1, 1, device='cpu')
    finally:
        if dist.is_initialized():
            destroy_group()


@pytest.fixture
def captures(monkeypatch):
    """Stand-in graphs that capture gloo's collectives; yields the list of
    captures the solver takes."""
    use_stand_in_graphs(monkeypatch)
    capture_gloo(monkeypatch)
    seen = []

    def counted(record, s, pool=None, loop_iters=None):
        seen.append(record)
        return stand_in_capture(record, s, pool, loop_iters)

    monkeypatch.setattr(solver, '_capture', counted)
    yield seen
    solver.clear_programs()


def _solve(mesh, problem, x0s, gp='gp'):
    return solve_batch_2d(mesh, problem[gp], 2, 1, t64(problem[x0s]),
                          problem['params'], H, -1.0, 1.0, CFG)


def _eager(solve):
    """solve() with the solver's loop run eagerly (chip_smoke.py's
    eager_loop): the reference a kept program is held to."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver, '_run_graphed', solver._run_eager)
        return solve()


def _bits(t):
    return t.view({torch.float64: torch.int64}.get(t.dtype, t.dtype))


def _same(a, b):
    for k in FIELDS_OUT:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(_bits(x), _bits(y)), k


def _miss_then_hit(mesh, problem, captures, gp='gp'):
    """A miss on x0s and a hit on x0s_2, each held to the eager solve to
    the bit; the miss captures the step and the init, the hit nothing.
    Returns the miss's result."""
    out = {}
    for name, want in (('x0s', 2), ('x0s_2', 0)):
        n0 = len(captures)
        out[name] = _solve(mesh, problem, name, gp)
        assert len(captures) - n0 == want, name
        assert len(solver._PROGRAMS) == 1
        _same(out[name], _eager(lambda: _solve(mesh, problem, name, gp)))
    return out['x0s']


def test_kept_sharded_program_1x1_equals_eager_and_jax(problem, mesh_1x1,
                                                       captures):
    """(1, 1): the first call keeps one program, a call on other x0s
    captures nothing; both equal the eager loop to the bit, and the first
    JAX's solve_batch at tests/test_model_sharded.py's bars. The program's
    key names the mesh's shape and this rank's coordinates, and the group:
    gloo, one rank, rank 0, its serial number."""
    res = _miss_then_hit(mesh_1x1, problem, captures)
    (key,) = solver._PROGRAMS
    backend, size, rank, serial = key[-2]
    assert (backend, size, rank) == ('gloo', 1, 0) and serial > 0
    method, (kind, shape, axes, coords, *_), *_ = key[0]
    assert (method, kind) == ('lbfgs', 'sharded_value_and_grad')
    assert (shape, axes, coords) == ((1, 1), ('batch', 'model'), (0, 0))
    ref = problem['jax']
    np.testing.assert_allclose(np_(res.u), np.asarray(ref.u), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(np_(res.cost), np.asarray(ref.cost),
                               rtol=1e-8, atol=1e-11)


def test_untied_branch_is_kept_too(problem, mesh_1x1, captures):
    """The untied branch (the einsum form, no kernel) as a kept program:
    miss and hit equal to the eager loop to the bit."""
    assert not problem['untied'].config.tied_lambdas
    _miss_then_hit(mesh_1x1, problem, captures, gp='untied')


def test_new_group_never_reuses_a_program(problem, captures):
    """destroy_group releases the group's programs (their graphs reset)
    and leaves a program without collectives kept; a new group's first
    call misses (its key holds a new serial) and equals the old group's
    result to the bit."""
    results, keys = [], []
    for _ in range(2):
        initialize(f'tcp://localhost:{free_port()}', world_size=1, rank=0,
                   device='cpu', timeout_s=60.0)
        try:
            n0 = len(captures)
            results.append(_solve(make_mesh(1, 1, device='cpu'), problem,
                                  'x0s'))
            assert len(captures) - n0 == 2
            (key,) = [k for k, prog in solver._PROGRAMS.items()
                      if prog.p.group is not None]
            keys.append(key)
            graphs = list(solver._PROGRAMS[key].graphs)
            batch.solve_batch(problem['gp'], 2, 1, t64(problem['x0s']),
                              problem['params'], H, -1.0, 1.0, CFG)
            assert len(solver._PROGRAMS) == 2
        finally:
            destroy_group()
        assert [g.resets for g in graphs] == [1, 1]
        (left,) = solver._PROGRAMS.values()
        assert left.p.group is None
    differ = [i for i, (a, b) in enumerate(zip(*keys)) if a != b]
    assert differ == [len(keys[0]) - 2]
    _same(results[0], results[1])


def test_capture_rule_keeps_gloo_and_the_cpu_eager(problem, mesh_1x1,
                                                   monkeypatch):
    """The rule fixed in advance (solver._collectives_captured): a
    value-and-grad without collectives may be captured; a gloo group's
    collectives are captured neither on the CPU nor on CUDA, an NCCL
    group's on CUDA only. A solve over gloo keeps no program, on the
    plain CPU and with the stand-in graphs alike."""
    group = dist.group.WORLD
    cpu, cuda = torch.device('cpu'), torch.device('cuda')
    assert solver._collectives_captured(None, cpu)
    assert not solver._collectives_captured(group, cpu)
    assert not solver._collectives_captured(group, cuda)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, 'get_backend', lambda g=None: 'nccl')
        assert solver._collectives_captured(group, cuda)
        assert not solver._collectives_captured(group, cpu)
    solver.clear_programs()
    plain = _solve(mesh_1x1, problem, 'x0s')
    assert not solver._PROGRAMS
    use_stand_in_graphs(monkeypatch)
    _same(plain, _solve(mesh_1x1, problem, 'x0s'))
    assert not solver._PROGRAMS


# ------------------------------------------------------ (1, 2) in two ranks --
@pytest.fixture(scope='module')
def kept_run(problem, tmp_path_factory):
    """2 ranks, a (1, 2) mesh: each rank's eager and kept solves on both
    batches (tests/torch_dist_worker.py, case 'kept')."""
    tmp = str(tmp_path_factory.mktemp('kept'))
    inp = os.path.join(tmp, 'kept_in.npz')
    prefix = os.path.join(tmp, 'kept_out')
    np.savez(inp, x0s=problem['x0s'], x0s_2=problem['x0s_2'],
             iters=np.int64(ITERS), horizon=np.int64(H),
             **problem['leaves'],
             **{f'gp_{k}': np.asarray(getattr(problem['jgp'], k))
                for k in FIELDS})
    env = {k: v for k, v in os.environ.items()
           if k not in ('PYTHONPATH', 'XLA_FLAGS')}
    env['OMP_NUM_THREADS'] = '1'
    launch_ranks([sys.executable, WORKER, 'kept', inp, prefix], 2,
                 LAUNCH_TIMEOUT_S, env=env, cwd=ROOT)
    return [dict(np.load(f'{prefix}_rank{r}.npz')) for r in range(2)]


def test_kept_program_1x2_ranks_equal_to_the_bit(kept_run):
    """Both ranks of the model group computed every result to the bit and
    replayed the step as often: their loops ran in lockstep."""
    r0, r1 = kept_run
    assert r0.keys() == r1.keys()
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert int(r0['kept_x0s_passes']) > 0


def test_kept_program_1x2_equals_eager_and_captures_once(kept_run):
    """On each rank: the gloo rule keeps no program on the plain CPU; the
    kept program (gloo captured by the stand-ins) equals the eager solve
    to the bit on both batches, captures its two graphs on the first call
    and nothing on the second."""
    for out in kept_run:
        assert int(out['eager_programs']) == 0
        for name in ('x0s', 'x0s_2'):
            for k in FIELDS_OUT:
                np.testing.assert_array_equal(
                    out[f'kept_{name}_{k}'], out[f'eager_{name}_{k}'],
                    err_msg=f'{name} {k}')
        assert int(out['kept_x0s_captures']) == 2
        assert int(out['kept_x0s_2_captures']) == 0


def test_kept_program_1x2_matches_jax_solve_batch(problem, kept_run):
    ref = problem['jax']
    for out in kept_run:
        np.testing.assert_allclose(out['kept_x0s_u'], np.asarray(ref.u),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(out['kept_x0s_cost'],
                                   np.asarray(ref.cost), rtol=1e-8,
                                   atol=1e-11)
