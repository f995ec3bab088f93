"""One rank of a multi-process CPU run of gpmpc_tpu_torch's sharded paths,
for tests/test_torch_model_sharded.py. It imports torch and the port only
(no JAX), joins a gloo process group from the torchrun environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as parallel.distributed.launch_ranks
sets it) with a timeout, reads its inputs from an npz and writes what it
computed to <out>_rank<r>.npz.

Usage: python torch_dist_worker.py <case> <inputs.npz> <out prefix>

Cases:
  rows   (1, n) mesh: the row-sharded variance op, tied and untied, its value
         and the gradient of sum(v * w) in u and s_diag.
  model  (1, 2) mesh: the sharded f64 value-and-grad at u_eval, then
         solve_batch_2d.
  batch  (2, 1) mesh: solve_batch_sharded, then solve_batch_multihost on each
         rank's own scenarios.
  rows32 (1, n) mesh: the row-sharded tied variance op in f32 on the
         headline GP (problems.make_headline_problem), its value and
         gradient, the dtype of the partial traces it sums over the ranks,
         and the unsharded f32 op on the same inputs.
  kept   (1, 2) mesh: solve_batch_2d as a kept program (the stand-in graphs
         of torch_stand_in.py, gloo's collectives captured) on x0s, then on
         x0s_2, each beside the eager solve (gloo's rule); each call's
         captures and step replays.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpmpc_tpu_torch.convert import FIELDS, gp_state_from_numpy  # noqa: E402
from gpmpc_tpu_torch.dynamics import build_rollout_cache  # noqa: E402
from gpmpc_tpu_torch.mpc.cost import CostParams  # noqa: E402
from gpmpc_tpu_torch.mpc.solver import SolverConfig  # noqa: E402
from gpmpc_tpu_torch.parallel import distributed as pdist  # noqa: E402
from gpmpc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from gpmpc_tpu_torch.parallel import model_sharded as ms  # noqa: E402
from gpmpc_tpu_torch.parallel.batch import solve_batch_sharded  # noqa: E402
from torch_stand_in import (capture_gloo, stand_in_capture,  # noqa: E402
                            use_stand_in_graphs)

F64 = torch.float64
PG_TIMEOUT_S = 60.0


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def gp_from(inp, prefix, tied):
    return gp_state_from_numpy({k: inp[f'{prefix}{k}'] for k in FIELDS},
                               tied_lambdas=tied, device='cpu', dtype=F64)


def params_from(inp):
    return CostParams(Q=t64(inp['Q']), R=t64(inp['R']), gamma=t64(inp['gamma']),
                      x_ref=t64(inp['x_ref']), u_ref=t64(inp['u_ref']))


def case_rows(inp, world):
    mesh = pmesh.make_mesh(1, world, device='cpu')
    group = mesh.get_group(pmesh.MODEL_AXIS)
    out = {}
    for name, tied in (('tied', True), ('untied', False)):
        cache = build_rollout_cache(gp_from(inp, f'{name}_', tied), 2, 1)
        off, rows = pmesh.row_block(mesh, cache.b_lam)
        u = t64(inp['u']).requires_grad_()
        s = t64(inp['s_diag']).requires_grad_()
        v = ms._variance_multi_batched_diag_rows(
            u, s, cache.x, rows, off, cache.log_lambdas, cache.log_sigma_f,
            t64(inp['means']), group, tied=tied)
        gu, gs = torch.autograd.grad(torch.sum(v * t64(inp['w'])), (u, s))
        out.update({f'{name}_v': v.detach().numpy(), f'{name}_gu': gu.numpy(),
                    f'{name}_gs': gs.numpy()})
    return out


def case_model(inp, world):
    mesh = pmesh.make_mesh(1, 2, device='cpu')
    gp = gp_from(inp, 'gp_', True)
    x0s, params = t64(inp['x0s']), params_from(inp)
    cache, rows, off, x0s_l, params_l = ms.shard_problem(mesh, gp, 2, 1, x0s,
                                                         params)
    f, g = ms.sharded_value_and_grad(mesh, cache, rows, off, x0s_l,
                                     params_l)(t64(inp['u_eval']))
    cfg = SolverConfig(max_iters=int(inp['iters']), tol=1e-6, history=4)
    res = ms.solve_batch_2d(mesh, gp, 2, 1, x0s, params, int(inp['horizon']),
                            -1.0, 1.0, cfg)
    return {'f': f.numpy(), 'g': g.numpy(), 'u': res.u.numpy(),
            'cost': res.cost.numpy(), 'iters': res.iters.numpy(),
            'converged': res.converged.numpy(),
            'n_loc': np.int64(rows.shape[2])}


def case_batch(inp, world):
    mesh = pmesh.make_mesh(2, 1, device='cpu')
    gp = gp_from(inp, 'gp_', True)
    x0s, params = t64(inp['x0s']), params_from(inp)
    cfg = SolverConfig(max_iters=int(inp['iters']), tol=1e-6, history=4)
    h = int(inp['horizon'])
    res = solve_batch_sharded(mesh, gp, 2, 1, x0s, params, h, -1.0, 1.0, cfg)
    rank = torch.distributed.get_rank()
    k = x0s.shape[0] // world
    mine = slice(rank * k, (rank + 1) * k)
    multi = pdist.solve_batch_multihost(
        gp, 2, 1, x0s[mine], params._replace(gamma=None), h, -1.0, 1.0, cfg,
        gammas_local=params.gamma[mine])
    return {'u': res.u.numpy(), 'cost': res.cost.numpy(),
            'iters': res.iters.numpy(), 'multi_u': multi.u.numpy(),
            'multi_cost': multi.cost.numpy()}


def case_rows32(inp, world):
    from gpmpc_tpu_torch.ops import moments
    from gpmpc_tpu_torch.problems import make_headline_problem
    mesh = pmesh.make_mesh(1, world, device='cpu')
    group = mesh.get_group(pmesh.MODEL_AXIS)
    f32 = torch.float32
    cache = build_rollout_cache(make_headline_problem(
        b=2, dtype=f32, device='cpu').gp, 2, 1)
    off, rows = pmesh.row_block(mesh, cache.b_lam)
    summed = []
    orig = ms._SumOverGroup.apply

    def record(t, grp):
        summed.append(str(t.dtype))
        return orig(t, grp)

    out = {}
    for name in ('sharded', 'unsharded'):
        u = torch.tensor(inp['u'], dtype=f32, requires_grad=True)
        s = torch.tensor(inp['s_diag'], dtype=f32, requires_grad=True)
        args = (cache.log_lambdas, cache.log_sigma_f,
                torch.tensor(inp['means'], dtype=f32))
        if name == 'sharded':
            ms._SumOverGroup.apply = record
            try:
                v = ms._variance_multi_batched_diag_rows(
                    u, s, cache.x, rows, off, *args, group, tied=True)
            finally:
                ms._SumOverGroup.apply = orig
        else:
            v = moments.variance_prop_multi_batched_diag(
                u, s, cache.x, cache.b_lam, *args, tied=True)
        gu, gs = torch.autograd.grad(torch.sum(v * torch.tensor(
            inp['w'], dtype=f32)), (u, s))
        out.update({f'{name}_v': v.detach().numpy(),
                    f'{name}_gu': gu.numpy(), f'{name}_gs': gs.numpy()})
    out['summed_dtypes'] = np.array(summed)
    out['v_dtype'] = np.array(str(out['sharded_v'].dtype))
    return out


def case_kept(inp, world):
    import pytest
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.utils import replay_counts
    mesh = pmesh.make_mesh(1, 2, device='cpu')
    gp = gp_from(inp, 'gp_', True)
    params = params_from(inp)
    cfg = SolverConfig(max_iters=int(inp['iters']), tol=1e-6, history=4)

    def solve(x0s):
        return ms.solve_batch_2d(mesh, gp, 2, 1, t64(x0s), params,
                                 int(inp['horizon']), -1.0, 1.0, cfg)

    out = {}
    for name in ('x0s', 'x0s_2'):
        res = solve(inp[name])
        out.update({f'eager_{name}_{k}': getattr(res, k).numpy()
                    for k in ('u', 'cost', 'iters', 'converged')})
    out['eager_programs'] = np.int64(len(solver._PROGRAMS))
    with pytest.MonkeyPatch.context() as mp:
        use_stand_in_graphs(mp)
        capture_gloo(mp)
        seen = []

        def counted(record, s, pool=None, loop_iters=None):
            seen.append(record)
            return stand_in_capture(record, s, pool, loop_iters)

        mp.setattr(solver, '_capture', counted)
        for name in ('x0s', 'x0s_2'):
            n0, before = len(seen), replay_counts.replays_run()
            res = solve(inp[name])
            (prog,) = solver._PROGRAMS.values()
            after = replay_counts.replays_run()
            out.update({f'kept_{name}_{k}': getattr(res, k).numpy()
                        for k in ('u', 'cost', 'iters', 'converged')})
            out[f'kept_{name}_captures'] = np.int64(len(seen) - n0)
            out[f'kept_{name}_passes'] = np.int64(
                after.get(prog.step_counts, 0)
                - before.get(prog.step_counts, 0))
        solver.clear_programs()
    return out


def main():
    case, inp_path, out_prefix = sys.argv[1:4]
    torch.set_num_threads(1)
    pdist.initialize(device='cpu', timeout_s=PG_TIMEOUT_S)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    inp = np.load(inp_path)
    out = {'rows': case_rows, 'model': case_model, 'batch': case_batch,
           'rows32': case_rows32, 'kept': case_kept}[case](inp, world)
    np.savez(f'{out_prefix}_rank{rank}.npz', **out)
    pdist.finish_rank()


if __name__ == '__main__':
    main()
