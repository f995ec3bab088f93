"""Whole-solve rates of two checkouts of this repository on one card, in
turns.

Each checkout solves with its own code: a child process imports that
checkout's package, builds the headline problem
(problems.make_headline_problem: B = 256, f32, H = 20) and times the plain
solve_batch at 40 iterations (tol 1e-4), with a diagonal covariance
('diag') and with full_cov=True ('full_cov'), and, with --kinds, (kind
'gp') solve_batch_gp over --gp-lanes GP draws (the headline GP of seeds
0.., one a lane, gamma swept over the lanes) and (kind 'adam') solve_batch
with projected Adam (the per-scenario route, the Adam config of
problems.SPARSE_REF_FILE), (kind 'recipe') the production recipe
solve_batch_multistart_retired with problems.RECIPE and REFINE, and (kind
'3b') suite config 3b's solve_batch (problems.sparse_problem, 40
iterations, x0s U(-0.2, 0.2)^(B, 4) as chip_smoke.py's phase 8a draws
them), over fresh x0s (U(-1, 1)^(B, 2) from one seed: the same batches in
every child), one warm solve of each kind and mode first. Each kind is timed in each mode the child is given, in turns on
every batch:
'as-is' runs the checkout as its callers run it; 'eager' forces the
solver's loop eager (mpc/solver.py's `_run_graphed` replaced by
`_run_eager`, in a checkout that has them); 'graphed' captures each
solve's program anew and drops it (in a program cache of its own, so the
kept programs stay), and 'reused' keeps each program across calls (the
solver's program cache, in a checkout that has one: 'reused' is its
'as-is'); 'host' is 'reused' with the host-read loop (inside
solver._host_read_loop(), in a checkout whose programs run their loop on
the device: the loop before it; its programs are kept beside the device
loop's). The checkouts run in the order A, B, B, A, so that a
drift of the card or its host shows as a spread between the two runs of
one side; checkout A runs 'as-is', checkout B the modes of --modes-b
(eager, graphed and reused by default).
Each solve reports its wall, its loop iterations and a digest of its
result's bits (u, cost, iters, pg_norm, converged), so the runs can be
held to computing the same thing: every diagonal batch across all runs and
modes, and every full-covariance and GP-draw batch within each checkout
(two checkouts with different PSD-clip eigensolvers, a lane loop and a
batched route, or different single-input traces, agree only to rounding).

Run on the card's machine, from the root of checkout B, with checkout A
unpacked beside it (e.g. `git archive <commit> | tar -x -C _checkout/a`):

    python -m gpmpc_tpu_torch.benchmarks.compare_solves _checkout/a . \
        --out compare_out [--kinds gp,adam --gp-lanes 16 --gp-reps 2]

It prints each run's lines and writes DIR/compare_solves.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

B = 256
ITERS = 40
DIAG_REPS = 5
FULL_COV_REPS = 3
ADAM_REPS = 2
RECIPE_REPS = 3
SPARSE_REPS = 5

CHILD = r'''
import contextlib, hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from gpmpc_tpu_torch.mpc import solver
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.parallel.batch import solve_batch
from gpmpc_tpu_torch.problems import make_headline_problem
modes = json.loads(sys.argv[2])
reps = json.loads(sys.argv[3])
b, iters, gp_lanes = (int(v) for v in sys.argv[4:7])
dev = torch.device('cuda')
p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
cfg = SolverConfig(max_iters=iters, tol=1e-4)
width = {'diag': b, 'full_cov': b, 'gp': gp_lanes, 'adam': b, 'recipe': b,
         '3b': b}
if 'recipe' in reps:
    from gpmpc_tpu_torch.parallel.batch import solve_batch_multistart_retired
    from gpmpc_tpu_torch.problems import RECIPE, REFINE
if '3b' in reps:
    from gpmpc_tpu_torch.problems import sparse_problem
    p3 = sparse_problem('3b_sparse_cartpole', dtype=torch.float32, device=dev)
if 'adam' in reps:
    from gpmpc_tpu_torch.problems import SPARSE_REF_FILE
    adam_cfg = SolverConfig(**json.loads(str(
        np.load(SPARSE_REF_FILE)['configs']))['adam'])
if 'gp' in reps:
    from gpmpc_tpu_torch.parallel.batch import solve_batch_gp, stack_gps
    gps = stack_gps([make_headline_problem(b=1, seed=s, dtype=torch.float32,
                                           device=dev).gp
                     for s in range(gp_lanes)])
    gp_params = make_headline_problem(b=gp_lanes, dtype=torch.float32,
                                      device=dev).params
graphed = getattr(solver, '_run_graphed', None)
kept = getattr(solver, '_PROGRAMS', None)
host_read_loop = getattr(solver, '_host_read_loop', None)

def digest(res):
    h = hashlib.sha256()
    for k in ('u', 'cost', 'iters', 'pg_norm', 'converged'):
        v = getattr(res, k)
        if v is not None:  # Adam's converged
            h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]

def solve(x0s, mode, kind):
    if graphed is not None:
        solver._run_graphed = solver._run_eager if mode == 'eager' else graphed
    if mode == 'graphed':
        solver._PROGRAMS = type(kept)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (host_read_loop() if mode == 'host' else contextlib.nullcontext()):
        res = run(x0s, kind)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if mode == 'graphed':
        solver.clear_programs()
        solver._PROGRAMS = kept
    return dict(wall_s=wall, iters=int(res.iters.max()), digest=digest(res))

def run(x0s, kind):
    if kind == 'gp':
        res = solve_batch_gp(gps, 2, 1, x0s, gp_params, p.horizon, p.lb, p.ub,
                             cfg)
    elif kind == 'adam':
        res = solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                          adam_cfg)
    elif kind == 'recipe':
        res = solve_batch_multistart_retired(
            p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
            SolverConfig(**REFINE), **RECIPE)
    elif kind == '3b':
        res = solve_batch(p3.gp, 4, 1, x0s, p3.params, p3.horizon, p3.lb,
                          p3.ub, cfg)
    else:
        res = solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
                          cfg, full_cov=kind == 'full_cov')
    return res

def x0s_of(rng, w, kind):
    x = (rng.uniform(-0.2, 0.2, (w, 4)) if kind == '3b'
         else rng.uniform(-1, 1, (w, 2)))
    return torch.tensor(x, dtype=torch.float32, device=dev)

out = {kind: {m: [] for m in modes} for kind in reps}
for kind in reps:
    for m in modes:
        solve(p3.x0s if kind == '3b' else p.x0s[:width[kind]], m, kind)
for kind, seed in (('diag', 123), ('full_cov', 321), ('gp', 231),
                   ('adam', 312), ('recipe', 213), ('3b', 132)):
    rng = np.random.default_rng(seed)
    for rep in range(reps.get(kind, 0)):
        x0s = x0s_of(rng, width[kind], kind)
        for m in modes if rep % 2 == 0 else modes[::-1]:
            out[kind][m].append(solve(x0s, m, kind))
print('RESULT ' + json.dumps(out), flush=True)
'''


def time_checkout(root: str, modes, reps: dict, gp_lanes: int,
                  timeout: int = 1800) -> dict:
    """One child process's solves in the checkout at `root`: reps[kind]
    batches of each kind."""
    out = subprocess.run(
        [sys.executable, '-c', CHILD, os.path.abspath(root), json.dumps(modes),
         json.dumps(reps), str(B), str(ITERS), str(gp_lanes)],
        capture_output=True, text=True, timeout=timeout,
        cwd=os.path.abspath(root))
    if out.returncode != 0:
        raise RuntimeError(f'{root} failed:\n{out.stderr[-4000:]}')
    for line in out.stdout.splitlines():
        if line.startswith('RESULT '):
            return json.loads(line[len('RESULT '):])
        print(line, flush=True)
    raise RuntimeError(f'{root} printed no result')


def _rate(solves, lanes) -> float:
    """Solves/s: the median over the batches."""
    return float(np.median([lanes / s['wall_s'] for s in solves]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('a', help='checkout A (e.g. the parent commit)')
    ap.add_argument('b', help='checkout B (e.g. the change)')
    ap.add_argument('--out', default=None)
    ap.add_argument('--kinds', default='diag,full_cov',
                    help='comma-separated of diag, full_cov, gp, adam, '
                         'recipe, 3b')
    ap.add_argument('--gp-lanes', type=int, default=16,
                    help="lanes (GP draws) of kind 'gp'")
    ap.add_argument('--gp-reps', type=int, default=2,
                    help="batches of kind 'gp'")
    ap.add_argument('--modes-b', default='eager,graphed,reused',
                    help='comma-separated modes of checkout B, of eager, '
                         'graphed, reused and host')
    args = ap.parse_args()
    kinds = args.kinds.split(',')
    reps = {k: {'diag': DIAG_REPS, 'full_cov': FULL_COV_REPS,
                'gp': args.gp_reps, 'adam': ADAM_REPS,
                'recipe': RECIPE_REPS, '3b': SPARSE_REPS}[k] for k in kinds}
    lanes = {'diag': B, 'full_cov': B, 'gp': args.gp_lanes, 'adam': B,
             'recipe': B, '3b': B}
    modes_b = args.modes_b.split(',')
    runs = []
    for tag, root, modes in (('A', args.a, ['as-is']),
                             ('B', args.b, modes_b),
                             ('B', args.b, modes_b),
                             ('A', args.a, ['as-is'])):
        res = time_checkout(root, modes, reps, args.gp_lanes)
        runs.append(dict(tag=tag, root=root, solves=res))
        print(f'run {len(runs)} ({tag}): solves/s ' + '; '.join(
            f'{kind} ' + ', '.join(f'{m} {_rate(v, lanes[kind]):.2f}'
                                   for m, v in res[kind].items())
            for kind in kinds) + '; iterations '
            + str({kind: {m: [s['iters'] for s in v]
                          for m, v in res[kind].items()}
                   for kind in kinds}), flush=True)
    # Every run and mode solves the same batches: the digests of batch k
    # should agree across all of them (full covariance: within a checkout).
    def agree(kind, tags):
        per_batch = [[s['digest'] for s in solves] for r in runs
                     if r['tag'] in tags
                     for solves in r['solves'][kind].values()]
        return all(d == per_batch[0] for d in per_batch)

    same = {}
    for kind in kinds:
        if kind in ('diag', 'recipe', '3b'):
            same[kind] = agree(kind, 'AB')
        else:
            same.update({f'{kind} A': agree(kind, 'A'),
                         f'{kind} B': agree(kind, 'B')})
    print(f'same bits across runs and modes: {same}', flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'compare_solves.json'), 'w') as f:
            json.dump(dict(runs=runs, same_bits=same), f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
