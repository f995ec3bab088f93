"""Whole-solve rates of two checkouts of this repository on one card, in
turns.

Each checkout solves with its own code: a child process imports that
checkout's package, builds the headline problem
(problems.make_headline_problem: B = 256, f32, H = 20) and times the plain
solve_batch at 40 iterations (tol 1e-4), with a diagonal covariance and
with full_cov=True, over fresh x0s (U(-1, 1)^(B, 2) from one seed: the same
batches in every child), one warm solve of each kind and mode first. Both
are timed in each mode the child is given, in turns on every batch:
'as-is' runs the checkout as its callers run it, 'eager' forces the
solver's loop eager (mpc/solver.py's `_run_graphed` replaced by
`_run_eager`, in a checkout that has them). The checkouts run in the order
A, B, B, A, so that a drift of the card or its host shows as a spread
between the two runs of one side; checkout B runs both modes, A 'as-is'.
Each solve reports its wall, its loop iterations and a digest of its
result's bits (u, cost, iters, pg_norm, converged), so the runs can be
held to computing the same thing: every diagonal batch across all runs and
modes, and every full-covariance batch within each checkout (two
checkouts with different PSD-clip eigensolvers agree only to rounding).

Run on the card's machine, from the root of checkout B, with checkout A
unpacked beside it (e.g. `git archive <commit> | tar -x -C _checkout/a`):

    python -m gpmpc_tpu_torch.benchmarks.compare_solves _checkout/a . \
        --out compare_out

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

CHILD = r'''
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from gpmpc_tpu_torch.mpc import solver
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.parallel.batch import solve_batch
from gpmpc_tpu_torch.problems import make_headline_problem
modes = json.loads(sys.argv[2])
b, iters, diag_reps, full_reps = (int(v) for v in sys.argv[3:7])
dev = torch.device('cuda')
p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
cfg = SolverConfig(max_iters=iters, tol=1e-4)
graphed = getattr(solver, '_run_graphed', None)

def digest(res):
    h = hashlib.sha256()
    for k in ('u', 'cost', 'iters', 'pg_norm', 'converged'):
        h.update(getattr(res, k).detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]

def solve(x0s, mode, full_cov):
    if graphed is not None:
        solver._run_graphed = solver._run_eager if mode == 'eager' else graphed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_batch(p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub, cfg,
                      full_cov=full_cov)
    torch.cuda.synchronize()
    return dict(wall_s=time.perf_counter() - t0,
                iters=int(res.iters.max()), digest=digest(res))

def x0s_of(rng):
    return torch.tensor(rng.uniform(-1, 1, (b, 2)), dtype=torch.float32,
                        device=dev)

out = {'diag': {m: [] for m in modes}, 'full_cov': {m: [] for m in modes}}
for m in modes:
    solve(p.x0s, m, False)
    solve(p.x0s, m, True)
for kind, seed, reps in (('diag', 123, diag_reps), ('full_cov', 321,
                                                     full_reps)):
    rng = np.random.default_rng(seed)
    for rep in range(reps):
        x0s = x0s_of(rng)
        for m in modes if rep % 2 == 0 else modes[::-1]:
            out[kind][m].append(solve(x0s, m, kind == 'full_cov'))
print('RESULT ' + json.dumps(out), flush=True)
'''


def time_checkout(root: str, modes, timeout: int = 900) -> dict:
    """One child process's solves in the checkout at `root`."""
    out = subprocess.run(
        [sys.executable, '-c', CHILD, os.path.abspath(root), json.dumps(modes),
         str(B), str(ITERS), str(DIAG_REPS), str(FULL_COV_REPS)],
        capture_output=True, text=True, timeout=timeout,
        cwd=os.path.abspath(root))
    if out.returncode != 0:
        raise RuntimeError(f'{root} failed:\n{out.stderr[-4000:]}')
    for line in out.stdout.splitlines():
        if line.startswith('RESULT '):
            return json.loads(line[len('RESULT '):])
        print(line, flush=True)
    raise RuntimeError(f'{root} printed no result')


def _rate(solves) -> float:
    """Solves/s: the median over the batches."""
    return float(np.median([B / s['wall_s'] for s in solves]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('a', help='checkout A (e.g. the parent commit)')
    ap.add_argument('b', help='checkout B (e.g. the change)')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    runs = []
    for tag, root, modes in (('A', args.a, ['as-is']),
                             ('B', args.b, ['eager', 'as-is']),
                             ('B', args.b, ['eager', 'as-is']),
                             ('A', args.a, ['as-is'])):
        res = time_checkout(root, modes)
        runs.append(dict(tag=tag, root=root, solves=res))
        print(f'run {len(runs)} ({tag}): solves/s ' + '; '.join(
            f'{kind} ' + ', '.join(f'{m} {_rate(v):.2f}'
                                   for m, v in res[kind].items())
            for kind in ('diag', 'full_cov')) + '; iterations '
            + str({kind: {m: [s['iters'] for s in v]
                          for m, v in res[kind].items()}
                   for kind in ('diag', 'full_cov')}), flush=True)
    # Every run and mode solves the same batches: the digests of batch k
    # should agree across all of them (full covariance: within a checkout).
    def agree(kind, tags):
        per_batch = [[s['digest'] for s in solves] for r in runs
                     if r['tag'] in tags
                     for solves in r['solves'][kind].values()]
        return all(d == per_batch[0] for d in per_batch)

    same = {'diag': agree('diag', 'AB'), 'full_cov A': agree('full_cov', 'A'),
            'full_cov B': agree('full_cov', 'B')}
    print(f'same bits across runs and modes: {same}', flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'compare_solves.json'), 'w') as f:
            json.dump(dict(runs=runs, same_bits=same), f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
