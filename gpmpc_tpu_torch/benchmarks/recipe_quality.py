"""The production recipe's solution quality on the headline problem, from
several seeds and under diagnostics, on the card.

    python -m gpmpc_tpu_torch.benchmarks.recipe_quality --out DIR [--seeds 0,1,2]

Each row is one solve_batch_multistart_retired with problems.RECIPE and
REFINE on the headline problem (B = 256, its own x0s), scored by
problems.cost_excess against the f64 reference controls, with its wall and
diag counters. Rows at each seed s (the port's own start draws, a
torch.Generator seeded by s):
  seed s          the f32 recipe as users run it: every variance trace
                  evaluated in f64 and rounded (the trace's precision
                  policy, ops/kernels/variance_trace.py);
  f64 seed s      the whole recipe in f64 (the f64 problem);
  trace64 seed s  f32, each tied trace computed from operands upcast by the
                  caller and rounded to f32: the policy done by hand, so it
                  reads as `seed s` to the last digit.
Rows from the first seed, which locate what f32 arithmetic costs:
  phase_a         the exchange rounds and the polish off;
  k1_f32          each tied trace by K1's f32 instance in f32 (native=True):
                  the recipe before the precision policy;
  fwd64           the value in f64 (K1's f64 instance) but the backward in
                  f32 on the f32-rounded rw;
  plain32         each tied trace by its plain PyTorch version in f32.
As a check of the scoring, jax_u: the JAX recipe's own result on a TPU
(benchmarks/results/quality_retired_u_b256.npz, ret_prod_nopre, where the
repository has it) scored by the port's J64. Writes DIR/recipe_quality.json.
`run(device='cpu', b=2)` runs the path on the CPU; its numbers mean nothing
there (the reference controls are B = 256's).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.mpc import solver
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
from gpmpc_tpu_torch.parallel.batch import solve_batch_multistart_retired
from gpmpc_tpu_torch.problems import (RECIPE, RECIPE_NAME, REF_FILE, REFINE,
                                      cost_excess, headline_j64,
                                      make_headline_problem)

_HERE = os.path.dirname(os.path.abspath(__file__))
JAX_U = os.path.join(_HERE, '..', '..', 'benchmarks', 'results',
                     'quality_retired_u_b256.npz')


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _trace64(u, m2, x, b_lam, _k1=vt.variance_trace_batched_tied):
    """The tied variance trace in f64 (K1's f64 instance on the card),
    rounded to its inputs' dtype."""
    return _k1(u.double(), m2.double(), x.double(), b_lam.double()).to(u.dtype)


# The tied trace in its operands' own dtype: K1's f32 instance on the card.
k1_f32 = functools.partial(vt.variance_trace_batched_tied, native=True)


class _Fwd64(torch.autograd.Function):
    """The tied trace's value from f64 arithmetic (K1's f64 instance on the
    card), its backward in the operands' dtype on the rounded rw."""

    @staticmethod
    def forward(ctx, u, m2, x, b_lam):
        rw = vt._rw_dispatch(*(t.double() for t in (u, m2, x, b_lam)),
                             tied=True)
        ctx.save_for_backward(u, m2, x, rw.to(u.dtype))
        return rw[..., 0].sum(dim=-1).to(u.dtype)

    @staticmethod
    def backward(ctx, ct):
        u, m2, x, rw = ctx.saved_tensors
        return (*vt._tied_backward(u, m2, x, rw, ct), None, None)


@contextlib.contextmanager
def tied_trace(fn):
    """The tied variance trace computed by `fn` for the length of the
    block. A kept solve program replays the trace its capture recorded, so
    the programs go on the way in and on the way out."""
    orig = vt.variance_trace_batched_tied
    solver.clear_programs()
    vt.variance_trace_batched_tied = fn
    try:
        yield
    finally:
        vt.variance_trace_batched_tied = orig
        solver.clear_programs()


def run(device=None, b=256, seeds=(0, 1, 2)) -> dict:
    """One recipe solve from each seed and under each diagnostic; their
    quality and walls."""
    dev = resolve_device(device)
    problems = {dt: make_headline_problem(b=b, dtype=dt, device=dev)
                for dt in (torch.float32, torch.float64)}
    j64 = headline_j64(b, dev)
    with torch.no_grad():
        j_ref = j64(torch.tensor(np.load(REF_FILE)['u_ref'][:b],
                                 dtype=torch.float64, device=dev))
    refine = SolverConfig(**REFINE)

    def solve(dtype=torch.float32, **kw):
        p = problems[dtype]
        diag = {}
        _sync(dev)
        t0 = time.perf_counter()
        res = solve_batch_multistart_retired(
            p.gp, 2, 1, p.x0s, p.params, p.horizon, p.lb, p.ub, refine,
            diag=diag, **{**RECIPE, **kw})
        _sync(dev)
        wall = time.perf_counter() - t0
        return dict(wall_s=wall, diag=diag, max_iters=int(res.iters.max()),
                    **cost_excess(j64, res.u, j_ref))

    rows = {}
    for s in seeds:
        rows[f'seed {s}'] = solve(seed=s)
        rows[f'f64 seed {s}'] = solve(dtype=torch.float64, seed=s)
        with tied_trace(_trace64):
            rows[f'trace64 seed {s}'] = solve(seed=s)
    first = dict(seed=seeds[0])
    rows['phase_a'] = solve(shift_set=(), neighbor_set=0,
                            propose_smoothed=False, polish_lanes=0, **first)
    for key, fn in (('k1_f32', k1_f32), ('fwd64', _Fwd64.apply),
                    ('plain32', vt.variance_trace_batched_tied_reference)):
        with tied_trace(fn):
            rows[key] = solve(**first)
    if b == 256 and os.path.exists(JAX_U):
        rows['jax_u'] = cost_excess(j64, torch.as_tensor(
            np.load(JAX_U)[RECIPE_NAME], device=dev), j_ref)
    return dict(recipe=RECIPE_NAME, b=b,
                device=(torch.cuda.get_device_name(dev)
                        if dev.type == 'cuda' else dev.type), rows=rows)


def main() -> int:
    from gpmpc_tpu_torch.benchmarks.chain import card_line
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', required=True,
                    help='directory for recipe_quality.json')
    ap.add_argument('--seeds', default='0,1,2',
                    help='comma-separated seeds of the port\'s own draws')
    args = ap.parse_args()
    res = run(seeds=tuple(int(s) for s in args.seeds.split(',') if s))
    res['card'] = card_line()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'recipe_quality.json'), 'w') as f:
        json.dump(res, f, indent=1)
    print(res['card'])
    for key, row in res['rows'].items():
        print(json.dumps({key: row}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
