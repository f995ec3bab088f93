"""How the GP fit's Cholesky and solves are best called on the card.

The f64 fit (gp/state.py) factorizes one matrix an output, or, for a GP
stacked over lanes, one a lane and output. This times each way of calling
torch's factorization and solves on random SPD f64 matrices at a single
GP's count (2 of N = 256 and 512) and a stacked one's (512 of N = 512):
cholesky_ex batched against one call a matrix; the inverse by
cholesky_solve a matrix at a time, by two triangular solves batched and a
matrix at a time, and by the batched cholesky_solve; the solve of one
right-hand side the same ways. Each time is the mean of 3 synchronized calls
after a warm-up (host clock: the host's launches are part of the cost),
with whether the results of two ways are equal to the bit.

Run on the card's machine:

    python -m gpmpc_tpu_torch.benchmarks.fit_calls --out DIR

It prints one JSON line a shape and writes DIR/fit_calls.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

SHAPES = ((2, 256), (2, 512), (512, 512))


def _ms(fn, reps=3):
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def _spd(b, n, dev):
    a = torch.randn(b, n, n, dtype=torch.float64, device=dev) / n ** 0.5
    return a @ a.mT + 0.05 * torch.eye(n, dtype=torch.float64, device=dev)


def _trsm2(chol, rhs):
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def measure(b, n, dev) -> dict:
    k = _spd(b, n, dev)
    r = torch.randn(b, n, 1, dtype=torch.float64, device=dev)
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    out = dict(b=b, n=n)
    out['chol_batched_ms'], lb = _ms(lambda: torch.linalg.cholesky_ex(k)[0])
    out['chol_each_ms'], ll = _ms(lambda: torch.stack(
        [torch.linalg.cholesky_ex(m)[0] for m in k]))
    out['chol_equal'] = torch.equal(lb, ll)
    out['inv_cholesky_solve_each_ms'], s_each = _ms(lambda: torch.stack(
        [torch.cholesky_solve(eye, m) for m in ll]))
    out['inv_trsm_batched_ms'], t_b = _ms(lambda: _trsm2(ll, eye.expand_as(ll)))
    out['inv_trsm_each_ms'], t_each = _ms(lambda: torch.stack(
        [_trsm2(m, eye) for m in ll]))
    out['inv_cholesky_solve_batched_ms'], s_b = _ms(
        lambda: torch.cholesky_solve(eye.expand_as(ll), ll))
    out['inv_equal'] = dict(trsm_each_vs_cholesky_solve_each=torch.equal(
        t_each, s_each), trsm_batched_vs_each=torch.equal(t_b, t_each),
        cholesky_solve_batched_vs_each=torch.equal(s_b, s_each))
    out['rhs_cholesky_solve_each_ms'], rs = _ms(lambda: torch.stack(
        [torch.cholesky_solve(r[i], m) for i, m in enumerate(ll)]))
    out['rhs_trsm_batched_ms'], rt = _ms(lambda: _trsm2(ll, r))
    out['rhs_equal'] = torch.equal(rs, rt)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', required=True,
                    help='directory for fit_calls.json')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('fit_calls: needs an NVIDIA GPU')
    from gpmpc_tpu_torch.benchmarks.chain import card_line
    card = card_line()
    print(card, flush=True)
    dev = torch.device('cuda')
    torch.manual_seed(0)
    rows = []
    for b, n in SHAPES:
        rows.append(measure(b, n, dev))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'fit_calls.json'), 'w') as f:
        json.dump(dict(card=card, rows=rows), f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
