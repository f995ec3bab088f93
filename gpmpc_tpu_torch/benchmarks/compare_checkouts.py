"""Time the f64 K1 / K2 instances of two checkouts of this repository on one
card, in turns.

Each checkout times the kernels with its own code: a child process imports
that checkout's chip_smoke.py and calls its `time_shapes` (CUDA events over
50 host-enqueued calls, CUDA-graph slope, the plain version's events time),
which builds the checkout's kernels into its own gpmpc_tpu_torch/_build/.
The checkouts run in the order A, B, B, A, so that a drift of the card or
its host shows as a spread between the two runs of one side. The shapes are
the closed loop's (chip_smoke.LOOP_TIMED), K2 at the multistart's 5
candidates, K1 at the uncertainty experiment's, config 4's and config 3b's
shapes, K1 at every lane count of the recipe (chip_smoke.RECIPE_WIDTHS,
the headline's 256 among them), untied K2 at the headline's, and K3 on its
rectangles (one rank's N / 2 and the (1, 1) mesh's N rows of the headline
against all N), timed by the child itself with the checkout's
`rw_tied_block` and chip_smoke's `cuda_ms` and `graph_ms`.

Run on the card's machine, from the root of checkout B, with checkout A
unpacked beside it (e.g. `git archive <commit> | tar -x -C _checkout/a`):

    python -m gpmpc_tpu_torch.benchmarks.compare_checkouts _checkout/a . \
        --out compare_out

It prints each run's lines and writes DIR/compare_checkouts.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (kernel, B, N, valid rows, d, E) timed beside chip_smoke.LOOP_TIMED: the
# recipe's lane counts at the headline's N (RECIPE_WIDTHS), the other tied
# f64 shapes and untied K2 at the headline.
EXTRA_SHAPES = (('K2', 5, 512, 320, 3, 2), ('K1', 1, 512, 400, 4, 2),
                ('K1', 64, 128, 128, 3, 2), ('K1', 256, 128, 128, 5, 4),
                ('K2', 256, 256, 200, 3, 2),
                *(('K1', b, 256, 200, 3, 2)
                  for b in (64, 128, 256, 1024, 2048, 3584)))
# (B, N, valid rows, d, E, Nl) of K3: the headline's rows cut to Nl.
K3_SHAPES = ((256, 256, 200, 3, 2, 128), (256, 256, 200, 3, 2, 256))

CHILD = r'''
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
dev = resolve_device('cuda')
shapes = list(cs.LOOP_TIMED) + [tuple(s) for s in json.loads(sys.argv[2])]
res = cs.time_shapes(dev, shapes, sys.argv[3], np.random.default_rng(11))
out = {k: dict(ms=v['ms'], graph_ms=v['graph_ms'], plain_ms=v['plain_ms'])
       for k, v in res.items()}
rng = np.random.default_rng(13)
fns = {}
for b, n, n_valid, d, e, n_loc in json.loads(sys.argv[4]):
    u, m2, x, blam, _ = cs.loop_inputs(rng, b, n, n_valid, d, e, True, dev)
    a, _, dv = vt._prep_tied(u, m2, x)
    _, g_b, dv_b = vt._prep_tied(u, m2, x[:n_loc])
    args = [t.contiguous() for t in (g_b, dv_b, a, vt._aug(a) * dv[..., None],
                                     blam[:, :n_loc].transpose(1, 2))]
    name = f'K3 f64 B={b} N={n} d={d} E={e} Nl={n_loc}'
    fns[name] = lambda a=args: vt.rw_tied_block(*a)
    out[name] = dict(ms=cs.cuda_ms(fns[name], 50), plain_ms=cs.cuda_ms(
        lambda a=args: vt.rw_tied_block_reference(*a), 50))
for name, ms in cs.graph_ms(fns, dev).items():
    out[name]['graph_ms'] = ms
print('RESULT ' + json.dumps(out), flush=True)
'''


def time_checkout(root: str, tag: str, timeout: int = 900) -> dict:
    """One child process's times of the checkout at `root`."""
    out = subprocess.run([sys.executable, '-c', CHILD, os.path.abspath(root),
                          json.dumps(EXTRA_SHAPES), tag,
                          json.dumps(K3_SHAPES)], capture_output=True,
                         text=True, timeout=timeout, cwd=os.path.abspath(root))
    if out.returncode != 0:
        raise RuntimeError(f'{tag} ({root}) failed:\n{out.stderr[-4000:]}')
    for line in out.stdout.splitlines():
        if line.startswith('RESULT '):
            return json.loads(line[len('RESULT '):])
        print(line, flush=True)
    raise RuntimeError(f'{tag} ({root}) printed no result')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('a', help='checkout A (e.g. the parent commit)')
    ap.add_argument('b', help='checkout B (e.g. the change)')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    runs = []
    for tag, root in (('A', args.a), ('B', args.b), ('B', args.b),
                      ('A', args.a)):
        runs.append(dict(tag=tag, root=root, times=time_checkout(root, tag)))
    for name in runs[0]['times']:
        print(f'{name}: graph ms ' + ', '.join(
            f'{r["tag"]} {r["times"][name]["graph_ms"]:.4f}' for r in runs)
            + '; events ms ' + ', '.join(
            f'{r["tag"]} {r["times"][name]["ms"]:.4f}' for r in runs))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'compare_checkouts.json'), 'w') as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
