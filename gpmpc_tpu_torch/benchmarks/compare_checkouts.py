"""Time the f64 K1 / K2 instances of two checkouts of this repository on one
card, in turns.

Each checkout times the kernels with its own code: a child process imports
that checkout's chip_smoke.py and calls its `time_shapes` (CUDA events over
50 host-enqueued calls, CUDA-graph slope, the plain version's events time),
which builds the checkout's kernels into its own gpmpc_tpu_torch/_build/.
The checkouts run in the order A, B, B, A, so that a drift of the card or
its host shows as a spread between the two runs of one side. The shapes are
the closed loop's (chip_smoke.LOOP_TIMED), K2 at the multistart's 5
candidates, K1 at the uncertainty experiment's and config 4's shapes, and
K1 and untied K2 at the headline's.

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

# (kernel, B, N, valid rows, d, E) timed beside chip_smoke.LOOP_TIMED.
EXTRA_SHAPES = (('K2', 5, 512, 320, 3, 2), ('K1', 1, 512, 400, 4, 2),
                ('K1', 64, 128, 128, 3, 2), ('K2', 256, 256, 200, 3, 2),
                ('K1', 256, 256, 200, 3, 2))

CHILD = r'''
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from gpmpc_tpu_torch.device import resolve_device
dev = resolve_device('cuda')
shapes = list(cs.LOOP_TIMED) + [tuple(s) for s in json.loads(sys.argv[2])]
res = cs.time_shapes(dev, shapes, sys.argv[3], np.random.default_rng(11))
print('RESULT ' + json.dumps({k: dict(ms=v['ms'], graph_ms=v['graph_ms'],
                                      plain_ms=v['plain_ms'])
                              for k, v in res.items()}), flush=True)
'''


def time_checkout(root: str, tag: str, timeout: int = 900) -> dict:
    """One child process's times of the checkout at `root`."""
    out = subprocess.run([sys.executable, '-c', CHILD, os.path.abspath(root),
                          json.dumps(EXTRA_SHAPES), tag], capture_output=True,
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
