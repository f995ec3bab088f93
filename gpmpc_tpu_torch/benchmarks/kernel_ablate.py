"""P1 on the card: where K1's time goes, by ablation.

Port of benchmarks/kernel_ablate.py. Each variant of K1's body
(ops/kernels/probe.py, csrc/variance_trace_probe.cu) drops or swaps one
stage; its time beside `full`'s (K1 itself) locates the stage's share, and
the plan_* variants time K1 at other block shapes than its own. Each
variant is timed twice by `chain`: alone on fixed inputs (kernel-only, the
device time of one launch) and inside the probes' chain step (prep
included). On the TPU's inputs (kernel_ablate.py:160-164): x ~ U(-3, 3),
symmetric blam ~ U(-0.1, 0.1), M2 = 0.3 I, from np.random.default_rng(0).

    python -m gpmpc_tpu_torch.benchmarks.kernel_ablate --out DIR \
        [--dtype float64] [--b 3584]

writes DIR/kernel_ablate.json (kernel_ablate_f64_b3584.json for
`--dtype float64 --b 3584`). At f64 the variants are probe.F64_VARIANTS:
the scalar body's stages at T = double (K1's f64 instance before the
tensor-core body) and the tensor-core body's variants. `run(device='cpu')`
runs the plain versions eagerly: its times mean nothing.
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np
import torch

from gpmpc_tpu_torch.benchmarks.chain import (ROUNDS, card_line,
                                              chain_slopes, kernel_args,
                                              kernel_slopes)
from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.ops.kernels import probe

D, E = probe.D, probe.E
ABLATE = ('full', 'full_tile256', 'full_s1', 'hwexp', 'noexp', 'nop',
          'nodots', 'nomul', 'empty', 'red_tf32') + probe.PLANS
ABLATE_F64 = probe.F64_VARIANTS
# The TPU variant (benchmarks/kernel_ablate.py) each card variant stands for.
# `vpured` reduced with f32 multiply-adds on the TPU's vector unit, which is
# what K1 already does on the card, so `full` stands for it too.
TPU_VARIANT = {'full': 'full, vpured', 'full_tile256': 'full_tj256, '
               'vpured_tj256', 'full_s1': 'none (scenario sharing off)',
               'hwexp': 'hwexp', 'noexp': 'noexp',
               'nop': 'nop', 'nodots': 'nodots', 'nomul': 'nomul',
               'empty': 'empty', 'red_tf32': 'dott',
               **{v: f'none (launch plan {v[5:]})' for v in probe.PLANS},
               **{v: 'none (the f64 tensor-core body)'
                  for v in probe.MMA_VARIANTS}}


def probe_inputs(n, device, dtype=torch.float32):
    """The TPU probes' data: x (N, d) ~ U(-3, 3), symmetric blam (E, N, N)
    ~ U(-0.1, 0.1), M2 = 0.3 I, in `dtype` on `device`; and the generator,
    whose next draws are the starting points u ~ U(-1, 1) (B, d)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-3, 3, (n, D))
    blam = rng.uniform(-0.1, 0.1, (E, n, n))
    blam = 0.5 * (blam + np.swapaxes(blam, 1, 2))
    t = functools.partial(torch.tensor, dtype=dtype, device=device)
    return t(x), t(np.eye(D) * 0.3), t(blam).contiguous(), rng


def draw_u(rng, shape, device, dtype=torch.float32):
    return torch.tensor(rng.uniform(-1, 1, shape), dtype=dtype,
                        device=device)


def variant_errors(variant, args):
    """The probe kernel's `variant` on args: its max abs error against its
    first plain version of `probe.checks`, and its largest |error| / bar
    over all of them."""
    out = probe.rw_probe(variant, *args).double()
    held = probe.checks(variant, *args)
    ratio = max(float(((out - want).abs() / bar).max())
                for _, want, bar in held)
    return float((out - held[0][1]).abs().max()), ratio


def time_variants(variants, device, b, n, dtype=torch.float32):
    """Kernel-only and chain-step slopes of each variant on the probes'
    inputs; returns (kernel, chain, the fixed kernel-only arguments,
    generator)."""
    x, m2, blam, rng = probe_inputs(n, device, dtype)
    fixed = kernel_args(draw_u(rng, (b, D), device, dtype), m2, x, blam)
    pool = draw_u(rng, (ROUNDS * 2 * len(variants), b, D), device, dtype)
    counter = lambda: probe.LAUNCHES_PROBE  # noqa: E731
    kernel = kernel_slopes(
        {v: functools.partial(probe.rw_probe, v, *fixed) for v in variants},
        device, counter)
    chain = chain_slopes(
        {v: functools.partial(probe.rw_probe, v) for v in variants},
        x, m2, blam, pool, counter)
    return kernel, chain, fixed, rng


def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else device.type)


def run(device=None, b=256, n=256, dtype=torch.float32) -> dict:
    """P1: each ablation variant's kernel-only and chain-step microseconds,
    and its error against its plain version on the fixed inputs; the f32
    variants (ABLATE), or the f64 ones (ABLATE_F64)."""
    dev = resolve_device(device)
    calls0 = probe.LAUNCHES_PROBE
    variants = ABLATE if dtype == torch.float32 else ABLATE_F64
    kernel, chain, fixed, _ = time_variants(variants, dev, b, n, dtype)
    rows = {}
    for v in variants:
        err, ratio = variant_errors(v, fixed)
        rows[v] = dict(tpu_variant=TPU_VARIANT[v],
                       kernel_us=kernel['results'][v]['us'],
                       chain_us=chain['results'][v]['us'],
                       max_abs_err_vs_plain=err, bar_ratio=ratio)
    return dict(probe='P1 kernel_ablate', device=device_name(dev),
                shape=dict(b=b, n=n, d=D, e=E), dtype=str(dtype),
                variants=rows,
                kernel=kernel, chain=chain,
                wrapper_calls=probe.LAUNCHES_PROBE - calls0)


def main(run_fn=run, name='kernel_ablate') -> int:
    """Run `run_fn()` (on the card) and write its result to
    --out/<name>.json; P1 (kernel_ablate) also takes --dtype and --b."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', required=True,
                    help=f'directory for {name}.json')
    if run_fn is run:
        ap.add_argument('--dtype', choices=('float32', 'float64'),
                        default='float32')
        ap.add_argument('--b', type=int, default=256)
    args = ap.parse_args()
    if run_fn is run:
        dtype = getattr(torch, args.dtype)
        res = run_fn(b=args.b, dtype=dtype)
        if dtype == torch.float64:
            name = f'{name}_f64_b{args.b}'
    else:
        res = run_fn()
    res['card'] = card_line() if res['device'] != 'cpu' else 'cpu'
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f'{name}.json'), 'w') as f:
        json.dump(res, f, indent=1)
    print(res['card'])
    for key, row in res['variants'].items():
        print(json.dumps({key: row}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
