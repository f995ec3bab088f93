"""P2 on the card: K1's function under the arithmetic modes of the TPU probe.

Port of benchmarks/kernel_probe.py. Each TPU mode maps to a variant of
ops/kernels/probe.py: `base` (p by a matmul at the highest precision) to
`tc_p` (p at 3xTF32 on the tensor cores), `vpu_p` (p by d multiply-adds) to
`full` (K1), `vpu_3p` (the reduction in three bf16 passes) to `red_3xtf32`,
and `vpu_def` (one bf16 pass) to `red_tf32`. Each is timed as the ablation
is (kernel-only and chain step), and its trace t = sum_i rw[..., i, 0] is
held to the f64 oracle (kernel_probe.py:145-161), as the max relative error
over (b, e): on the probes' inputs, and on the headline GP's own x and b_lam
with random u in the data's range and random SPD M2, where the trace
cancels.

    python -m gpmpc_tpu_torch.benchmarks.kernel_probe --out DIR

writes DIR/kernel_probe.json. `run(device='cpu')` runs the plain versions
eagerly: its times mean nothing.
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch.benchmarks import kernel_ablate as ka
from gpmpc_tpu_torch.benchmarks.chain import kernel_args
from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.ops.kernels import probe
from gpmpc_tpu_torch.ops.kernels import variance_trace as vt

MODES = {'base': 'tc_p', 'vpu_p': 'full', 'vpu_3p': 'red_3xtf32',
         'vpu_def': 'red_tf32'}


def trace_rel_err(variant, args):
    """max over (b, e) of |t - t64| / (|t64| + 1e-9), t64 the f64 oracle on
    the same f32 inputs."""
    t = probe.rw_probe(variant, *args)[..., 0].sum(dim=-1).double()
    t64 = vt.rw_tied_reference(*(a.double() for a in args))[..., 0].sum(-1)
    return float(((t - t64).abs() / (t64.abs() + 1e-9)).max())


def headline_args(b, device, rng):
    """K1's f32 arguments on the headline GP's x and b_lam, at the operands
    of problems.headline_operands (random u in the data's range, random SPD
    M2)."""
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.problems import (headline_operands,
                                          make_headline_problem)
    cache = build_rollout_cache(
        make_headline_problem(b=2, dtype=torch.float32, device=device).gp,
        2, 1)
    return kernel_args(*(t.to(torch.float32)
                         for t in headline_operands(rng, b, cache)))


def run(device=None, b=256, n=256) -> dict:
    """P2: each mode's kernel-only and chain-step microseconds and the max
    relative error of its trace against the f64 oracle."""
    dev = resolve_device(device)
    calls0 = probe.LAUNCHES_PROBE
    variants = list(MODES.values())
    kernel, chain, _, rng = ka.time_variants(variants, dev, b, n)
    x, m2, blam, _ = ka.probe_inputs(n, dev)
    fresh = kernel_args(ka.draw_u(rng, (b, ka.D), dev), m2, x, blam)
    headline = headline_args(b, dev, rng)
    rows = {}
    for mode, v in MODES.items():
        _, ratio = ka.variant_errors(v, fresh)
        rows[mode] = dict(variant=v, kernel_us=kernel['results'][v]['us'],
                          chain_us=chain['results'][v]['us'],
                          t_rel_err_probe_inputs=trace_rel_err(v, fresh),
                          t_rel_err_headline=trace_rel_err(v, headline),
                          bar_ratio=ratio)
    return dict(probe='P2 kernel_probe', device=ka.device_name(dev),
                shape=dict(b=b, n=n, d=ka.D, e=ka.E), variants=rows,
                kernel=kernel, chain=chain,
                wrapper_calls=probe.LAUNCHES_PROBE - calls0)


if __name__ == '__main__':
    raise SystemExit(ka.main(run, 'kernel_probe'))
