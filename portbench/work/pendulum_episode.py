"""The least time the card could take for the work a window of the batched
episode needs. At each step of each lane: the reported iterations of the
step's solve (SolveResult.iters of its full-objective refinement) times
one value-and-grad, whose dominant work is the H steps' f64 variance trace
over the N_t^2 pairs of the lane's valid rows (N_t = the pretrain points
and the t appended so far), one exp chain (tied lengthscales) for E = ds
outputs (bounds.trace_op_seconds); and the step's refit, one f64 Cholesky
of N_t^3 / 3 multiply-add pairs on the FP64 tensor cores. Phase 0's
surrogate (means only), the line searches, the means, the cost, the plant
and the rest of the fit are left out, so this is a lower bound: the same
work whatever implements it."""

from __future__ import annotations

from portbench.bounds import PEAK_F64_TC_FLOPS, trace_op_seconds


def least_seconds(ctx) -> float:
    cfg = ctx['config']
    d, e, h = cfg['state_dim'] + cfg['action_dim'], cfg['state_dim'], \
        cfg['horizon']
    total = 0.0
    for rec in ctx['records']:
        iters = rec['iters'].double().sum(0)            # (T,) over the lanes
        for t in range(rec['steps']):
            n = cfg['n_pretrain'] + t
            total += float(iters[t]) * h * trace_op_seconds(n * n, d, e)
            total += rec['lanes'] * (2.0 * n ** 3 / 3.0) / PEAK_F64_TC_FLOPS
    return total
