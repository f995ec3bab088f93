"""The least time the card could take for the work a window of the
headline problem needs: each lane's reported iterations (SolveResult.iters,
summed over the recipe's phases) times one value-and-grad, whose
dominant work is the H steps' f64 variance trace over the N^2 pairs of the
valid training rows, one exp chain (tied lengthscales) for E = ds outputs
(bounds.trace_op_seconds: the operations at the published peaks of their
precision). The rest of a value-and-grad (the means, O(N D E) a step; the
cost) and the recipe's phase 0 and line searches are left out, so this is a
lower bound: the same work whatever implements it."""

from __future__ import annotations

from portbench.bounds import trace_op_seconds


def least_seconds(ctx) -> float:
    cfg = ctx['config']
    n, d = cfg['n_train'], cfg['state_dim'] + cfg['action_dim']
    per_iter = cfg['horizon'] * trace_op_seconds(n * n, d, cfg['state_dim'])
    iters = sum(float(r['iters'].double().sum()) for r in ctx['records'])
    return iters * per_iter
