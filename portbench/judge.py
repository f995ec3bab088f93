"""The numbers a cell's judgement can compare, from the reference's
readings of every answer in the window (a sweep's lanes, an episode's
lane-steps). A cell's workload file names those it compares under
`limits`; the rest are read beside them (`diagnostics`, on standard
error):

  stalled_share  the share of answers whose pg is above the cell's stall_pg;
  pg_p10, pg_median, pg_p90
                 quantiles of pg over the answers;
  bad_lanes      wrong answers (limit 0), each entry's own rule;
  no_descent_share
                 the share of answers whose cost, by the reference, lies
                 not below the cost of the solve's start by the cell's
                 descent share of 1 + |J64(start)| (where the entry reads
                 the start's cost);
  gap_share      the share of answers whose cost is off J64(u) by more
                 than the cell's cost_tight, relative to 1 + |J64(u)|;
  cost_gap       the largest |cost - J64(u)| / (1 + |J64(u)|).
"""

from __future__ import annotations

import torch


def numbers(lanes: dict, wl: dict):
    """({name: value} of the numbers the cell's limits name, {the others})
    from per-answer tensors: pg, cost_gap, bad, and optionally descent."""
    pg = lanes['pg']
    q = torch.quantile(pg.double(), torch.tensor([0.1, 0.5, 0.9],
                                                 dtype=torch.float64,
                                                 device=pg.device))
    out = dict(
        stalled_share=float((pg > float(wl['stall_pg'])).double().mean()),
        pg_p10=float(q[0]), pg_median=float(q[1]), pg_p90=float(q[2]),
        bad_lanes=float(lanes['bad'].sum()),
        cost_gap=float(lanes['cost_gap'].max()))
    if 'cost_tight' in wl:
        out['gap_share'] = float(
            (lanes['cost_gap'] > float(wl['cost_tight'])).double().mean())
    if 'descent' in lanes:
        out['no_descent_share'] = float(
            (lanes['descent'] <= float(wl.get('descent', 0.0))).double().mean())
    limits = wl['limits']
    return ({k: out[k] for k in limits},
            {k: v for k, v in out.items() if k not in limits})
