"""Structured per-solve and per-episode metrics (port of
gpmpc_tpu/utils/metrics.py).

Every solve returns structured diagnostics (SolveResult: cost, iterations,
projected-gradient norm) and every episode a typed EpisodeLog; this module
adds a small JSONL sink and summary statistics so that long runs produce
machine-readable telemetry. Tensors are read to the host.
"""

from __future__ import annotations

import json
import os
import time
import numpy as np
import torch


def _np(v) -> np.ndarray:
    return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v))


class JsonlLogger:
    """Append-only JSONL metrics writer with a wall-clock stamp per record."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._t0 = time.time()

    def log(self, record: dict) -> None:
        rec = dict(record)
        rec.setdefault('t', round(time.time() - self._t0, 6))
        with open(self.path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    def log_solve(self, step: int, result) -> None:
        """result: a SolveResult (possibly batched)."""
        cost = _np(result.cost)
        iters = _np(result.iters)
        pg = _np(result.pg_norm)
        self.log(dict(kind='solve', step=step,
                      cost_mean=float(cost.mean()),
                      cost_max=float(cost.max()),
                      iters_mean=float(iters.mean()),
                      pg_norm_max=float(pg.max()),
                      batch=int(cost.size)))

    def log_episode(self, log) -> None:
        """log: a sim.simulator.EpisodeLog."""
        self.log(dict(kind='episode',
                      steps=int(len(log.actions)),
                      total_reward=float(np.sum(log.rewards)),
                      solve_time_p50=float(np.median(log.solve_times)),
                      solve_time_max=float(np.max(log.solve_times))
                      if len(log.solve_times) else 0.0,
                      final_cost=float(log.costs[-1]) if len(log.costs)
                      else float('nan')))


def episode_summary(log) -> dict:
    """Summary stats of an EpisodeLog (solves/s, latency percentiles)."""
    st = np.asarray(log.solve_times)
    warm = st[min(3, max(len(st) - 1, 0)):]
    return dict(
        steps=int(len(log.actions)),
        total_reward=float(np.sum(log.rewards)),
        solve_p50_s=float(np.median(warm)) if warm.size else float('nan'),
        solve_p95_s=float(np.percentile(warm, 95)) if warm.size else float('nan'),
        solves_per_s=float(1.0 / np.median(warm)) if warm.size else float('nan'),
        mean_iters=float(np.mean(log.iters)) if len(log.iters) else 0.0,
    )
