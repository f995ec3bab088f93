"""A closed loop of back-to-back batches of B lanes of the headline problem,
each waiting for the last: one researcher's sweep over x0 x gamma (x GP
draws). What both sweep entries share: the inputs (each batch's x0s from
the configuration's fixed pool, in an order drawn from the seed), the
window's records and the judgement against the reference.

The judgement, once the window has closed and the program's state is
freed: the reference fits its own GPs in f64 from the benchmark's data and,
for every lane of every batch the window finished, works out the cost of
the returned controls J64(u), the cost of the solve's start J64(0) and the
projected-gradient residual pg = max_t |u - clip(u - dJ64/du, lb, ub)|:
whether the controls are a stationary point of the reference objective
(the GP posterior, the rollout's variance trace and the risk-sensitive
cost, through their gradient). The numbers are `portbench/judge.py`'s; a
lane is a wrong answer (`bad_lanes`) where its controls leave the box,
its controls or cost are not finite, or its cost is off J64(u) by more
than the cell's cost_off, relative to 1 + |J64(u)|. Its descent is
(J64(0) - J64(u)) / (1 + |J64(0)|): a lane that returns its start, or
anything no better, has none.
"""

from __future__ import annotations

import torch

from portbench import draws, judge
from portbench.reference import objective as ref

# Lanes the reference judges at once (its autograd's memory: 20 steps of
# (64, 200, 200, 3) f64 temporaries).
BLOCK = 64


class Sweep:
    """Subclasses set up the program's GP(s) (`make_gp`, `reference_gp`)
    and call it (`solve`)."""

    def __init__(self, cfg: dict, wl: dict, seed: int, dev):
        self.cfg, self.wl, self.seed, self.dev = cfg, wl, seed, dev
        self.lanes = int(wl['lanes'])
        self.f32 = dict(dtype=torch.float32, device=dev)
        self.gamma = torch.tensor(draws.gammas(cfg, self.lanes), **self.f32)
        self.x0_cache: dict = {}

    def x0s(self, k: int) -> torch.Tensor:
        """Batch k's x0s, uniform over the configuration's x0_range: the
        window's batches (k >= 0) cycle through the fixed pool of
        x0_pool batches in an order drawn from the seed, so that every seed
        offers the same work; the warm-up's and the profile's (k < 0) are
        drawn from the seed."""
        if k not in self.x0_cache:
            pool = self.cfg['x0_pool']
            if k >= 0:
                order = draws.rng(self.seed, 1).permutation(pool['batches'])
                gen = draws.rng(pool['seed'], 1,
                                int(order[k % pool['batches']]))
            else:
                gen = draws.rng(self.seed, 2, k)
            x = gen.uniform(*self.cfg['x0_range'],
                            (self.lanes, self.cfg['state_dim']))
            self.x0_cache[k] = torch.tensor(x, **self.f32)
        return self.x0_cache[k]

    def params(self):
        from gpmpc_tpu_torch.mpc.cost import CostParams
        ds, da = self.cfg['state_dim'], self.cfg['action_dim']
        return CostParams(
            Q=float(self.cfg['Q_diag']) * torch.eye(ds, **self.f32),
            R=float(self.cfg['R_diag']) * torch.eye(da, **self.f32),
            gamma=self.gamma, x_ref=torch.zeros(ds, **self.f32),
            u_ref=torch.zeros(da, **self.f32))

    def setup(self) -> None:
        self.gp = self.make_gp()
        self.cost_params = self.params()
        for k in range(-int(self.wl.get('warmup_batches', 1)), 0):
            self.unit(k)

    def unit(self, k: int) -> dict:
        """Batch k: the solve of its lanes; its record (on the device)."""
        res = self.solve(self.x0s(k))
        return dict(k=k, lanes=self.lanes, u=res.u.detach().clone(),
                    cost=res.cost.detach().clone(),
                    iters=res.iters.detach().clone())

    def release(self) -> None:
        from gpmpc_tpu_torch.mpc import solver
        solver.clear_programs()
        self.gp = None

    # -- the judgement --------------------------------------------------
    def lane_numbers(self, records: list) -> dict:
        """Per lane of every record: the cost gap, the projected-gradient
        residual and whether the answer is bad (module docstring)."""
        h = ref.headline(self.cfg, self.dev)
        gp = self.reference_gp()
        gamma = self.gamma.double()
        gaps, pgs, bad, descent = [], [], [], []
        for rec in records:
            x0 = self.x0s(rec['k']).double()
            u, cost = rec['u'], rec['cost']
            finite = (torch.isfinite(u).flatten(1).all(1)
                      & torch.isfinite(cost))
            inside = ((u >= h.lb) & (u <= h.ub)).flatten(1).all(1)
            bad.append(~(finite & inside))
            for b0 in range(0, self.lanes, BLOCK):
                idx = torch.arange(b0, min(b0 + BLOCK, self.lanes),
                                   device=self.dev)
                j, pg = ref.judge(ref.lane(gp, idx), h, x0[idx], u[idx],
                                  gamma[idx])
                with torch.no_grad():
                    j0 = ref.objective(ref.lane(gp, idx), h, x0[idx],
                                       torch.zeros_like(u[idx],
                                                        dtype=ref.F64),
                                       gamma[idx])
                c = cost[idx].double()
                gaps.append(((c - j).abs() / (1.0 + j.abs()))
                            .nan_to_num(nan=float('inf')))
                pgs.append(pg.nan_to_num(nan=float('inf')))
                descent.append(((j0 - j) / (1.0 + j0.abs()))
                               .nan_to_num(nan=-float('inf')))
        gaps = torch.cat(gaps)
        bad = torch.cat(bad) | (gaps > float(self.wl['cost_off']))
        return dict(cost_gap=gaps, pg=torch.cat(pgs), bad=bad,
                    descent=torch.cat(descent))

    def check(self, records: list) -> dict:
        """{name: value} of the numbers the cell's limits name
        (judge.numbers); the others go to self.diagnostics."""
        numbers, self.diagnostics = judge.numbers(
            self.lane_numbers(records), self.wl)
        return numbers

    def work(self, records: list) -> int:
        return sum(r['lanes'] for r in records)

