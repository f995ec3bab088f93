"""B solves, each against its own exact-GP draw of the headline data:
gpmpc_tpu_torch.parallel.batch.solve_batch_gp over a GPState stacked over
the lanes (`stack_gps`, then one f64 fit of all lanes, gp.state.fit), with
the configuration's `gp_draw_solver` SolverConfig. No K kernel runs: each
lane's single-scenario rollout under torch.func.vmap does the work."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import draws
from portbench.entries.sweep import Sweep
from portbench.reference import objective as ref


class Entry(Sweep):

    def data(self):
        """(x (L, n, D), next states (L, n, ds)): the headline data of the
        configuration's GP-draw seeds, in the order the run's seed draws."""
        first, last = self.cfg['gp_draw_seeds']
        seeds = np.arange(first, last)[draws.draw_order(self.seed,
                                                         last - first)]
        if len(seeds) < self.lanes:
            raise ValueError(f'{len(seeds)} GP draws for {self.lanes} lanes')
        pairs = [draws.headline_data(self.cfg,
                                     np.random.default_rng(int(s)))
                 for s in seeds[:self.lanes]]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    def make_gp(self):
        from gpmpc_tpu_torch.gp import state as gp_state
        from gpmpc_tpu_torch.parallel.batch import stack_gps
        cfg = self.cfg
        x, ns = self.data()
        d = cfg['state_dim'] + cfg['action_dim']
        one = gp_state.make_gp(
            gp_state.GPConfig(capacity=cfg['capacity'], x_dim=d,
                              out_dim=cfg['state_dim']),
            log_lambdas=np.log([cfg['lambdas']] * d),
            log_sigma_f=np.log(cfg['sigma_f']),
            log_sigma_n=np.log(cfg['sigma_n']), dtype=torch.float32,
            device=self.dev)
        stacked = stack_gps([one] * self.lanes)
        n, cap = x.shape[1], cfg['capacity']
        xb = torch.zeros((self.lanes, cap, d), **self.f32)
        yb = torch.zeros((self.lanes, cfg['state_dim'], cap), **self.f32)
        mask = torch.zeros((self.lanes, cap), dtype=torch.bool,
                           device=self.dev)
        xb[:, :n] = torch.tensor(x, **self.f32)
        yb[:, :, :n] = torch.tensor(ns, **self.f32).transpose(1, 2)
        mask[:, :n] = True
        count = torch.full((self.lanes,), n, dtype=torch.int32,
                           device=self.dev)
        return gp_state.fit(dataclasses.replace(stacked, x=xb, y=yb,
                                                mask=mask, count=count))

    def solve(self, x0s):
        from gpmpc_tpu_torch.mpc.solver import SolverConfig
        from gpmpc_tpu_torch.parallel.batch import solve_batch_gp
        cfg = self.cfg
        return solve_batch_gp(self.gp, cfg['state_dim'], cfg['action_dim'],
                              x0s, self.cost_params, cfg['horizon'],
                              cfg['lb'], cfg['ub'],
                              SolverConfig(**cfg['gp_draw_solver']))

    def reference_gp(self):
        x, ns = self.data()
        t = torch.tensor
        return ref.fit(t(x, device=self.dev), t(ns, device=self.dev),
                       self.cfg['lambdas'], self.cfg['sigma_f'],
                       self.cfg['sigma_n'])
