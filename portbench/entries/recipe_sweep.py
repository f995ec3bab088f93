"""The production recipe over B lanes of one shared exact GP:
gpmpc_tpu_torch.parallel.batch.solve_batch_multistart_retired with the
configuration's `recipe` keywords and its `refine` SolverConfig (the
port's `problems.RECIPE` and `REFINE`, copied into the configuration)."""

from __future__ import annotations

import numpy as np
import torch

from portbench import draws
from portbench.entries.sweep import Sweep
from portbench.reference import objective as ref


class Entry(Sweep):

    def data(self):
        return draws.headline_data(
            self.cfg, np.random.default_rng(self.cfg['data_seed']))

    def make_gp(self):
        from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
        cfg = self.cfg
        x, ns = self.data()
        d = cfg['state_dim'] + cfg['action_dim']
        return make_gp(
            GPConfig(capacity=cfg['capacity'], x_dim=d,
                     out_dim=cfg['state_dim']), x, ns,
            log_lambdas=np.log([cfg['lambdas']] * d),
            log_sigma_f=np.log(cfg['sigma_f']),
            log_sigma_n=np.log(cfg['sigma_n']), dtype=torch.float32,
            device=self.dev)

    def solve(self, x0s):
        from gpmpc_tpu_torch.mpc.solver import SolverConfig
        from gpmpc_tpu_torch.parallel.batch import \
            solve_batch_multistart_retired
        cfg = self.cfg
        recipe = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg['recipe'].items()}
        return solve_batch_multistart_retired(
            self.gp, cfg['state_dim'], cfg['action_dim'], x0s,
            self.cost_params, cfg['horizon'], cfg['lb'], cfg['ub'],
            SolverConfig(**cfg['refine']), **recipe)

    def reference_gp(self):
        x, ns = self.data()
        t = torch.tensor
        return ref.fit(t(x, device=self.dev)[None],
                       t(ns, device=self.dev)[None], self.cfg['lambdas'],
                       self.cfg['sigma_f'], self.cfg['sigma_n'])
