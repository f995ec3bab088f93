"""B closed-loop receding-horizon episodes at once, run back to back, each
from fresh x0s and the pretrained GP: gpmpc_tpu_torch.sim.simulator.
run_episode_on_device over x0 (B, ds), the online loop users run. Each
step solves every lane by the multistart recipe against the lane's own GP
(K1's grouped form), steps the plant, appends the transition to the lane's
GP and refits it. The plan each step's solve returns is recorded on the
device (parallel.batch.solve_batch_multistart wrapped from here, a copy of
its (B, H, da) controls a step); the episode returns the rest.

The judgement, once the window has closed and the program's state is
freed, for every lane at every step of every episode the window finished:
the reference re-steps the plant from the state and the applied action,
refits the lane's GP in f64 from the pretrain data and the transitions the
episode appended so far (its own plant's next states), and works out the
projected-gradient residual pg = max_t |u - clip(u - dJ64/du, lb, ub)| and
the cost J64(u) of the step's plan from the step's state. Numbers as in
`portbench/judge.py`; a lane-step is a wrong answer (`bad_lanes`) where its
plan or state is not finite, its plan leaves the box, the applied action
is not the plan's first, the plant's next state is off the reference's by
more than the cell's plant_tol, its returned cost is off J64 by more than
cost_off (relative to 1 + |J64|), or, at an episode's last step, the lane's
GP does not hold the pretrain points and one more a step.
"""

from __future__ import annotations

import torch

from portbench import draws, judge
from portbench.reference import objective as ref
from portbench.reference import pendulum as ref_plant

# Lanes the reference judges at once (its autograd's memory: H steps of
# (64, N, N, 3) f64 temporaries at N = 340).
BLOCK = 64


class Entry:

    def __init__(self, cfg: dict, wl: dict, seed: int, dev):
        self.cfg, self.wl, self.seed, self.dev = cfg, wl, seed, dev
        self.lanes = int(wl['lanes'])
        self.steps = int(cfg['steps'])
        # The storage the configuration states: the GP's data and cached
        # fit, the states, the controls and the cost's constants.
        self.fx = dict(dtype=getattr(torch, cfg['precision']['storage']),
                       device=dev)
        self.plans = None
        self._patched = None

    def x0s(self, k: int) -> torch.Tensor:
        """Episode k's x0s, drawn from the seed (the warm-up's, k < 0,
        too)."""
        return torch.tensor(draws.episode_x0s(self.cfg, self.seed, k,
                                              self.lanes), **self.fx)

    def setup(self) -> None:
        from gpmpc_tpu_torch.envs import pendulum
        from gpmpc_tpu_torch.gp import state as gp_state
        from gpmpc_tpu_torch.mpc.cost import CostParams
        from gpmpc_tpu_torch.parallel import batch
        cfg = self.cfg
        ds, da = cfg['state_dim'], cfg['action_dim']
        s, a, ns = draws.pendulum_pretrain(cfg, self.dev)
        self.pretrain = (torch.cat([s, a], 1).to(self.fx['dtype']),
                         (ns - s).to(self.fx['dtype']))
        gp = gp_state.make_gp(
            gp_state.GPConfig(capacity=cfg['capacity'], x_dim=ds + da,
                              out_dim=ds),
            self.pretrain[0].cpu().numpy(), self.pretrain[1].cpu().numpy(),
            **self.fx)
        self.gp = gp_state.set_hyperparams(gp, [cfg['lambdas']] * (ds + da),
                                           cfg['sigma_f'], cfg['sigma_n'])
        self.cost_params = CostParams(
            Q=float(cfg['Q_diag']) * torch.eye(ds, **self.fx),
            R=float(cfg['R_diag']) * torch.eye(da, **self.fx),
            gamma=torch.tensor(float(cfg['gamma']), **self.fx),
            x_ref=torch.zeros(ds, **self.fx),
            u_ref=torch.zeros(da, **self.fx))
        self.plant_params = pendulum.PendulumParams(**cfg['plant'])
        self._patched = (batch, batch.solve_batch_multistart)
        batch.solve_batch_multistart = self._recorded
        for k in range(-int(self.wl.get('warmup_episodes', 1)), 0):
            self.unit(k, steps=int(self.wl['warmup_steps']))

    def solve(self, *args, **kw):
        """The program's multistart solve of a step."""
        return self._patched[1](*args, **kw)

    def _recorded(self, *args, **kw):
        res = self.solve(*args, **kw)
        if self.plans is not None:
            self.plans.append(res.u.detach().clone())
        return res

    def plant(self, st, u):
        """The program's plant (gpmpc_tpu_torch/envs/pendulum.py)."""
        from gpmpc_tpu_torch.envs import pendulum
        return pendulum.step(st, u, self.plant_params)

    def unit(self, k: int, steps: int = 0) -> dict:
        """Episode k of `steps` (the configuration's) steps; its record."""
        from gpmpc_tpu_torch.mpc.solver import SolverConfig
        from gpmpc_tpu_torch.sim import simulator
        cfg = self.cfg
        steps = steps or self.steps
        x0 = self.x0s(k)
        self.plans = []
        try:
            gp_f, outs = simulator.run_episode_on_device(
                self.gp, self.plant, x0, self.cost_params,
                horizon=cfg['horizon'], num_steps=steps, lb=cfg['lb'],
                ub=cfg['ub'], solver=SolverConfig(**cfg['solver']),
                delta_dynamics=cfg['delta_dynamics'],
                solver_recipe=cfg['solver_recipe'], n_starts=cfg['n_starts'])
            plans = torch.stack(self.plans, 1)
        finally:
            self.plans = None
        return dict(k=k, lanes=self.lanes, steps=steps, x0=x0,
                    state=outs['state'], action=outs['action'],
                    cost=outs['cost'], iters=outs['iters'], plans=plans,
                    first=plans[:, :, 0].clone(), count=gp_f.count.clone(),
                    host_reads=int(simulator.LAST_EPISODE.get(
                        'host_reads_after_first', 0)))

    def traced(self, k: int) -> dict:
        """The profiled unit: an episode of the cell's profile_steps (one:
        a later step replays the step's capture, which cannot hold the
        host-read loop's reads)."""
        return self.unit(k, steps=int(self.wl['profile_steps']))

    def release(self) -> None:
        from gpmpc_tpu_torch.mpc import solver
        self.restore()
        solver.clear_programs()
        self.gp = None

    def restore(self) -> None:
        if self._patched is not None:
            mod, fn = self._patched
            mod.solve_batch_multistart = fn
            self._patched = None

    def work(self, records: list) -> int:
        """Lane-steps: every lane's control steps of every episode."""
        return sum(r['lanes'] * r['steps'] for r in records)

    # -- the judgement --------------------------------------------------
    def inputs(self, rec: dict) -> dict:
        """The reference's view of an episode: the state each step was
        solved from, the applied actions, the reference plant's next states
        and the appended GP data, in f64."""
        xs = torch.cat([rec['x0'][:, None], rec['state'][:, :-1]], 1)
        xs, act = xs.double(), rec['action'].double()
        nxt = ref_plant.step(self.cfg['plant'], xs, act)
        return dict(xs=xs, act=act, nxt=nxt,
                    gp_x=torch.cat([xs, act], 2), gp_y=nxt - xs)

    def gp_at(self, view: dict, t: int, idx) -> ref.GP:
        """The lanes' GPs the solve of step t used, refitted by the
        reference: the pretrain data and the transitions of steps < t."""
        cfg = self.cfg
        px, py = self.pretrain
        n = len(idx)
        x = torch.cat([px.double().expand(n, -1, -1),
                       view['gp_x'][idx, :t]], 1)
        y = torch.cat([py.double().expand(n, -1, -1),
                       view['gp_y'][idx, :t]], 1)
        return ref.fit(x, y, cfg['lambdas'], cfg['sigma_f'], cfg['sigma_n'])

    def lane_numbers(self, records: list) -> dict:
        cfg, wl = self.cfg, self.wl
        h = ref.headline(cfg, self.dev)
        gamma = torch.full((self.lanes,), float(cfg['gamma']),
                           dtype=ref.F64, device=self.dev)
        n_pre = self.pretrain[0].shape[0]
        gaps, pgs, bad = [], [], []
        for rec in records:
            view = self.inputs(rec)
            plans, state = rec['plans'], rec['state']
            finite = (torch.isfinite(plans).flatten(2).all(2)
                      & torch.isfinite(state).all(2)
                      & torch.isfinite(rec['cost']))
            inside = ((plans >= h.lb) & (plans <= h.ub)).flatten(2).all(2)
            applied = (rec['action'] == rec['first']).all(2)
            plant_ok = ((view['nxt'] - state.double()).abs().amax(2)
                        <= float(wl['plant_tol']))
            ok = finite & inside & applied & plant_ok
            ok[:, -1] &= rec['count'] == n_pre + rec['steps']
            gap = torch.empty_like(view['xs'][..., 0])
            pg = torch.empty_like(gap)
            for t in range(rec['steps']):
                for b0 in range(0, self.lanes, BLOCK):
                    idx = torch.arange(b0, min(b0 + BLOCK, self.lanes),
                                       device=self.dev)
                    j, r = ref.judge(self.gp_at(view, t, idx), h,
                                     view['xs'][idx, t], plans[idx, t],
                                     gamma[idx])
                    c = rec['cost'][idx, t].double()
                    gap[idx, t] = ((c - j).abs() / (1.0 + j.abs()))
                    pg[idx, t] = r
            gap, pg = gap.nan_to_num(nan=float('inf')), pg.nan_to_num(
                nan=float('inf'))
            gaps.append(gap.flatten())
            pgs.append(pg.flatten())
            bad.append((~ok | (gap > float(wl['cost_off']))).flatten())
        return dict(cost_gap=torch.cat(gaps), pg=torch.cat(pgs),
                    bad=torch.cat(bad))

    def check(self, records: list) -> dict:
        numbers, self.diagnostics = judge.numbers(
            self.lane_numbers(records), self.wl)
        return numbers
