"""Receding-horizon simulation loops (port of gpmpc_tpu/sim/simulator.py).

`Simulator` is the host control loop with the reference's semantics: at each
step solve, apply the first action, step the plant, then append the observed
transition to the GP (online learning, which refits). It logs states,
actions, rewards, solve wall times, costs and solver iterations.

`run_episode_on_device` runs a whole episode with its carry on the GP's
device: the GP state, the state x, the previous action and the last
trajectory; the plant is a torch function and the GP append happens there,
with no numpy round trip. JAX's `lax.scan` is a Python loop here. Each
step's solve runs the solver's kept program (mpc/solver.py), its loop on
the device, with no host read inside the solve: the append changes the
GP's values, not its shapes, so every step after the first replays the
first step's program. Between solves the host still reads: the append's
f64 fit searches its jitter on the host (gp/state.py), and the
multistart recipe reads between its phases.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.gp import state as gp_state
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import (SolverConfig, first_lane,
                                        solve_trajectory_batched)


class EpisodeLog(NamedTuple):
    states: np.ndarray       # (T+1, ds)
    actions: np.ndarray      # (T, da)
    rewards: np.ndarray      # (T,)
    solve_times: np.ndarray  # (T,) wall-clock seconds per solve
    costs: np.ndarray        # (T,) objective at the returned trajectory
    iters: np.ndarray        # (T,) solver iterations


class Simulator:
    """Host control loop. `env` needs reset()/step()/close(); `mpc` is a
    gpmpc_tpu_torch RiskSensitiveMPC. Episode recording: pass `renderer` (a
    frame function of sim/render.py, e.g. pendulum_renderer(params)) and
    `video_path` ('.gif'); each step's state and action are captured, the
    last state too, and the episode is written when the run ends. The
    recorder is `self.recorder` (None without a renderer)."""

    def __init__(self, mpc, env, num_iters: int = 500,
                 learn_online: bool = True, renderer=None,
                 video_path: Optional[str] = None, fps: int = 20):
        self.mpc = mpc
        self.env = env
        self.num_iters = num_iters
        self.learn_online = learn_online
        self.recorder = None
        self.video_path = video_path
        if renderer is not None:
            from gpmpc_tpu_torch.sim.render import EpisodeRecorder
            self.recorder = EpisodeRecorder(renderer, fps=fps)

    def run(self) -> EpisodeLog:
        obs, _ = self.env.reset()
        states, actions, rewards, solve_times, costs, iters = \
            [np.asarray(obs)], [], [], [], [], []
        for _ in range(self.num_iters):
            t0 = time.perf_counter()
            traj = self.mpc.get_optimal_trajectory(obs)
            solve_times.append(time.perf_counter() - t0)
            action = traj[0, :]
            if self.recorder is not None:
                self.recorder.capture(obs, action)
            next_obs, reward, terminated, truncated, _ = self.env.step(action)
            res = self.mpc.last_result
            costs.append(float(res.cost) if res is not None else np.nan)
            iters.append(int(res.iters) if res is not None else 0)
            actions.append(action)
            rewards.append(reward)
            states.append(np.asarray(next_obs))
            if terminated or truncated:
                break
            if self.learn_online:
                self.mpc.dynamics.append_train_data(obs, action, next_obs)
            obs = next_obs
        if self.recorder is not None:
            self.recorder.capture(obs)
            if self.video_path is not None:
                self.recorder.save(self.video_path)
        self.env.close()
        return EpisodeLog(states=np.asarray(states), actions=np.asarray(actions),
                          rewards=np.asarray(rewards),
                          solve_times=np.asarray(solve_times),
                          costs=np.asarray(costs), iters=np.asarray(iters))


def run_episode_on_device(gp: gp_state.GPState, plant_step: Callable,
                          x0: torch.Tensor, params: CostParams, horizon: int,
                          num_steps: int, lb, ub,
                          solver: SolverConfig = SolverConfig(),
                          learn_online: bool = True, full_cov: bool = False,
                          delta_dynamics: bool = False,
                          solver_recipe: str = 'single', n_starts: int = 4):
    """A whole receding-horizon episode on the GP's device.

    plant_step: (state (ds,), action (da,)) -> (next_state, reward), torch.
    Returns (final GPState, {state, action, reward, cost, iters: stacked
    per-step tensors}). Each step solves from u = 0 by the single-scenario
    rollout (the lockstep solver of the configured method at B = 1 on
    `parallel.batch.lanes_objective`, through the kept program on CUDA,
    nominal models included), or with solver_recipe='multistart' (L-BFGS,
    diagonal covariance) by `solve_batch_multistart` with the shifted last
    trajectory as an extra start."""
    ds = params.Q.shape[0]
    da = params.R.shape[0]
    use_ms = (solver_recipe == 'multistart' and not full_cov
              and solver.method == 'lbfgs')

    def mpc_solve(gp_t, x, u_prev, u_warm):
        p = params._replace(u_prev=u_prev) if params.R_delta is not None else params
        if use_ms:
            from gpmpc_tpu_torch.parallel.batch import solve_batch_multistart
            if p.R_delta is not None:
                p = p._replace(u_prev=p.u_prev[None])
            res = solve_batch_multistart(gp_t, ds, da, x[None], p, horizon,
                                         lb, ub, solver, n_starts=n_starts,
                                         delta=delta_dynamics,
                                         extra_starts=u_warm[None, None])
            return first_lane(res)
        from gpmpc_tpu_torch.parallel.batch import lanes_objective
        return first_lane(solve_trajectory_batched(
            lanes_objective(build_rollout_cache(gp_t, ds, da), x[None], p,
                            delta_dynamics, full_cov),
            x.new_zeros((1, horizon, da)), lb, ub, solver))

    gp_t, x = gp, x0
    u_prev = x0.new_zeros((da,))
    u_traj = x0.new_zeros((horizon, da))
    outs = {k: [] for k in ('state', 'action', 'reward', 'cost', 'iters')}
    for _ in range(num_steps):
        u_warm = torch.cat([u_traj[1:], u_traj[-1:]], dim=0)
        result = mpc_solve(gp_t, x, u_prev, u_warm)
        action = result.u[0].detach()
        next_x, reward = plant_step(x, action)
        if learn_online:
            target = next_x - x if delta_dynamics else next_x
            gp_t = gp_state.append(gp_t, torch.cat([x, action]), target)
        for k, v in (('state', next_x), ('action', action), ('reward', reward),
                     ('cost', result.cost), ('iters', result.iters)):
            outs[k].append(torch.as_tensor(v, device=x0.device))
        x, u_prev, u_traj = next_x, action, result.u.detach()
    return gp_t, {k: torch.stack(v) for k, v in outs.items()}
