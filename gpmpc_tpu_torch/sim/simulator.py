"""Receding-horizon simulation loops (port of gpmpc_tpu/sim/simulator.py).

`Simulator` is the host control loop with the reference's semantics: at each
step solve, apply the first action, step the plant, then append the observed
transition to the GP (online learning, which refits). It logs states,
actions, rewards, solve wall times, costs and solver iterations.

`run_episode_on_device` runs a whole episode with its carry on the GP's
device: the GP state, the state x, the previous action and the last
trajectory; the plant is a torch function and the GP append happens there,
with no numpy round trip. JAX's `lax.scan` is a Python loop here. Each
step's solve runs the solver's kept programs (mpc/solver.py), their loops on
the device: the append changes the GP's values, not its shapes, so every
step after the first replays the first step's programs. The append's f64
fit searches its jitter on the device too (gp/state.find_jitter), so no
step after the first reads the host on CUDA (the fit's 'eigh' backend
excepted: torch.linalg.eigh waits on the host).

Given x0 of shape (B, ds), it runs B episodes, JAX's
jit(vmap(run_episode_on_device)): one GP a lane, every step one batched
solve of all lanes, and the step's own work captured once as CUDA graphs
(`_StepProgram`) and replayed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.gp import state as gp_state
from gpmpc_tpu_torch.mpc.cost import CostParams
from gpmpc_tpu_torch.mpc.solver import (SolverConfig, first_lane,
                                        solve_trajectory_batched)
from gpmpc_tpu_torch.utils import replay_counts


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
                          solver_recipe: str = 'single', n_starts: int = 4,
                          sync_guard: Optional[Callable] = None):
    """A whole receding-horizon episode on the GP's device.

    plant_step: (state (ds,), action (da,)) -> (next_state, reward), torch.
    Returns (final GPState, {state, action, reward, cost, iters: stacked
    per-step tensors}). Each step solves from u = 0 by the single-scenario
    rollout (the lockstep solver of the configured method at B = 1 on
    `parallel.batch.lanes_objective`, through the kept program on CUDA,
    nominal models included), or with solver_recipe='multistart' (L-BFGS,
    diagonal covariance) by `solve_batch_multistart` with the shifted last
    trajectory as an extra start.

    x0 of shape (B, ds) runs B episodes at once, JAX's
    jit(vmap(run_episode_on_device)) (`_run_batched`): the outputs are
    (B, T, ...) and the GPState is stacked over the B lanes, each with its
    own data from its first append on. sync_guard, if given, is a context
    manager factory entered around every step after the first (e.g. one
    that sets torch.cuda.set_sync_debug_mode('error')). `LAST_EPISODE`
    holds the last call's seconds (wall, first step) and the host reads of
    its steps after the first (utils/replay_counts.HOST_READS)."""
    if x0.ndim == 2:
        return _run_batched(gp, plant_step, x0, params, horizon, num_steps,
                            lb, ub, solver, learn_online, full_cov,
                            delta_dynamics, solver_recipe, n_starts,
                            sync_guard)
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

    clock = _Clock(x0.device)
    gp_t, x = gp, x0
    u_prev = x0.new_zeros((da,))
    u_traj = x0.new_zeros((horizon, da))
    outs = {k: [] for k in ('state', 'action', 'reward', 'cost', 'iters')}
    for t in range(num_steps):
        with clock.step(t, sync_guard):
            u_warm = torch.cat([u_traj[1:], u_traj[-1:]], dim=0)
            result = mpc_solve(gp_t, x, u_prev, u_warm)
            action = result.u[0].detach()
            next_x, reward = plant_step(x, action)
            if learn_online:
                target = next_x - x if delta_dynamics else next_x
                gp_t = gp_state.append(gp_t, torch.cat([x, action]), target)
            for k, v in (('state', next_x), ('action', action),
                         ('reward', reward), ('cost', result.cost),
                         ('iters', result.iters)):
                outs[k].append(torch.as_tensor(v, device=x0.device))
            x, u_prev, u_traj = next_x, action, result.u.detach()
    clock.done()
    return gp_t, {k: torch.stack(v) for k, v in outs.items()}


# The last episode's seconds (wall, first step: the solve programs' and
# the step's captures included) and the host reads of its steps after the
# first (utils/replay_counts.HOST_READS).
LAST_EPISODE: dict = {}
# Set only inside `eager_steps()`.
_eager_steps = False


@contextlib.contextmanager
def eager_steps():
    """Batched episodes run in the block run every step's own work (plant,
    append, fit, outputs) from Python, as step 1 does, instead of replaying
    its capture: the reference the capture is held to."""
    global _eager_steps
    was, _eager_steps = _eager_steps, True
    try:
        yield
    finally:
        _eager_steps = was


class _Clock:
    """An episode's seconds and host reads, into LAST_EPISODE; steps after
    the first run inside the caller's sync_guard."""

    def __init__(self, device):
        self.device = device
        self.t0 = time.perf_counter()
        LAST_EPISODE.clear()

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def step(self, t: int, sync_guard):
        if t == 0 or sync_guard is None:
            yield
        else:
            with sync_guard():
                yield
        if t == 0:
            self._sync()
            LAST_EPISODE['first_step_s'] = time.perf_counter() - self.t0
            self.reads = replay_counts.HOST_READS

    def done(self):
        self._sync()
        LAST_EPISODE['wall_s'] = time.perf_counter() - self.t0
        LAST_EPISODE['host_reads_after_first'] = (
            replay_counts.HOST_READS - getattr(self, 'reads',
                                               replay_counts.HOST_READS))


class _StepProgram:
    """A batched episode's step work (plant, append, fit, the write of the
    outputs and the carry), captured once per call after step 1 ran it
    eagerly, and replayed for steps 2..T: the port's lax.scan body, beside
    the solve's kept programs. The fit's jitter search runs its own kept
    loop graph (gp/state.find_jitter), which a capture cannot launch: the
    capture is split there (gp_state._LAUNCH_HOOK), so the step is CUDA
    graphs with the search's loop launched between them, on one side
    stream, and reads nothing on the host. Each graph's kernel launches
    count once a replay (utils/replay_counts.Replays)."""

    def __init__(self, record, device):
        self.device = device
        self.side = torch.cuda.Stream(device=device)
        self.pool = torch.cuda.graph_pool_handle()
        self.parts = []
        self.side.wait_stream(torch.cuda.current_stream(device))
        torch.cuda.empty_cache()
        with torch.cuda.device(device), torch.cuda.stream(self.side):
            self._begin()
            gp_state._LAUNCH_HOOK = self._split
            try:
                record()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            finally:
                gp_state._LAUNCH_HOOK = None
            self._end()

    def _begin(self):
        self.before = replay_counts.snapshot()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.capture_begin(pool=self.pool)

    def _end(self):
        self.graph.capture_end()
        counts = replay_counts.Replays(
            self.before, replay_counts.snapshot(),
            replay_counts.graph_kernel_names(self.graph.raw_cuda_graph()))
        self.graph.instantiate()
        self.parts.append((self.graph, counts))

    def _split(self, search):
        self._end()
        self.parts.append((search, None))
        self._begin()

    def replay(self):
        main = torch.cuda.current_stream(self.device)
        self.side.wait_stream(main)
        with torch.cuda.device(self.device), torch.cuda.stream(self.side):
            for part, counts in self.parts:
                if counts is None:
                    part.launch()
                else:
                    part.replay()
                    counts.replayed()
        main.wait_stream(self.side)

    def release(self):
        self.side.synchronize()
        for part, counts in self.parts:
            if counts is not None:
                part.reset()
        self.parts = []


_GP_UPDATED = ('x', 'y', 'mask', 'count', 'kinv', 'beta', 'logdet',
               'jitter_used')


def _run_batched(gp, plant_step, x0, params, horizon, num_steps, lb, ub,
                 solver, learn_online, full_cov, delta_dynamics,
                 solver_recipe, n_starts, sync_guard):
    """B episodes from x0 (B, ds): JAX's vmap of the episode. Every lane
    carries its own GP (gp stacked over the lanes, from one GP copied to
    each lane), state, last action and trajectory. Each step solves all
    lanes at once: the 'single' route by `lanes_objective` on the lanes'
    caches (one lockstep solve, as solve_batch_gp), 'multistart' by
    `solve_batch_multistart` over the stacked GP (each lane's starts
    against its own GP, through K1's grouped form). The plant runs under
    torch.func.vmap; the outputs are written into (B, T, ...) buffers on
    the device. The carry lives in static tensors that each step updates in
    place, so that on CUDA the step's own work is captured once after step
    1 (`_StepProgram`) and replayed, the solve's programs kept as always: no
    step after the first reads the host."""
    from gpmpc_tpu_torch.parallel.batch import (lanes_objective,
                                                solve_batch_multistart,
                                                stack_gps)
    b, ds = x0.shape
    da = params.R.shape[0]
    dev, dt = x0.device, x0.dtype
    use_ms = (solver_recipe == 'multistart' and not full_cov
              and solver.method == 'lbfgs')
    clock = _Clock(dev)
    lb_t, ub_t = (torch.as_tensor(v, dtype=dt, device=dev) for v in (lb, ub))
    params = CostParams(*(None if v is None else torch.as_tensor(v, device=dev)
                          for v in params))
    gps = (stack_gps([gp] * b) if gp.x.ndim == 2 else dataclasses.replace(
        gp, **{name: getattr(gp, name).clone() for name in _GP_UPDATED}))
    vplant = torch.func.vmap(plant_step)
    carry = dict(x=x0.clone(), u_prev=x0.new_zeros((b, da)),
                 u_traj=x0.new_zeros((b, horizon, da)),
                 k=torch.zeros((), dtype=torch.long, device=dev))
    res = {}
    outs = {}

    def mpc_solve():
        p = (params._replace(u_prev=carry['u_prev'])
             if params.R_delta is not None else params)
        u_traj = carry['u_traj']
        if use_ms:
            u_warm = torch.cat([u_traj[:, 1:], u_traj[:, -1:]], dim=1)
            return solve_batch_multistart(
                gps, ds, da, carry['x'], p, horizon, lb_t, ub_t, solver,
                n_starts=n_starts, delta=delta_dynamics,
                extra_starts=u_warm[None])
        return solve_trajectory_batched(
            lanes_objective(build_rollout_cache(gps, ds, da), carry['x'], p,
                            delta_dynamics, full_cov),
            x0.new_zeros((b, horizon, da)), lb_t, ub_t, solver)

    def step_work():
        x = carry['x']
        action = res['u'][:, 0]
        next_x, reward = vplant(x, action)
        if learn_online:
            target = next_x - x if delta_dynamics else next_x
            new = gp_state.append(gps, torch.cat([x, action], dim=-1), target)
            for name in _GP_UPDATED:
                getattr(gps, name).copy_(getattr(new, name))
        at = carry['k'].reshape(1)
        for name, v in (('state', next_x), ('action', action),
                        ('reward', reward), ('cost', res['cost']),
                        ('iters', res['iters'])):
            outs[name].index_copy_(1, at, v[:, None].to(outs[name].dtype))
        carry['x'].copy_(next_x)
        carry['u_prev'].copy_(action)
        carry['u_traj'].copy_(res['u'])
        carry['k'].add_(1)

    program = None
    for t in range(num_steps):
        with clock.step(t, sync_guard):
            result = mpc_solve()
            if t == 0:
                res.update(u=result.u.clone(), cost=result.cost.clone(),
                           iters=result.iters.clone())
                outs.update(
                    state=x0.new_empty((b, num_steps, ds)),
                    action=x0.new_empty((b, num_steps, da)),
                    reward=x0.new_empty((b, num_steps)),
                    cost=result.cost.new_empty((b, num_steps)),
                    iters=result.iters.new_empty((b, num_steps)))
            else:
                for name in ('u', 'cost', 'iters'):
                    res[name].copy_(getattr(result, name))
            if program is not None:
                program.replay()
            else:
                step_work()
                if (t == 0 and num_steps > 1 and dev.type == 'cuda'
                        and not _eager_steps):
                    program = _StepProgram(step_work, dev)
    clock.done()
    if program is not None:
        program.release()
    return gps, outs
