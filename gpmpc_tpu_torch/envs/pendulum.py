"""Adjustable pendulum plant: a pure torch stepper and a host-side env
wrapper (port of gpmpc_tpu/envs/pendulum.py).

  u       <- clip(u, -max_torque, max_torque)
  thdot'  <- clip(thdot + (3 g / (2 l) sin th + 3 / (m l^2) u) dt, +-max_speed)
  th'     <- th + thdot' dt
  reward   = -(angle_norm(th)^2 + 0.1 thdot^2 + 0.001 u^2)

Observations are the raw (theta, theta_dot). `step` works on the device and
dtype of its inputs (batched over a leading axis by `step_batch`), so a whole
episode can stay on the card (sim.simulator.run_episode_on_device).
`PendulumEnv` steps in f32 and returns f64, as the JAX env does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device


class PendulumParams(NamedTuple):
    g: float = 10.0
    m: float = 1.0
    l: float = 1.0
    dt: float = 0.05
    max_speed: float = 8.0
    max_torque: float = 2.0


DEFAULT_TH = np.pi
DEFAULT_THDOT = 1.0


def angle_normalize(x):
    """Wrap to [-pi, pi)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def step(state: torch.Tensor, u: torch.Tensor,
         params: PendulumParams = PendulumParams()):
    """(state (2,), u (1,) or ()) -> (next_state (2,), reward ())."""
    th, thdot = state[..., 0], state[..., 1]
    u = torch.clamp(torch.as_tensor(u, dtype=state.dtype,
                                    device=state.device).reshape(th.shape),
                    -params.max_torque, params.max_torque)
    cost = angle_normalize(th) ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
    newthdot = thdot + (3.0 * params.g / (2.0 * params.l) * torch.sin(th)
                        + 3.0 / (params.m * params.l ** 2) * u) * params.dt
    newthdot = torch.clamp(newthdot, -params.max_speed, params.max_speed)
    newth = th + newthdot * params.dt
    return torch.stack([newth, newthdot], dim=-1), -cost


def step_batch(states, actions, params: PendulumParams = PendulumParams()):
    """states (n, 2), actions (n, 1) -> (next_states (n, 2), rewards (n,))."""
    return step(states, actions[:, 0], params)


def sample_transitions(gen: torch.Generator, n: int,
                       params: PendulumParams = PendulumParams(),
                       th_range=(0.0, np.pi), dtype=torch.float32,
                       device=None):
    """n random (state, action, next_state) transitions drawn from `gen`
    (a torch.Generator on `device`): theta over th_range, theta_dot over
    +-max_speed, actions over +-max_torque."""
    dev = resolve_device(device)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype,
                                           device=dev)

    th = uniform((n,), *th_range)
    thdot = uniform((n,), -params.max_speed, params.max_speed)
    actions = uniform((n, 1), -params.max_torque, params.max_torque)
    states = torch.stack([th, thdot], dim=1)
    next_states, _ = step_batch(states, actions, params)
    return states, actions, next_states


class PendulumEnv:
    """Stateful reset/step wrapper with the gym-like surface the Simulator
    drives. Steps the plant in f32 on `device` and returns numpy f64."""

    def __init__(self, params: PendulumParams = PendulumParams(),
                 init_state: Optional[dict] = None, seed: Optional[int] = None,
                 device=None):
        self.params = params
        self.init_state = init_state
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self.state = np.zeros(2)

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        if self.init_state is None:
            high = np.array([DEFAULT_TH, DEFAULT_THDOT])
            self.state = self._rng.uniform(-high, high)
        else:
            th = self.init_state.get('th_init', DEFAULT_TH)
            thdot = self.init_state.get('thdot_init', DEFAULT_THDOT)
            self.state = np.array([th, thdot], np.float64)
        return self.state.copy(), {}

    def step(self, action):
        f32 = torch.float32
        next_state, reward = step(
            torch.tensor(self.state, dtype=f32, device=self.device),
            torch.tensor(np.asarray(action), dtype=f32, device=self.device),
            self.params)
        self.state = next_state.cpu().numpy().astype(np.float64)
        return self.state.copy(), float(reward), False, False, {}

    def close(self):
        pass
