"""Continuous-action cartpole plant: a pure torch stepper and a host-side
env wrapper (port of gpmpc_tpu/envs/cartpole.py). Euler steps of the
classic cartpole equations; the action in [-1, 1] is scaled by 30 N; the
episode never terminates. State: (x, x_dot, theta, theta_dot).
`CartPoleEnv` steps in f32 and returns f64, as the JAX env does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device


class CartPoleParams(NamedTuple):
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5        # half the pole length
    force_mag: float = 30.0
    tau: float = 0.02


def step_physics(state: torch.Tensor, force,
                 params: CartPoleParams = CartPoleParams()) -> torch.Tensor:
    """(state (..., 4), force (...) in newtons) -> next_state (..., 4)."""
    x, x_dot, theta, theta_dot = (state[..., i] for i in range(4))
    force = torch.as_tensor(force, dtype=state.dtype, device=state.device)
    total_mass = params.masscart + params.masspole
    polemass_length = params.masspole * params.length
    costheta = torch.cos(theta)
    sintheta = torch.sin(theta)
    temp = (force + polemass_length * theta_dot ** 2 * sintheta) / total_mass
    thetaacc = (params.gravity * sintheta - costheta * temp) / (
        params.length * (4.0 / 3.0 - params.masspole * costheta ** 2 / total_mass))
    xacc = temp - polemass_length * thetaacc * costheta / total_mass
    return torch.stack([x + params.tau * x_dot, x_dot + params.tau * xacc,
                        theta + params.tau * theta_dot,
                        theta_dot + params.tau * thetaacc], dim=-1)


def step(state: torch.Tensor, action, params: CartPoleParams = CartPoleParams()):
    """Action in [-1, 1] (shape (1,) or ()); returns (next_state, reward 1)."""
    force = params.force_mag * torch.as_tensor(
        action, dtype=state.dtype, device=state.device).reshape(state.shape[:-1])
    return (step_physics(state, force, params),
            torch.ones(state.shape[:-1], dtype=state.dtype, device=state.device))


def step_batch(states, actions, params: CartPoleParams = CartPoleParams()):
    """states (n, 4), actions (n, 1) -> (next_states (n, 4), rewards (n,))."""
    return step(states, actions[:, 0], params)


def sample_transitions(gen: torch.Generator, n: int,
                       params: CartPoleParams = CartPoleParams(),
                       dtype=torch.float32, device=None):
    """n random transitions drawn from `gen` (a torch.Generator on `device`)
    over x in +-2.4, x_dot in +-2, theta in +-pi/4, theta_dot in +-2 and
    actions in [-1, 1]."""
    dev = resolve_device(device)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype,
                                           device=dev)

    states = torch.stack([uniform((n,), -2.4, 2.4), uniform((n,), -2.0, 2.0),
                          uniform((n,), -math.pi / 4, math.pi / 4),
                          uniform((n,), -2.0, 2.0)], dim=1)
    actions = uniform((n, 1), -1.0, 1.0)
    next_states, _ = step_batch(states, actions, params)
    return states, actions, next_states


class CartPoleEnv:
    """Stateful reset/step wrapper; steps in f32 on `device`, returns numpy
    f64."""

    def __init__(self, params: CartPoleParams = CartPoleParams(),
                 seed: Optional[int] = None, device=None):
        self.params = params
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self.state = np.zeros(4)

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(-0.2, 0.2, size=4)
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
