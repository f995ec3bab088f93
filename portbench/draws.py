"""The inputs every cell makes from --seed, handed to the program and to
the reference alike.

`headline_data` is a frozen copy of the headline problem's draw
(gpmpc_tpu_torch/problems.py:82-108, after benchmarks/problems.py:33-66):
uniform states over [-pi, pi]^ds and actions over [-5, 5]^da, stepped by
the pendulum-like map next = s + dt [omega, 15 sin(theta) + 3 a], then the
x0s uniform over [-1, 1]^ds and gamma swept linearly. The GP data are the configuration's fixed draws
(the headline's numpy seed, or the GP-draw seeds), so that every run solves
the same problem; the run's --seed draws the order of the configuration's
fixed pool of x0 batches and of the GP draws over the lanes, so that every
seed offers the same work in another order.

`pendulum_pretrain` is a frozen copy of the episode's pretrain draw
(chip_smoke.py:5060-5082, `episode_problem`, through
gpmpc_tpu_torch/envs/pendulum.py:64-82, `sample_transitions`): n
transitions drawn on the device by a torch.Generator seeded with the
configuration's data seed, theta over [0, pi], theta_dot over +-max_speed,
actions over +-max_torque, in f32, stepped by the plant. `episode_x0s`
draws each episode's initial states from the run's seed (chip_smoke's
[1.0, 0.5] +- 0.5).
"""

from __future__ import annotations

import math

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """numpy's generator for (seed, *stream): the seed may pass 2**32, a
    stream index may be negative."""
    return np.random.default_rng([int(seed) % 2 ** 64,
                                  *(int(s) % 2 ** 32 for s in stream)])


def headline_data(cfg: dict, gen: np.random.Generator):
    """(x (n, ds + da), next_states (n, ds)) in f64: the headline GP's
    training data (cfg: the configuration's `data` and dims)."""
    ds, da, n = cfg['state_dim'], cfg['action_dim'], cfg['n_train']
    data = cfg['data']
    states = gen.uniform(-data['state_bound'], data['state_bound'], (n, ds))
    actions = gen.uniform(-data['action_bound'], data['action_bound'],
                          (n, da))
    next_states = states + data['dt'] * np.concatenate(
        [states[:, 1:], data['gravity_gain'] * np.sin(states[:, :1])
         + data['action_gain'] * actions], axis=1)
    return np.concatenate([states, actions], axis=1), next_states


def gammas(cfg: dict, lanes: int) -> np.ndarray:
    """The gamma sweep over the lanes."""
    lo, hi = cfg['gamma_range']
    return np.linspace(lo, hi, lanes)


def draw_order(seed: int, n: int) -> np.ndarray:
    """The order of n GP draws over the lanes, drawn from (seed, 3)."""
    return rng(seed, 3).permutation(n)


def pendulum_pretrain(cfg: dict, device):
    """(states (n, 2), actions (n, 1), next states (n, 2)), f32 on the
    device: the episode GP's pretrain transitions (module docstring)."""
    import torch
    from portbench.reference.pendulum import step
    plant, n = cfg['plant'], cfg['n_pretrain']
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg['data_seed']))

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           dtype=torch.float32, device=device)

    th = uniform((n,), 0.0, math.pi)
    thdot = uniform((n,), -plant['max_speed'], plant['max_speed'])
    actions = uniform((n, 1), -plant['max_torque'], plant['max_torque'])
    states = torch.stack([th, thdot], dim=1)
    return states, actions, step(plant, states, actions)


def episode_x0s(cfg: dict, seed: int, k: int, lanes: int) -> np.ndarray:
    """(lanes, ds) initial states of episode k, drawn from (seed, 4, k)."""
    half = cfg['x0_halfwidth']
    return (np.asarray(cfg['x0_center'])
            + rng(seed, 4, k).uniform(-half, half, (lanes, cfg['state_dim'])))
