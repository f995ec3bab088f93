"""Continuous cartpole with a pretrained GP dynamics model
(port of gpmpc_tpu/experiments/pretrain_cartpole.py).

300 random transitions; --mode delta (the default): delta-dynamics targets
and hyperparameters trained for 150 iterations (untied: K2 on a card, four
outputs), gamma 0, H 5, force in [-1, 1]; --mode reference: raw targets,
lengthscales 2, sigma_n 1e-5, gamma -1. The transitions come from a
torch.Generator seeded by `seed`.

Run: python -m gpmpc_tpu_torch.experiments.pretrain_cartpole
[--mode delta|reference] [--num-iters N] [--device cpu]
"""

import argparse

import numpy as np


def make_controller(mode: str = 'delta', num_train: int = 300,
                    horizon: int = 5, gamma: float = 0.0, seed: int = 0,
                    train_iters: int = 150, device=None):
    """(mpc, env, params): the controller loaded with `num_train`
    transitions (and, in delta mode, trained for `train_iters` iterations
    unless that is 0) and the env seeded by `seed`."""
    import torch

    from gpmpc_tpu_torch.device import resolve_device
    from gpmpc_tpu_torch.envs.cartpole import (CartPoleEnv, CartPoleParams,
                                               sample_transitions)
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.solver import SolverConfig

    dev = resolve_device(device)
    params = CartPoleParams()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    states, actions, next_states = sample_transitions(gen, num_train, params,
                                                      device=dev)
    delta = mode == 'delta'
    mpc = RiskSensitiveMPC(
        gamma=(gamma if delta else -1.0), horizon=horizon,
        state_dim=4, input_dim=1, Q=2 * np.eye(4), R=0.01 * np.eye(1),
        capacity=512, delta_dynamics=delta,
        solver=SolverConfig(max_iters=150, tol=1e-4), device=dev)
    mpc.set_ub([1.0])
    mpc.set_lb([-1.0])
    if delta:
        mpc.set_gp_hyperparams(lambdas=[2.0] * 5, sigma_f=1.0, sigma_n=1e-2)
        mpc.dynamics.append_train_data(states, actions, next_states)
        if train_iters:
            mpc.train_gp(num_iters=train_iters)
    else:
        mpc.set_gp_hyperparams(lambdas=[2.0] * 5, sigma_n=1e-5)
        mpc.dynamics.append_train_data(states, actions, next_states)
    return mpc, CartPoleEnv(params=params, seed=seed, device=dev), params


def cartpole_experiment(mode: str = 'delta', num_iters: int = 50,
                        num_train: int = 300, horizon: int = 5,
                        gamma: float = 0.0, seed: int = 0,
                        verbose: bool = True, device=None):
    from gpmpc_tpu_torch.sim.simulator import Simulator
    mpc, env, _ = make_controller(mode, num_train, horizon, gamma, seed,
                                  device=device)
    log = Simulator(mpc, env, num_iters=num_iters).run()
    if verbose:
        print('final state:', np.round(log.states[-1], 4))
        print('|x| max:', round(float(np.max(np.abs(log.states[:, 0]))), 3),
              '|theta| max:', round(float(np.max(np.abs(log.states[:, 2]))), 3))
        print('mean warm solve time: %.3fs'
              % float(np.mean(log.solve_times[3:])))
    return log


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--mode', choices=['delta', 'reference'], default='delta')
    ap.add_argument('--num-iters', type=int, default=50)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    cartpole_experiment(mode=args.mode, num_iters=args.num_iters,
                        device=args.device)


if __name__ == '__main__':
    main()
