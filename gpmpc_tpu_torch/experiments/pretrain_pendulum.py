"""Pendulum swing-up with a pretrained GP dynamics model
(port of gpmpc_tpu/experiments/pretrain_pendulum.py).

300 random transitions from the plant, then an online-learning episode.
--mode delta (the default): delta-dynamics targets, hyperparameters trained
from lengthscales 2, sigma_f 1, sigma_n 1e-2 for 150 iterations (which
unties the lengthscales: the solves run K2 on a card), gamma 0, H 8, and
the multistart recipe with 4 starts at every control step. --mode reference:
raw next-state targets, hand-set lengthscales 2 and sigma_n 1e-5 (tied:
K1), gamma -1. The transitions come from a torch.Generator seeded by
`seed`; they cannot match the JAX package's PRNGKey draws.

Run: python -m gpmpc_tpu_torch.experiments.pretrain_pendulum
[--mode delta|reference] [--num-iters N] [--device cpu]
"""

import argparse

import numpy as np


def make_controller(mode: str = 'delta', num_train: int = 300,
                    horizon: int = 8, gamma: float = 0.0, seed: int = 0,
                    train_iters: int = 150, device=None, verbose=False):
    """(mpc, env, params): the controller loaded with `num_train`
    transitions (and, in delta mode, trained for `train_iters` iterations
    unless that is 0) and the env at (theta, theta_dot) = (1, 0.5)."""
    import torch

    from gpmpc_tpu_torch.device import resolve_device
    from gpmpc_tpu_torch.envs.pendulum import (PendulumEnv, PendulumParams,
                                               sample_transitions)
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.solver import SolverConfig

    dev = resolve_device(device)
    params = PendulumParams(g=10.0, max_torque=5.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    states, actions, next_states = sample_transitions(gen, num_train, params,
                                                      device=dev)
    delta = mode == 'delta'
    mpc = RiskSensitiveMPC(
        gamma=(gamma if delta else -1.0), horizon=horizon,
        state_dim=2, input_dim=1,
        Q=2 * np.eye(2), R=0.01 * np.eye(1), R_delta=0.01 * np.eye(1),
        capacity=512, delta_dynamics=delta,
        solver=SolverConfig(max_iters=150, tol=1e-4),
        solver_recipe='multistart', n_starts=4, device=dev)
    mpc.set_ub([params.max_torque])
    mpc.set_lb([-params.max_torque])
    if delta:
        mpc.set_gp_hyperparams(lambdas=[2.0, 2.0, 2.0], sigma_f=1.0,
                               sigma_n=1e-2)
        mpc.dynamics.append_train_data(states, actions, next_states)
        if train_iters:
            mpc.train_gp(num_iters=train_iters)
        if verbose:
            print('trained hyperparams: lambdas=',
                  np.round(mpc.gp.lambdas.cpu().numpy(), 2),
                  'sigma_n=', mpc.gp.sigma_n.cpu().numpy())
    else:
        mpc.set_gp_hyperparams(lambdas=[2.0, 2.0, 2.0], sigma_n=1e-5)
        mpc.dynamics.append_train_data(states, actions, next_states)
    env = PendulumEnv(params=params, device=dev,
                      init_state={'th_init': 1.0, 'thdot_init': 0.5})
    return mpc, env, params


def pendulum_experiment(mode: str = 'delta', num_iters: int = 100,
                        num_train: int = 300, horizon: int = 8,
                        gamma: float = 0.0, seed: int = 0,
                        verbose: bool = True, device=None):
    from gpmpc_tpu_torch.sim.simulator import Simulator
    mpc, env, _ = make_controller(mode, num_train, horizon, gamma, seed,
                                  device=device, verbose=verbose)
    log = Simulator(mpc, env, num_iters=num_iters).run()
    if verbose:
        print('theta trajectory (every 10):', np.round(log.states[::10, 0], 3))
        print('final state:', np.round(log.states[-1], 4))
        print('total reward:', round(float(np.sum(log.rewards)), 1))
        print('mean warm solve time: %.3fs'
              % float(np.mean(log.solve_times[3:])))
    return log


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--mode', choices=['delta', 'reference'], default='delta')
    ap.add_argument('--num-iters', type=int, default=100)
    ap.add_argument('--horizon', type=int, default=8)
    ap.add_argument('--gamma', type=float, default=0.0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    pendulum_experiment(mode=args.mode, num_iters=args.num_iters,
                        horizon=args.horizon, gamma=args.gamma,
                        device=args.device)


if __name__ == '__main__':
    main()
