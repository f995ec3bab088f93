"""Learn-from-scratch online GP-MPC on the pendulum
(port of gpmpc_tpu/experiments/pendulum.py).

No pretraining: the controller starts with an empty GP (zero actions until
the first transition arrives) and learns online from every step; gamma = 1,
H = 10, Q = 2I, R = 2, R_delta = 1, max_torque = 2. The default
hyperparameters tie the lengthscales, so the solves run K1 on a card.

Run: python -m gpmpc_tpu_torch.experiments.pendulum [--num-iters N]
[--device cpu]
"""

import argparse

import numpy as np


def pendulum_experiment(num_iters: int = 10, verbose: bool = True,
                        device=None):
    from gpmpc_tpu_torch.envs.pendulum import PendulumEnv, PendulumParams
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.sim.simulator import Simulator

    params = PendulumParams(g=10.0, max_speed=8.0, max_torque=2.0)
    env = PendulumEnv(params=params, device=device,
                      init_state={'th_init': 1.1 * np.pi, 'thdot_init': 2.0})
    mpc = RiskSensitiveMPC(gamma=1.0, horizon=10, state_dim=2, input_dim=1,
                           Q=2 * np.eye(2), R=2 * np.eye(1),
                           R_delta=np.eye(1), capacity=max(64, num_iters + 8),
                           solver=SolverConfig(max_iters=150, tol=1e-4),
                           device=device)
    mpc.set_ub([params.max_torque])
    mpc.set_lb([-params.max_torque])

    log = Simulator(mpc, env, num_iters=num_iters).run()
    if verbose:
        print('states:\n', np.round(log.states, 3))
        print('actions:', np.round(log.actions.ravel(), 3))
        print('GP training points accumulated:', int(mpc.gp.count))
    return log


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--num-iters', type=int, default=10)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    pendulum_experiment(num_iters=args.num_iters, device=args.device)


if __name__ == '__main__':
    main()
