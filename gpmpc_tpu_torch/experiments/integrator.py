"""Known-answer experiment: the 1-D integrator f(s, a) = s + a
(port of gpmpc_tpu/experiments/integrator.py).

A GP learns 100 random (s, a, s + a) transitions (lengthscales 2, sigma_f 3,
sigma_n 1e-5), gamma = 1e-5, H = 5, a in [-1, 1], x0 = 5, in f64: the
optimal trajectory is u* = [-1] * 5. The solve takes the controller's B = 1
batched route, through K1 on a card.

Run: python -m gpmpc_tpu_torch.experiments.integrator [--device cpu]
"""

import argparse

import numpy as np


def integrator_experiment(seed: int = 0, verbose: bool = True, device=None):
    import torch

    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.solver import SolverConfig

    rng = np.random.default_rng(seed)
    state = rng.uniform(-10, 10, (100, 1))
    action = rng.uniform(-1, 1, (100, 1))
    next_state = state + action

    mpc = RiskSensitiveMPC(gamma=1e-5, horizon=5, state_dim=1, input_dim=1,
                           Q=2 * np.eye(1), R=np.zeros((1, 1)),
                           R_delta=np.zeros((1, 1)), capacity=128,
                           dtype=torch.float64, device=device,
                           solver=SolverConfig(max_iters=300, tol=1e-5,
                                               polish_iters=20))
    mpc.set_gp_hyperparams(lambdas=[2.0, 2.0], sigma_f=3.0, sigma_n=1e-5)
    mpc.dynamics.append_train_data(state, action, next_state)
    mpc.set_ub([1.0])
    mpc.set_lb([-1.0])
    mpc.set_xref([0.0])
    mpc.set_uref([0.0])

    u = mpc.get_optimal_trajectory(np.array([5.0]))
    err = float(np.max(np.abs(u.ravel() + 1.0)))
    if verbose:
        print('optimal trajectory:', u.ravel())
        print('expected [-1]*5, max deviation:', err)
        print('solver iters:', int(mpc.last_result.iters),
              'cost:', float(mpc.last_result.cost))
    return u, err


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    _, err = integrator_experiment(device=args.device)
    assert err < 5e-3, f'integrator known answer violated: {err}'
    print('PASS')


if __name__ == '__main__':
    main()
