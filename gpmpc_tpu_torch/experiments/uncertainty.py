"""Risk-sensitivity gamma sweep on a 2-D integrator (port of
gpmpc_tpu/experiments/uncertainty.py).

f(s, a) = s + a with a 2-D state and a 2-D action in [-1, 1]^2. The training
data cover an L-shaped region (two boxes of 200 points). From x0 = (4, -4)
with the set point at the origin, a risk-averse controller (gamma < 0) keeps
to the L-shaped corridor of data while a risk-neutral one cuts the corner
through the region without data. The controller: 400 points in capacity
512, untrained tied lengthscales 0.5, sigma_n = 1e-5, H = 6, f64; its B = 1
solves take the batched route through K1 on a card, at (B, N, d, E) =
(1, 512, 4, 2).

Run: python -m gpmpc_tpu_torch.experiments.uncertainty [--device cpu]
[--out-dir DIR]. It writes DIR/gamma_sweep.npz and, where matplotlib is
installed, one figure per gamma.
"""

import argparse
import os

import numpy as np


def make_l_shaped_data(seed: int = 0):
    """The two-box training distribution: (states, actions, next_states),
    each (400, 2)."""
    rng = np.random.default_rng(seed)
    boxes = [
        (200, 3.8, 4.2, -4.2, 0.2),
        (200, -0.2, 4.2, -0.2, 0.2),
    ]
    states, actions = [], []
    for n, x0, x1, y0, y1 in boxes:
        sx = rng.uniform(x0, x1, (n, 1))
        sy = rng.uniform(y0, y1, (n, 1))
        ax = rng.uniform(-1, 1, (n, 1))
        ay = rng.uniform(-1, 1, (n, 1))
        states.append(np.concatenate([sx, sy], axis=1))
        actions.append(np.concatenate([ax, ay], axis=1))
    states = np.concatenate(states, axis=0)
    actions = np.concatenate(actions, axis=0)
    return states, actions, states + actions


def make_controller(gamma: float, horizon: int = 6, seed: int = 0,
                    device=None, solver=None):
    """The experiment's controller at one gamma, loaded with the L-shaped
    data (the published settings unless `solver` is given)."""
    import torch

    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.solver import SolverConfig

    states, actions, next_states = make_l_shaped_data(seed)
    mpc = RiskSensitiveMPC(gamma=gamma, horizon=horizon, state_dim=2,
                           input_dim=2, Q=2 * np.eye(2), R=np.zeros((2, 2)),
                           capacity=512, dtype=torch.float64, device=device,
                           solver=solver or SolverConfig(
                               max_iters=300, tol=1e-5, polish_iters=20))
    mpc.set_gp_hyperparams(lambdas=[0.5] * 4, sigma_f=1.0, sigma_n=1e-5)
    mpc.dynamics.append_train_data(states, actions, next_states)
    mpc.set_ub([1.0, 1.0])
    mpc.set_lb([-1.0, -1.0])
    mpc.set_xref(np.array([0.0, 0.0]))
    mpc.set_uref(np.array([0.0, 0.0]))
    return mpc


def uncertainty_experiment(gammas=(-1.0, 1e-5), horizon: int = 6,
                           out_dir=None, seed: int = 0, verbose: bool = True,
                           device=None, solver=None):
    """One solve from (4, -4) per gamma. Returns {gamma: {u (H, 2), expected
    (H+1, 2) GP means, true (H+1, 2) plant path, covs (H+1, 2, 2), iters
    (the solver's iterations), mpc (the controller)}}; with out_dir, also
    writes the .npz (and figures)."""
    import torch

    from gpmpc_tpu_torch.dynamics import build_rollout_cache, rollout

    states = make_l_shaped_data(seed)[0]
    curr_state = np.array([4.0, -4.0])
    results = {}
    for gamma in gammas:
        mpc = make_controller(gamma, horizon, seed, device, solver)
        opt_traj = mpc.get_optimal_trajectory(curr_state)
        cache = build_rollout_cache(mpc.gp, 2, 2)
        with torch.no_grad():
            means, covs = rollout(cache, mpc._t(curr_state), mpc._t(opt_traj))
        true_traj = np.zeros((horizon + 1, 2))
        true_traj[0] = curr_state
        for i in range(horizon):
            true_traj[i + 1] = true_traj[i] + opt_traj[i]
        results[gamma] = dict(u=opt_traj, expected=means.cpu().numpy(),
                              true=true_traj, covs=covs.cpu().numpy(),
                              iters=int(mpc.last_result.iters), mpc=mpc)
        if verbose:
            print(f'gamma={gamma}: u[0]={np.round(opt_traj[0], 3)}, '
                  f'expected path x: {np.round(results[gamma]["expected"][:, 0], 2)}')
            print(f'             expected path y: '
                  f'{np.round(results[gamma]["expected"][:, 1], 2)}')
    if out_dir is not None:
        _write(results, states, curr_state, out_dir, verbose)
    return results


def _write(results, states, curr_state, out_dir, verbose):
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, 'gamma_sweep.npz'), states=states,
             **{f'expected_{g}': r['expected'] for g, r in results.items()},
             **{f'true_{g}': r['true'] for g, r in results.items()})
    try:
        import matplotlib
    except ImportError:
        if verbose:
            print('matplotlib unavailable: wrote the .npz only')
        return
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    for gamma, r in results.items():
        fig, ax = plt.subplots()
        ax.set_xlim(-1, 5)
        ax.set_ylim(-5, 1)
        ax.scatter(states[:, 0], states[:, 1], label='Training Data',
                   alpha=0.4, s=8)
        ax.scatter(*r['expected'].T, color='blue', label='Expected Trajectory')
        ax.scatter(*r['true'].T, color='black', label='True Trajectory')
        ax.scatter(0, 0, color='white', edgecolor='black', marker='*', s=300,
                   label='Set Point')
        ax.scatter(*curr_state, color='white', edgecolor='black', marker='o',
                   s=200, label='Initial State')
        ax.legend()
        ax.set_title(f'Optimal MPC Trajectory with gamma={gamma}')
        ax.set_xlabel('State Dimension 1')
        ax.set_ylabel('State Dimension 2')
        fig.savefig(os.path.join(out_dir, f'gamma_{gamma}.png'), dpi=120)
        plt.close(fig)
    if verbose:
        print(f'figures written to {out_dir}/')


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--gammas', type=float, nargs='+', default=[-1.0, 1e-5])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out-dir', default='uncertainty_out')
    args = ap.parse_args()
    uncertainty_experiment(gammas=tuple(args.gammas), out_dir=args.out_dir,
                           device=args.device)


if __name__ == '__main__':
    main()
