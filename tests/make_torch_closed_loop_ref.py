"""Write gpmpc_tpu_torch/data/closed_loop_ref.npz: the JAX package's f64
closed loop in tests/test_closed_loop.py's swing-up configuration, the
reference the port's closed loop is held against (chip_smoke.py phase 7 on
the card, tests/test_torch_closed_loop_ref.py on the CPU).

Configuration (tests/test_closed_loop.py:36-56): PendulumParams(g=10,
max_torque=5); 250 transitions from sample_transitions(PRNGKey(0));
RiskSensitiveMPC(gamma=0, H=8, Q=diag(8, 1), R=R_delta=1e-3, capacity 512,
delta dynamics, f64, L-BFGS max_iters 60 tol 1e-4), torque bounds +-5,
lengthscales 2, sigma_f 1, sigma_n 1e-2, then train_gp(num_iters=80); the
episode starts at (theta, theta_dot) = (1, 0.5).

The file holds:
  states, actions, next_states   (250, 2) (250, 1) (250, 2)  the transitions
  log_lambdas, log_sigma_f, log_sigma_n   (2, 3) (2,) (2,)  after training
  train_iters, train_grad_norm   ()  the training's iterations and final
                                 max |grad|
  log_ml                         (2,)  the trained GP's log ML
  ep_states (N_STEPS + 1, 2), ep_actions (N_STEPS, 1), ep_costs,
  ep_iters (N_STEPS,)            the first N_STEPS steps of the episode

Run from the repository root: python tests/make_torch_closed_loop_ref.py
(JAX on the CPU, ~1 min).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'gpmpc_tpu_torch', 'data', 'closed_loop_ref.npz')
N_STEPS = 5


def main():
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    from gpmpc_tpu.envs.pendulum import (PendulumEnv, PendulumParams,
                                         sample_transitions)
    from gpmpc_tpu.gp.exact import log_marginal_likelihood
    from gpmpc_tpu.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu.mpc.solver import SolverConfig
    from gpmpc_tpu.sim.simulator import Simulator

    params = PendulumParams(g=10.0, max_torque=5.0)
    states, actions, next_states = sample_transitions(
        jax.random.PRNGKey(0), 250, params)
    mpc = RiskSensitiveMPC(
        gamma=0.0, horizon=8, state_dim=2, input_dim=1,
        Q=np.diag([8.0, 1.0]), R=0.001 * np.eye(1),
        R_delta=0.001 * np.eye(1), capacity=512, delta_dynamics=True,
        dtype=jnp.float64, solver=SolverConfig(max_iters=60, tol=1e-4))
    mpc.set_ub([params.max_torque])
    mpc.set_lb([-params.max_torque])
    mpc.set_gp_hyperparams(lambdas=[2.0, 2.0, 2.0], sigma_f=1.0, sigma_n=1e-2)
    mpc.dynamics.append_train_data(np.asarray(states), np.asarray(actions),
                                   np.asarray(next_states))
    res = mpc.train_gp(num_iters=80)
    trained = {k: np.asarray(getattr(mpc.gp, k))
               for k in ('log_lambdas', 'log_sigma_f', 'log_sigma_n')}
    env = PendulumEnv(params=params,
                      init_state={'th_init': 1.0, 'thdot_init': 0.5})
    log = Simulator(mpc, env, num_iters=N_STEPS).run()
    np.savez(OUT, states=np.asarray(states, np.float64),
             actions=np.asarray(actions, np.float64),
             next_states=np.asarray(next_states, np.float64),
             train_iters=np.asarray(int(res.iters)),
             train_grad_norm=np.asarray(float(res.grad_norm)),
             log_ml=np.asarray(log_marginal_likelihood(res.state)),
             ep_states=log.states, ep_actions=log.actions,
             ep_costs=log.costs, ep_iters=log.iters, **trained)
    print(f'wrote {OUT}: train iters {int(res.iters)}, lambdas '
          f'{np.exp(trained["log_lambdas"])}, actions {log.actions.ravel()}')


if __name__ == '__main__':
    main()
