"""The port's closed loop on the CPU against the stored JAX reference
(gpmpc_tpu_torch/data/closed_loop_ref.npz, written by
tests/make_torch_closed_loop_ref.py): tests/test_closed_loop.py's swing-up
at f64 on JAX's 250 transitions, train_gp(80) and the episode's first steps.
These are the distances chip_smoke.py phase 7 sets its bars from: the
trained hyperparameters within 1e-9 relative of JAX's (measured 4.9e-11),
the actions within 1e-8, the states within 1e-6 (the plants step in f32;
measured 4.8e-8), the costs within 1e-7 relative (measured 1.5e-8)."""

import os

import numpy as np
import torch

from gpmpc_tpu_torch.envs.pendulum import PendulumEnv, PendulumParams
from gpmpc_tpu_torch.gp.exact import log_marginal_likelihood
from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.sim.simulator import Simulator
from torch_port_common import np_

torch.set_num_threads(2)
REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   'gpmpc_tpu_torch', 'data', 'closed_loop_ref.npz')


def test_swing_up_matches_stored_jax_reference():
    ref = np.load(REF)
    params = PendulumParams(g=10.0, max_torque=5.0)
    mpc = RiskSensitiveMPC(
        gamma=0.0, horizon=8, state_dim=2, input_dim=1,
        Q=np.diag([8.0, 1.0]), R=0.001 * np.eye(1), R_delta=0.001 * np.eye(1),
        capacity=512, delta_dynamics=True, dtype=torch.float64,
        solver=SolverConfig(max_iters=60, tol=1e-4), device='cpu')
    mpc.set_ub([params.max_torque])
    mpc.set_lb([-params.max_torque])
    mpc.set_gp_hyperparams(lambdas=[2.0, 2.0, 2.0], sigma_f=1.0, sigma_n=1e-2)
    mpc.dynamics.append_train_data(ref['states'], ref['actions'],
                                   ref['next_states'])
    res = mpc.train_gp(num_iters=80)
    assert res.iters == int(ref['train_iters'])
    assert not mpc.gp.config.tied_lambdas
    for k in ('log_lambdas', 'log_sigma_f', 'log_sigma_n'):
        np.testing.assert_allclose(np_(getattr(mpc.gp, k)), ref[k], rtol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(np_(log_marginal_likelihood(mpc.gp)),
                               ref['log_ml'], rtol=1e-10)
    np.testing.assert_allclose(res.grad_norm, float(ref['train_grad_norm']),
                               rtol=1e-6)
    env = PendulumEnv(params=params, device='cpu',
                      init_state={'th_init': 1.0, 'thdot_init': 0.5})
    n = ref['ep_actions'].shape[0]
    log = Simulator(mpc, env, num_iters=n).run()
    np.testing.assert_allclose(log.actions, ref['ep_actions'], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(log.states, ref['ep_states'], rtol=0, atol=1e-6)
    np.testing.assert_allclose(log.costs, ref['ep_costs'], rtol=1e-7)
    np.testing.assert_array_equal(log.iters, ref['ep_iters'])
    assert int(mpc.gp.count) == 250 + n
