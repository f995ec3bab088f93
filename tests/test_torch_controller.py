"""gpmpc_tpu_torch.mpc.controller.RiskSensitiveMPC against gpmpc_tpu's at
f64: the integrator's known answer (tests/test_solver.py:61-87), zeros until
the GP has data, each of `_solve`'s three routes with actions equal to JAX's
over two consecutive calls (the warm start and u_prev change between them),
`train_gp` followed by a solve on the untied route, and `cost`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.mpc.controller import RiskSensitiveMPC as JMPC
from gpmpc_tpu.mpc.solver import SolverConfig as JConfig
from gpmpc_tpu_torch.experiments.integrator import integrator_experiment
from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC as TMPC
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from torch_port_common import gp_data, np_

torch.set_num_threads(1)
# The variance trace cancels (its terms reach 1e3-1e6 times the result), so
# the two packages' f64 rollout variances agree to ~1e-9 relative, not to
# eps; two dozen L-BFGS iterations carry that into the actions at up to
# ~3e-7 relative (measured 2.8e-7).
RTOL, ATOL = 1e-6, 1e-7


def _pair(cfg=None, recipe='single', n_starts=1, delta=True, **kw):
    args = dict(gamma=0.3, horizon=4, state_dim=2, input_dim=1,
                Q=np.diag([2.0, 1.0]), R=0.1 * np.eye(1),
                R_delta=0.05 * np.eye(1), capacity=32, delta_dynamics=delta,
                solver_recipe=recipe, n_starts=n_starts, **kw)
    cfg = cfg or dict(max_iters=30, tol=1e-4)
    j = JMPC(dtype=jnp.float64, solver=JConfig(**cfg), **args)
    t = TMPC(dtype=torch.float64, solver=SolverConfig(**cfg), device='cpu',
             **args)
    x, ns = gp_data(n=20)
    for mpc in (j, t):
        mpc.set_ub([1.5])
        mpc.set_lb([-1.5])
        mpc.set_gp_hyperparams(lambdas=[2.0, 2.0, 2.0], sigma_f=1.0,
                               sigma_n=1e-2)
        mpc.dynamics.append_train_data(x[:, :2], x[:, 2], ns)
    return j, t


def _two_steps(j, t, x0=(0.4, -0.2)):
    """Two consecutive solves; the second from the state the first action
    leads to under a fixed linear plant, after an online append."""
    x0 = np.asarray(x0)
    for step in range(2):
        uj = j.get_optimal_trajectory(x0)
        ut = t.get_optimal_trajectory(x0)
        assert ut.shape == (4, 1) and ut.dtype == np.float64
        np.testing.assert_allclose(ut, uj, rtol=RTOL, atol=ATOL,
                                   err_msg=f'step {step}')
        assert int(t.last_result.iters) == int(j.last_result.iters)
        np.testing.assert_allclose(float(t.last_result.cost),
                                   float(j.last_result.cost), rtol=RTOL)
        np.testing.assert_array_equal(t.last_traj, ut)
        nxt = x0 + 0.1 * np.array([x0[1], uj[0, 0]])
        for mpc in (j, t):
            mpc.dynamics.append_train_data(x0, uj[0], nxt)
        x0 = nxt
    assert int(t.gp.count) == int(j.gp.count) == 22


def test_integrator_known_answer():
    u, err = integrator_experiment(verbose=False, device='cpu')
    np.testing.assert_allclose(u.ravel(), -np.ones(5), atol=5e-3)
    assert err < 5e-3


def test_zero_trajectory_until_data():
    mpc = TMPC(gamma=0.0, horizon=3, state_dim=1, input_dim=1, Q=np.eye(1),
               R=np.eye(1), device='cpu')
    np.testing.assert_array_equal(mpc.get_optimal_trajectory(np.array([1.0])),
                                  np.zeros((3, 1)))
    assert mpc.last_result is None


def test_route_b_batched_matches_jax(monkeypatch):
    """L-BFGS without a nominal model: the batched rollout at B = 1 (K1 on a
    card, tied lengthscales)."""
    from gpmpc_tpu_torch.mpc import controller
    j, t = _pair()
    assert t.gp.config.tied_lambdas
    seen = []
    orig = controller.solve_trajectory_batched
    monkeypatch.setattr(controller, 'solve_trajectory_batched',
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    _two_steps(j, t)
    assert len(seen) == 2


def test_route_a_multistart_matches_jax():
    """solver_recipe='multistart' with one start (u = 0) plus the shifted
    last trajectory: the start sets are the same on both sides."""
    j, t = _pair(recipe='multistart', n_starts=1,
                 cfg=dict(max_iters=20, tol=1e-4))
    _two_steps(j, t)


def test_route_c_single_matches_jax():
    """Adam: the single-scenario rollout and solve_trajectory."""
    j, t = _pair(cfg=dict(method='adam', max_iters=25, learning_rate=0.05,
                          polish_iters=5))
    _two_steps(j, t)


def test_train_gp_then_untied_solve():
    """train_gp unties the lengthscales; the next solve takes route (b) on
    the untied trace (K2 on a card), equal to JAX's."""
    j, t = _pair()
    rj, rt = j.train_gp(num_iters=15), t.train_gp(num_iters=15)
    assert rt.iters == int(rj.iters)
    assert not t.gp.config.tied_lambdas
    for name in ('log_lambdas', 'log_sigma_f', 'log_sigma_n'):
        np.testing.assert_allclose(np_(getattr(t.gp, name)),
                                   np.asarray(getattr(j.gp, name)), rtol=1e-8)
    _two_steps(j, t)


def test_cost_matches_jax():
    j, t = _pair()
    rng = np.random.default_rng(2)
    means = rng.normal(size=(5, 2))
    covs = np.stack([np.diag(rng.uniform(0.01, 0.1, 2)) for _ in range(5)])
    u = rng.normal(size=(4, 1))
    j.last_traj = t.last_traj = rng.normal(size=(4, 1))
    np.testing.assert_allclose(t.cost(means, u, covs),
                               j.cost(means, u, covs), rtol=1e-10)
    np.testing.assert_allclose(t.cost(means, u, covs, x_ref=[0.1, 0.2]),
                               j.cost(means, u, covs, x_ref=[0.1, 0.2]),
                               rtol=1e-10)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        TMPC(gamma=0.0, horizon=3, state_dim=1, input_dim=1, Q=np.eye(1),
             R=np.eye(1))
