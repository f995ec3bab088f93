"""gpmpc_tpu_torch.compat against the reference's usage patterns and
gpmpc_tpu.compat at f64: the counterparts of tests/test_compat.py (held to
tests/oracles.py's NumPy GP at that test's bars), and the same calls through
both packages' facades giving the same numbers (rtol 1e-8; training at the
rtol of tests/test_torch_train.py, 1e-8 on the hyperparameters)."""

import numpy as np
import torch

import oracles
from gpmpc_tpu import compat as jcompat
from gpmpc_tpu_torch.compat import Dynamics, GaussianProcessRegression

torch.set_num_threads(1)
RNG = np.random.default_rng(33)
CPU = dict(device='cpu')


def _gpr(cls=GaussianProcessRegression, n=20, d=2, seed=33, **kw):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1]
    gpr = cls(x_dim=d, capacity=32, **kw)
    gpr.set_lambdas([1.5, 0.8])
    gpr.set_sigma_f(1.2)
    gpr.set_sigma_n(0.1)
    gpr.append_train_data(x, y)
    return gpr, x, y


def test_predict_vs_oracle():
    gpr, x, y = _gpr(**CPU)
    xp = RNG.uniform(-2, 2, (5, 2))
    mean, cov = gpr.predict_latent_vars(xp, covar=True)
    m_ref, c_ref = oracles.gp_predict(x, y, xp, np.array([1.5, 0.8]), 1.2, 0.1)
    np.testing.assert_allclose(mean, m_ref, atol=1e-7)
    np.testing.assert_allclose(cov, c_ref, atol=1e-7)


def test_targets_adds_noise():
    gpr, *_ = _gpr(**CPU)
    xp = RNG.uniform(-2, 2, (3, 2))
    _, c_f = gpr.predict_latent_vars(xp, covar=True, targets=False)
    _, c_y = gpr.predict_latent_vars(xp, covar=True, targets=True)
    np.testing.assert_allclose(c_y - c_f, 0.01 * np.eye(3), atol=1e-9)


def test_single_point_api():
    gpr, *_ = _gpr(**CPU)
    mean, cov = gpr.predict_latent_vars(np.array([0.1, 0.2]), covar=True)
    assert np.isscalar(mean) or mean.shape == ()
    assert np.isscalar(cov) or cov.shape == ()


def test_marginal_likelihood_vs_oracle():
    gpr, x, y = _gpr(**CPU)
    np.testing.assert_allclose(
        gpr.compute_marginal_likelihood(),
        oracles.log_ml(x, y, np.array([1.5, 0.8]), 1.2, 0.1), atol=1e-7)


def test_scalar_append_and_growth():
    gpr = GaussianProcessRegression(x_dim=2, capacity=8, **CPU)
    gpr.set_sigma_n(0.1)
    for i in range(3):
        gpr.append_train_data(np.array([i * 0.5, -i * 0.3]), float(i))
    assert gpr.num_train == 3
    np.testing.assert_allclose(gpr.y_train.ravel(), [0.0, 1.0, 2.0])
    gpr = GaussianProcessRegression(x_dim=1, capacity=4, **CPU)
    gpr.set_sigma_n(0.1)
    x = RNG.uniform(-1, 1, (10, 1))
    gpr.append_train_data(x, x[:, 0] ** 2)
    assert gpr.num_train == 10 and gpr.state.config.capacity == 10
    np.testing.assert_array_equal(gpr.X_train, x)


def test_kernel_matrix_views():
    gpr, x, y = _gpr(**CPU)
    np.testing.assert_allclose(
        gpr.Kf, oracles.gram(x, x, np.array([1.5, 0.8]), 1.2), atol=1e-8)
    np.testing.assert_allclose(gpr.Ky_inv @ gpr.Ky, np.eye(len(x)), atol=1e-6)
    np.testing.assert_allclose(gpr.se_kernel(x[0], x[1]), gpr.Kf[0, 1],
                               rtol=1e-12)
    np.testing.assert_allclose(gpr.compute_pred_train_covariance(x[:3]),
                               gpr.Kf[:3], rtol=1e-12)


def test_nominal_model_residual():
    x = RNG.uniform(-2, 2, (15, 2))
    y = 2.0 * x[:, 0] + np.sin(x[:, 1])
    gpr = GaussianProcessRegression(x_dim=2, nominal_model=lambda xs:
                                    2.0 * xs[:, 0], capacity=16, **CPU)
    gpr.set_sigma_n(0.05)
    gpr.append_train_data(x, y)
    xp = RNG.uniform(-2, 2, (4, 2))
    mean, _ = gpr.predict_latent_vars(xp)
    m_ref, _ = oracles.gp_predict(x, y - 2.0 * x[:, 0], xp, np.ones(2), 1.0,
                                  0.05)
    np.testing.assert_allclose(mean, m_ref + 2.0 * xp[:, 0], atol=1e-7)


def test_gpr_matches_jax_facade():
    """The same calls through both facades: predictions, the marginal
    likelihood, and update_hyperparams(50) (its hyperparameters, ML and
    iterations)."""
    (tg, x, _), (jg, _, _) = _gpr(**CPU), _gpr(cls=jcompat.
                                               GaussianProcessRegression)
    xp = RNG.uniform(-2, 2, (5, 2))
    for a, b in zip(tg.predict_latent_vars(xp, covar=True),
                    jg.predict_latent_vars(xp, covar=True)):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tg.compute_marginal_likelihood(),
                               jg.compute_marginal_likelihood(), rtol=1e-10)
    ml0 = tg.compute_marginal_likelihood()
    tres, jres = tg.update_hyperparams(num_iters=50), jg.update_hyperparams(
        num_iters=50)
    assert tres.iters == int(jres.iters)
    np.testing.assert_allclose(tg.get_lambdas(), jg.get_lambdas(), rtol=1e-8)
    np.testing.assert_allclose(tg.get_sigma_n(), jg.get_sigma_n(), rtol=1e-8)
    np.testing.assert_allclose(tg.compute_marginal_likelihood(),
                               jg.compute_marginal_likelihood(), rtol=1e-8)
    assert tg.compute_marginal_likelihood() > ml0


def test_dynamics_per_output_hyperparams():
    dyn = Dynamics(state_dim=2, action_dim=1, capacity=32, **CPU)
    dyn.gpr_err[0].set_sigma_n(1e-3)
    dyn.gpr_err[1].set_sigma_n(1e-2)
    dyn.gpr_err[0].set_lambdas([2.0, 2.0, 2.0])
    assert abs(dyn.gpr_err[0].get_sigma_n() - 1e-3) < 1e-12
    assert abs(dyn.gpr_err[1].get_sigma_n() - 1e-2) < 1e-12
    np.testing.assert_allclose(dyn.gpr_err[0].get_lambdas(), 2.0)
    assert not dyn.state.config.tied_lambdas


def _dynamics(cls, nominal=None, **kw):
    dyn = cls(state_dim=2, action_dim=1, capacity=64, nominal_models=nominal,
              **kw)
    for v in dyn.gpr_err:
        v.set_sigma_n(0.05)
        v.set_lambdas([3.0, 3.0, 3.0])
    rng = np.random.default_rng(34)
    s = rng.uniform(-1, 1, (30, 2))
    a = rng.uniform(-1, 1, (30, 1))
    dyn.append_train_data(s, a, 0.9 * s + 0.1 * np.concatenate([a, a], 1))
    return dyn


def test_dynamics_append_and_rollout():
    dyn = _dynamics(Dynamics, **CPU)
    assert dyn.gpr_err[0].num_train == 30
    means, covs = dyn.forward_propagate(3, np.array([0.5, -0.2]),
                                        RNG.uniform(-1, 1, (3, 1)))
    assert means.shape == (4, 2) and covs.shape == (4, 2, 2)
    assert np.all(np.isfinite(means))
    np.testing.assert_allclose(means[0], [0.5, -0.2], atol=1e-12)
    np.testing.assert_allclose(covs[0], 1e-3 * np.eye(2), atol=1e-12)
    single = Dynamics(state_dim=2, action_dim=1, capacity=8, **CPU)
    single.append_train_data(np.array([0.1, 0.2]), np.array([0.5]),
                             np.array([0.15, 0.18]))
    assert single.gpr_err[0].num_train == 1
    np.testing.assert_allclose(single.gpr_err[1].y_train, [[0.18]])


def test_dynamics_matches_jax_facade():
    """forward_propagate of the same data and actions, without and with
    per-output nominal models (the EKF terms), equal to JAX's facade."""
    us = RNG.uniform(-1, 1, (4, 1))
    x0 = np.array([0.4, -0.3])
    nominal_t = [lambda s, a: 0.9 * s[:, 0], lambda s, a: 0.9 * s[:, 1]
                 + 0.1 * a[:, 0]]
    for nom in (None, nominal_t):
        tm, tc = _dynamics(Dynamics, nom, **CPU).forward_propagate(4, x0, us)
        jm, jc = _dynamics(jcompat.Dynamics, nom).forward_propagate(4, x0, us)
        np.testing.assert_allclose(tm, jm, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(tc, jc, rtol=1e-7, atol=1e-12)
