"""gpmpc_tpu_torch.gp.train against gpmpc_tpu.gp.train at f64 (the
counterparts of tests/test_train.py): trained hyperparameters, fit and
`iters` equal to JAX's (rtol 1e-8), the ML increases, the early stop, a
frozen sigma_n, the sigma_n floor, tied_lambdas cleared, and the f32 GP
trained in f64 with only its result rounded."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.gp import state as gs
from gpmpc_tpu.gp.train import train_hyperparams as jtrain
from gpmpc_tpu_torch.gp import state as ts
from gpmpc_tpu_torch.gp.exact import log_marginal_likelihood
from gpmpc_tpu_torch.gp.train import train_hyperparams as ttrain
from torch_port_common import np_

torch.set_num_threads(1)
RTOL = 1e-8


def _data(seed=21, n=30, noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, 2))
    y = np.stack([np.sin(x[:, 0]) + noise * rng.normal(size=n),
                  0.5 * x[:, 1] ** 2 + noise * rng.normal(size=n)], axis=1)
    return x, y


def _pair(x, y, sn=0.3, tied=False, dtype=torch.float64):
    ll = None if tied else np.log([[1.0, 1.5], [2.0, 1.0]])
    kw = dict(log_lambdas=ll, log_sigma_n=np.log(sn))
    jgp = gs.make_gp(gs.GPConfig(capacity=32, x_dim=2, out_dim=2), x, y,
                     dtype=jnp.float64, **kw)
    tgp = ts.make_gp(ts.GPConfig(capacity=32, x_dim=2, out_dim=2), x, y,
                     dtype=dtype, device='cpu', **kw)
    return jgp, tgp


def _assert_same(tres, jres, rtol=RTOL):
    assert tres.iters == int(jres.iters)
    for name in ('log_lambdas', 'log_sigma_f', 'log_sigma_n', 'beta',
                 'logdet'):
        np.testing.assert_allclose(np_(getattr(tres.state, name)),
                                   np.asarray(getattr(jres.state, name)),
                                   rtol=rtol, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(np_(tres.state.kinv),
                               np.asarray(jres.state.kinv), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(np_(tres.log_ml), np.asarray(jres.log_ml),
                               rtol=RTOL)
    np.testing.assert_allclose(tres.grad_norm, float(jres.grad_norm),
                               rtol=1e-6)
    assert not tres.state.config.tied_lambdas


@pytest.mark.parametrize('case', [
    dict(num_iters=20),
    dict(num_iters=20, lr=0.05, tied=True),
    dict(num_iters=30, train_sigma_n=False),
    dict(num_iters=30, train_lambdas=False, train_sigma_f=False),
    dict(num_iters=40, min_sigma_n=0.35),
])
def test_train_matches_jax(case):
    case = dict(case)
    x, y = _data()
    jgp, tgp = _pair(x, y, tied=case.pop('tied', False))
    _assert_same(ttrain(tgp, **case), jtrain(jgp, **case))


def test_early_stop_matches_jax():
    """A loose tolerance stops well before the cap, at JAX's iteration."""
    x, y = _data()
    jgp, tgp = _pair(x, y)
    kw = dict(num_iters=2000, lr=0.05, tol=1e-1)
    tres = ttrain(tgp, **kw)
    assert tres.iters < 2000 and tres.grad_norm < 1e-1
    _assert_same(tres, jtrain(jgp, **kw), rtol=1e-7)


def test_ml_increases():
    x, y = _data(seed=22)
    _, tgp = _pair(x, y)
    ml0 = np_(log_marginal_likelihood(tgp))
    res = ttrain(tgp, num_iters=100)
    assert np.all(np_(res.log_ml) > ml0) and res.iters <= 100


def test_frozen_sigma_n_and_floor():
    x, y = _data(seed=23)
    _, tgp = _pair(x, y, sn=0.25)
    res = ttrain(tgp, num_iters=50, train_sigma_n=False)
    np.testing.assert_allclose(np_(res.state.sigma_n), 0.25, rtol=1e-12)
    assert not np.allclose(np_(res.state.log_lambdas), np_(tgp.log_lambdas))
    # Noise-free targets drive sigma_n to 0 without a floor.
    x = np.random.default_rng(24).uniform(-2, 2, (25, 2))
    y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 1])], axis=1)
    _, tgp = _pair(x, y, sn=0.1)
    res = ttrain(tgp, num_iters=300, min_sigma_n=1e-2)
    assert np.all(np_(res.state.sigma_n) >= 1e-2 - 1e-12)


def test_f32_trains_in_f64():
    """An f32 GP trains on the f64 fit: its f32 result is the f64 training's
    rounded, the state and Adam never in f32."""
    x, y = _data(seed=25)
    _, t64 = _pair(x, y)
    _, t32 = _pair(x, y, dtype=torch.float32)
    r64 = ttrain(t64, num_iters=25)
    r32 = ttrain(t32, num_iters=25)
    assert r32.iters == r64.iters
    assert r32.state.log_lambdas.dtype == torch.float32
    for name in ('log_lambdas', 'log_sigma_f', 'log_sigma_n'):
        np.testing.assert_allclose(np_(getattr(r32.state, name)),
                                   np_(getattr(r64.state, name)), rtol=1e-6)
