"""gpmpc_tpu_torch.gp (kernels, state, exact) and convert against gpmpc_tpu.gp
at f64, rtol 1e-8: the port's own f64 fit, tied detection, prediction and the
marginal likelihood."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.gp import exact as jexact
from gpmpc_tpu.gp import kernels as jk
from gpmpc_tpu.gp import state as gs
from gpmpc_tpu_torch.gp import exact as texact
from gpmpc_tpu_torch.gp import kernels as tk
from gpmpc_tpu_torch.gp import state as ts
from torch_port_common import (gp_data, jax_gp, np_, port_gp, t64,
                               untied_log_lambdas)

torch.set_num_threads(1)
RTOL = 1e-8


def _port_make(x, y, cap, log_lambdas, sigma_n, dtype=torch.float64, jitter=0.0):
    cfg = ts.GPConfig(capacity=cap, x_dim=x.shape[1], out_dim=y.shape[1],
                      jitter=jitter)
    return ts.make_gp(cfg, x, y, log_lambdas=log_lambdas, log_sigma_f=0.0,
                      log_sigma_n=np.log(sigma_n), dtype=dtype, device='cpu')


def _assert_fit_equal(tgp, jgp, rtol=RTOL):
    for name in ('x', 'y', 'mask', 'count', 'log_lambdas', 'log_sigma_f',
                 'log_sigma_n', 'kinv', 'beta', 'logdet', 'jitter_used'):
        np.testing.assert_allclose(np_(getattr(tgp, name)).astype(np.float64),
                                   np.asarray(getattr(jgp, name), np.float64),
                                   rtol=rtol, atol=1e-12, err_msg=name)
    assert tgp.config.tied_lambdas == bool(jgp.config.tied_lambdas)


def test_se_kernel_and_gram():
    rng = np.random.default_rng(0)
    x1, x2 = rng.normal(size=(5, 3)), rng.normal(size=(4, 3))
    ll, lsf = rng.normal(size=(2, 3)) * 0.3, rng.normal(size=(2,)) * 0.3
    np.testing.assert_allclose(
        float(tk.se_kernel(t64(x1[0]), t64(x2[0]), t64(ll[0]), t64(lsf[0]))),
        float(jk.se_kernel(jnp.asarray(x1[0]), jnp.asarray(x2[0]),
                           jnp.asarray(ll[0]), jnp.asarray(lsf[0]))), rtol=RTOL)
    np.testing.assert_allclose(
        np_(tk.se_gram(t64(x1), t64(x2), t64(ll[0]), t64(lsf[0]))),
        np.asarray(jk.se_gram(jnp.asarray(x1), jnp.asarray(x2),
                              jnp.asarray(ll[0]), jnp.asarray(lsf[0]))),
        rtol=RTOL)
    np.testing.assert_allclose(
        np_(tk.se_gram_batched(t64(x1), t64(x2), t64(ll), t64(lsf))),
        np.asarray(jk.se_gram_batched(jnp.asarray(x1), jnp.asarray(x2),
                                      jnp.asarray(ll), jnp.asarray(lsf))),
        rtol=RTOL)


@pytest.mark.parametrize('tied', [True, False])
def test_make_gp_matches_jax_fit(tied):
    ll = None if tied else untied_log_lambdas()
    x, y = gp_data(n=24, seed=3)
    jgp = jax_gp(n=24, cap=32, seed=3, log_lambdas=ll)
    tgp = _port_make(x, y, 32, np.asarray(jgp.log_lambdas), 1e-2)
    _assert_fit_equal(tgp, jgp)
    assert tgp.config.tied_lambdas is tied


def test_make_gp_jitter_escalation_matches():
    """Duplicated inputs and a tiny sigma_n make Ky singular: both packages
    escalate to the same jitter. kinv is then ~1e14 in size and its pivots
    sit at the rounding level, so the factors are compared through the
    well-conditioned posterior mean."""
    x, y = gp_data(n=12, seed=4)
    x, y = np.concatenate([x, x]), np.concatenate([y, y])
    cfg = gs.GPConfig(capacity=32, x_dim=3, out_dim=2)
    jgp = gs.make_gp(cfg, x, y, log_lambdas=np.log([2.0] * 3), log_sigma_f=0.0,
                     log_sigma_n=np.log(1e-9), dtype=jnp.float64)
    tgp = _port_make(x, y, 32, np.log([2.0] * 3), 1e-9)
    assert np.all(np.asarray(jgp.jitter_used) > 0.0)
    np.testing.assert_array_equal(np_(tgp.jitter_used),
                                  np.asarray(jgp.jitter_used))
    xp = np.random.default_rng(5).uniform(-1, 1, (5, 3))
    np.testing.assert_allclose(np_(texact.predict(tgp, t64(xp))[0]),
                               np.asarray(jexact.predict(jgp, jnp.asarray(xp))[0]),
                               rtol=1e-6)


def test_headline_fit_f32_storage_matches():
    """On the headline GP both packages run an f64 fit cast to f32 storage."""
    from benchmarks.problems import make_headline_problem as jmake
    from gpmpc_tpu_torch.problems import make_headline_problem as tmake
    jgp = jmake(b=2, dtype=jnp.float32).gp
    tgp = tmake(b=2, dtype=torch.float32, device='cpu').gp
    _assert_fit_equal(tgp, jgp, rtol=1e-6)


@pytest.mark.parametrize('v,tied', [(None, True), (0.3, True), ([0.1, 0.2], True),
                                    ([[0.1, 0.2], [0.1, 0.2]], True),
                                    ([[0.1, 0.2], [0.1, 0.3]], False)])
def test_rows_tied(v, tied):
    assert ts._rows_tied(v) is tied
    assert gs._rows_tied(v) is tied


def test_make_gp_rejects_overflow():
    x, y = gp_data(n=10)
    with pytest.raises(ValueError):
        _port_make(x, y, 8, None, 1e-2)


@pytest.mark.parametrize('full_cov,include_noise',
                         [(False, False), (False, True), (True, False),
                          (True, True)])
def test_predict_matches(full_cov, include_noise):
    jgp = jax_gp(n=20, cap=32, seed=5, log_lambdas=untied_log_lambdas())
    tgp = port_gp(jgp)
    xp = np.random.default_rng(6).normal(size=(7, 3))
    mj, cj = jexact.predict(jgp, jnp.asarray(xp), full_cov, include_noise)
    mt, ct = texact.predict(tgp, t64(xp), full_cov, include_noise)
    np.testing.assert_allclose(np_(mt), np.asarray(mj), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=RTOL, atol=1e-12)
    m1j, c1j = jexact.predict(jgp, jnp.asarray(xp[0]), full_cov, include_noise)
    m1t, c1t = texact.predict(tgp, t64(xp[0]), full_cov, include_noise)
    np.testing.assert_allclose(np_(m1t), np.asarray(m1j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(np_(c1t), np.asarray(c1j), rtol=RTOL, atol=1e-12)


def test_log_marginal_likelihood_matches():
    jgp = jax_gp(n=20, cap=32, seed=7)
    np.testing.assert_allclose(np_(texact.log_marginal_likelihood(port_gp(jgp))),
                               np.asarray(jexact.log_marginal_likelihood(jgp)),
                               rtol=RTOL)


def test_convert_carries_posterior():
    jgp = jax_gp(n=20, cap=32, seed=8, dtype=jnp.float32)
    tgp = port_gp(jgp, dtype=torch.float32)
    _assert_fit_equal(tgp, jgp, rtol=0.0)
    assert tgp.kinv.dtype == torch.float32 and tgp.mask.dtype == torch.bool
    with pytest.raises(KeyError):
        from gpmpc_tpu_torch.convert import gp_state_from_numpy
        gp_state_from_numpy({'x': np.zeros((2, 3))}, tied_lambdas=True,
                            device='cpu')
