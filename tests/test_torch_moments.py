"""gpmpc_tpu_torch.ops.moments against gpmpc_tpu.ops.moments at f64, rtol 1e-8:
values and gradients of the batched diagonal moment ops, tied and untied,
and the NaN lengthscale cotangent of the tied paths."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu.ops import moments as jm
from gpmpc_tpu_torch.ops import moments as tm
from torch_port_common import jax_gp, np_, t64, untied_log_lambdas

torch.set_num_threads(1)
RTOL = 1e-8


def _inputs(tied, b=4, seed=0):
    jgp = jax_gp(n=20, cap=32, seed=seed,
                 log_lambdas=None if tied else untied_log_lambdas())
    rng = np.random.default_rng(seed + 100)
    u = rng.uniform(-1, 1, (b, 3))
    s = rng.uniform(0.01, 0.2, (b, 3))
    blam = jax.vmap(jm.make_variance_cache, in_axes=(None, 0, 0, 0, 0, None))(
        jgp.x, jgp.beta, jgp.kinv, jgp.log_lambdas, jgp.log_sigma_f,
        jgp.mask).b_lam
    return jgp, u, s, blam


def test_make_variance_cache_matches():
    jgp, _, _, blam = _inputs(False)
    got = tm.make_variance_cache(t64(jgp.x), t64(jgp.beta), t64(jgp.kinv),
                                 t64(jgp.log_lambdas), t64(jgp.log_sigma_f),
                                 torch.tensor(np.asarray(jgp.mask)))
    np.testing.assert_allclose(np_(got), np.asarray(blam), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize('tied', [True, False])
def test_mean_prop_batched_diag_matches(tied):
    jgp, u, s, _ = _inputs(tied)
    jargs = (jgp.x, jgp.beta, jgp.log_lambdas, jgp.log_sigma_f, jgp.mask)
    targs = (t64(jgp.x), t64(jgp.beta), t64(jgp.log_lambdas),
             t64(jgp.log_sigma_f), torch.tensor(np.asarray(jgp.mask)))
    w = np.random.default_rng(1).normal(size=(4, 2))

    def jloss(u_, s_):
        m, l = jm.mean_prop_batched_diag(u_, s_, *jargs, tied=tied)
        return jnp.sum(m * w) + jnp.sum(l ** 2), (m, l)

    (_, (mj, lj)), (guj, gsj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(u), jnp.asarray(s))
    ut, st = t64(u).requires_grad_(), t64(s).requires_grad_()
    mt, lt = tm.mean_prop_batched_diag(ut, st, *targs, tied=tied)
    gut, gst = torch.autograd.grad(torch.sum(mt * t64(w)) + torch.sum(lt ** 2),
                                   (ut, st))
    for got, want in ((mt, mj), (lt, lj), (gut, guj), (gst, gsj)):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                                   atol=1e-14)


def test_input_output_cov_batched_diag_matches():
    jgp, u, s, _ = _inputs(False)
    _, lj = jm.mean_prop_batched_diag(jnp.asarray(u), jnp.asarray(s), jgp.x,
                                      jgp.beta, jgp.log_lambdas,
                                      jgp.log_sigma_f, jgp.mask)
    cj = jm.input_output_cov_batched_diag(jnp.asarray(u), jnp.asarray(s), jgp.x,
                                          jgp.beta, lj, jgp.log_lambdas)
    ct = tm.input_output_cov_batched_diag(t64(u), t64(s), t64(jgp.x),
                                          t64(jgp.beta), t64(lj),
                                          t64(jgp.log_lambdas))
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize('tied', [True, False])
def test_variance_prop_multi_batched_diag_matches(tied):
    jgp, u, s, blam = _inputs(tied, seed=2)
    means = np.random.default_rng(3).normal(size=(4, 2)) * 0.1
    w = np.random.default_rng(4).normal(size=(4, 2))

    def jloss(u_, s_):
        v = jm.variance_prop_multi_batched_diag(
            u_, s_, jgp.x, blam, jgp.log_lambdas, jgp.log_sigma_f,
            jnp.asarray(means), tied=tied)
        return jnp.sum(v * w), v

    (_, vj), (guj, gsj) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jnp.asarray(u),
                                                           jnp.asarray(s))
    ut, st = t64(u).requires_grad_(), t64(s).requires_grad_()
    vt = tm.variance_prop_multi_batched_diag(
        ut, st, t64(jgp.x), t64(blam), t64(jgp.log_lambdas),
        t64(jgp.log_sigma_f), t64(means), tied=tied)
    gut, gst = torch.autograd.grad(torch.sum(vt * t64(w)), (ut, st))
    for got, want in ((vt, vj), (gut, guj), (gst, gsj)):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                                   atol=1e-14)


@pytest.mark.parametrize('op', ['mean', 'variance'])
def test_tied_lengthscale_cotangent_is_nan(op):
    """The tied paths share one exp chain, so lengthscale cotangents are not
    attributable: NaN, as the JAX guard gives; untied stays finite."""
    jgp, u, s, blam = _inputs(True)
    outs = {}
    for tied in (True, False):
        ll = t64(jgp.log_lambdas).requires_grad_()
        if op == 'mean':
            m, _ = tm.mean_prop_batched_diag(
                t64(u), t64(s), t64(jgp.x), t64(jgp.beta), ll,
                t64(jgp.log_sigma_f), torch.tensor(np.asarray(jgp.mask)),
                tied=tied)
        else:
            m = tm.variance_prop_multi_batched_diag(
                t64(u), t64(s), t64(jgp.x), t64(blam), ll, t64(jgp.log_sigma_f),
                torch.zeros(4, 2, dtype=torch.float64), tied=tied)
        outs[tied] = np_(torch.autograd.grad(m.sum(), ll)[0])
    assert np.all(np.isnan(outs[True]))
    assert np.all(np.isfinite(outs[False]))
