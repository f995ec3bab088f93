"""gpmpc_tpu_torch.dynamics.rollout_batched against gpmpc_tpu's at f64,
rtol 1e-8: means, covariances and d/du, tied and untied, delta dynamics,
the frozen-covariance and mean-only surrogates; the raise on a nominal mean
model. The full-covariance rollout is in tests/test_torch_fullcov.py."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu import dynamics as jd
from gpmpc_tpu_torch import dynamics as td
from torch_port_common import jax_gp, np_, port_gp, t64, untied_log_lambdas

torch.set_num_threads(1)
RTOL = 1e-8


def _setup(tied, b=3, h=4, seed=0):
    jgp = jax_gp(n=20, cap=32, seed=seed,
                 log_lambdas=None if tied else untied_log_lambdas())
    jcache = jd.build_rollout_cache(jgp, 2, 1)
    tcache = td.build_rollout_cache(port_gp(jgp), 2, 1)
    rng = np.random.default_rng(seed + 7)
    x0s = rng.uniform(-1, 1, (b, 2))
    us = rng.uniform(-1, 1, (b, h, 1))
    return jcache, tcache, x0s, us


def test_cache_matches():
    jcache, tcache, _, _ = _setup(True)
    assert tcache.tied_lambdas is True
    np.testing.assert_allclose(np_(tcache.b_lam), np.asarray(jcache.b_lam),
                               rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize('tied,delta,mode',
                         [(True, False, 'full'), (False, False, 'full'),
                          (True, True, 'full'), (False, True, 'full'),
                          (True, False, 'mean_only'), (True, True, 'frozen')])
def test_rollout_batched_matches(tied, delta, mode):
    jcache, tcache, x0s, us = _setup(tied, seed=1 if delta else 0)
    b, h = us.shape[:2]
    frozen = (np.random.default_rng(3).uniform(1e-3, 0.05, (b, h + 1, 2))
              if mode == 'frozen' else None)
    kw = dict(delta=delta, mean_only=mode == 'mean_only')
    w = np.random.default_rng(4).normal(size=(b, h + 1, 2))

    def jf(u):
        m, c = jd.rollout_batched(
            jcache, jnp.asarray(x0s), u,
            frozen_cov_diag=None if frozen is None else jnp.asarray(frozen), **kw)
        return jnp.sum(m * w) + jnp.sum(jnp.diagonal(c, axis1=2, axis2=3) ** 2) * 10, (m, c)

    (_, (mj, cj)), gj = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(us))
    ut = t64(us).requires_grad_()
    mt, ct = td.rollout_batched(
        tcache, t64(x0s), ut,
        frozen_cov_diag=None if frozen is None else t64(frozen), **kw)
    loss = (torch.sum(mt * t64(w))
            + torch.sum(torch.diagonal(ct, dim1=2, dim2=3) ** 2) * 10)
    (gt,) = torch.autograd.grad(loss, ut)
    assert mt.shape == (b, h + 1, 2) and ct.shape == (b, h + 1, 2, 2)
    np.testing.assert_allclose(np_(mt), np.asarray(mj), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(np_(gt), np.asarray(gj), rtol=RTOL, atol=1e-14)


def test_full_cov_raises_until_ported():
    """full_cov=True is ported (tests/test_torch_fullcov.py); what still
    raises, as in the JAX package, is the batched rollout of a GP with a
    nominal mean model, full covariance or not."""
    _, tcache, x0s, us = _setup(True)
    nominal = replace(tcache, nominal_fn=lambda xs: xs[:, :2])
    for full_cov in (True, False):
        with pytest.raises(NotImplementedError, match='nominal'):
            td.rollout_batched(nominal, t64(x0s), t64(us), full_cov=full_cov)
