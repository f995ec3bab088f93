"""gpmpc_tpu_torch.utils (linalg, smallchol) against gpmpc_tpu.utils at f64,
rtol 1e-8."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.utils import linalg as jl
from gpmpc_tpu.utils import smallchol as jsc
from gpmpc_tpu_torch.utils import linalg as tl
from gpmpc_tpu_torch.utils import smallchol as tsc
from torch_port_common import np_, spd, t64

torch.set_num_threads(1)
RTOL = 1e-8


def test_sq_dists():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(7, 3)), rng.normal(size=(5, 3))
    np.testing.assert_allclose(np_(tl.sq_dists(t64(a), t64(b))),
                               np.asarray(jl.sq_dists(jnp.asarray(a),
                                                      jnp.asarray(b))),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize('diag_add', [0.01, 'per_output'])
def test_masked_psd_add(diag_add):
    rng = np.random.default_rng(1)
    k = spd(rng, (2,), 6)
    mask = np.arange(6) < 4
    if diag_add == 'per_output':
        add = np.array([0.01, 0.3])
        ref = np.stack([np.asarray(jl.masked_psd_add(jnp.asarray(k[e]),
                                                     jnp.asarray(mask), add[e]))
                        for e in range(2)])
    else:
        add = diag_add
        ref = np.stack([np.asarray(jl.masked_psd_add(jnp.asarray(k[e]),
                                                     jnp.asarray(mask), add))
                        for e in range(2)])
    got = tl.masked_psd_add(t64(k), torch.as_tensor(mask), t64(add))
    np.testing.assert_allclose(np_(got), ref, rtol=RTOL)


def test_chol_solve_inverse_logdet():
    rng = np.random.default_rng(2)
    a = spd(rng, (), 6, scale=1.0)
    b = rng.normal(size=(6, 2))
    lj = jnp.linalg.cholesky(jnp.asarray(a))
    lt = torch.linalg.cholesky(t64(a))
    np.testing.assert_allclose(np_(tl.chol_solve(lt, t64(b))),
                               np.asarray(jl.chol_solve(lj, jnp.asarray(b))),
                               rtol=RTOL)
    np.testing.assert_allclose(np_(tl.chol_solve(lt, t64(b[:, 0]))),
                               np.asarray(jl.chol_solve(lj, jnp.asarray(b[:, 0]))),
                               rtol=RTOL)
    np.testing.assert_allclose(np_(tl.chol_inverse(lt)),
                               np.asarray(jl.chol_inverse(lj)), rtol=RTOL)
    np.testing.assert_allclose(float(tl.chol_logdet(lt)),
                               float(jl.chol_logdet(lj)), rtol=RTOL)


@pytest.mark.parametrize('d', [1, 2, 3, 6, 8])
def test_smallchol_matches(d):
    rng = np.random.default_rng(d)
    a = spd(rng, (4, 3), d, scale=0.5)
    b = rng.normal(size=(4, 3, d, 2))
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), t64(a), t64(b)
    lj, lt = jsc.chol_small(ja), tsc.chol_small(ta)
    np.testing.assert_allclose(np_(lt), np.asarray(lj), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(np_(tsc.solve_lower_small(lt, tb)),
                               np.asarray(jsc.solve_lower_small(lj, jb)),
                               rtol=RTOL)
    np.testing.assert_allclose(np_(tsc.solve_upper_small(lt, tb)),
                               np.asarray(jsc.solve_upper_small(lj, jb)),
                               rtol=RTOL)
    np.testing.assert_allclose(np_(tsc.solve_psd_small(ta, tb)),
                               np.asarray(jsc.solve_psd_small(ja, jb)),
                               rtol=RTOL)
    np.testing.assert_allclose(np_(tsc.solve_psd_small(ta, tb[..., 0])),
                               np.asarray(jsc.solve_psd_small(ja, jb[..., 0])),
                               rtol=RTOL)
    np.testing.assert_allclose(np_(tsc.logdet_psd_small(ta)),
                               np.asarray(jsc.logdet_psd_small(ja)), rtol=RTOL)


def test_smallchol_non_pd_gives_nan_diagonal():
    """The cost's PD-cone test reads a NaN diagonal: same places as JAX."""
    a = np.array([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.5], [0.5, 1.0]]])
    lj = np.asarray(jsc.chol_small(jnp.asarray(a)))
    lt = np_(tsc.chol_small(t64(a)))
    np.testing.assert_array_equal(np.isnan(np.diagonal(lt, axis1=-2, axis2=-1)),
                                  np.isnan(np.diagonal(lj, axis1=-2, axis2=-1)))
    assert np.isnan(lt[0, 1, 1]) and np.all(np.isfinite(lt[1]))


def test_smallchol_rejects_large_d():
    with pytest.raises(ValueError):
        tsc.chol_small(torch.eye(9, dtype=torch.float64))
