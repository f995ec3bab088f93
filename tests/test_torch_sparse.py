"""gpmpc_tpu_torch.gp.sparse (FITC) against gpmpc_tpu's at f64, and the
counterparts of tests/test_sparse.py: the fitted state (alpha, W) and the
FITC marginal likelihood with and without padded rows, prediction through
the sparse state, optimize_inducing, Z = X against the exact GP, and
problems.cartpole_data. The rollouts on a sparse state and the suite's
sparse problems are tests/test_torch_sparse_problems.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks import problems as jproblems
from gpmpc_tpu.gp import sparse as jsp
from gpmpc_tpu.gp.exact import predict as jpredict
from gpmpc_tpu_torch import problems as tproblems
from gpmpc_tpu_torch.convert import FIELDS, gp_state_from_numpy
from gpmpc_tpu_torch.gp import sparse as tsp
from gpmpc_tpu_torch.gp.exact import log_marginal_likelihood, predict
from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
from torch_port_common import np_, t64

torch.set_num_threads(1)
RNG = np.random.default_rng(51)
RTOL, ATOL = 1e-8, 1e-10
# W = Kzz^-1 - B^-1 and alpha = B^-1 r come from inverses of matrices of
# condition 1e4-1e6 (Kzz at jitter 1e-6), and W is a difference of two of
# them: the two packages' f64 fits, the same algebra in another rounding
# order, agree entrywise to a tolerance of their largest entry, not of each
# entry (measured: suite config 3b 8e-11 (W) and 4e-10 (alpha), config 4
# 3.3e-8 and 5.2e-8 of the largest; predictions and objectives from them
# agree to 1e-11-2e-9 relative).
POSTERIOR_TOL = 1e-7


def assert_close_to_max(got, want, tol, err_msg=''):
    """|got - want| <= tol * max |want|, entrywise."""
    want = np.asarray(want)
    np.testing.assert_allclose(np_(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=err_msg)


def _data(n=60, d=2, seed=51):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    y = np.stack([np.sin(1.5 * x[:, 0]) + 0.3 * x[:, 1],
                  np.cos(x[:, 1]) - 0.2 * x[:, 0]], axis=1)
    y += 0.05 * rng.normal(size=y.shape)
    return x, y


def _hp(e, d, lam=1.0, sf=1.0, sn=0.1):
    return (np.log(np.full((e, d), lam)), np.log(np.full((e,), sf)),
            np.log(np.full((e,), sn)))


def _fit_both(z, x, y, hp, mask=None, **kw):
    j = jsp.fit_sparse(*(jnp.asarray(v) for v in (z, x, y.T) + hp),
                       mask=None if mask is None else jnp.asarray(mask), **kw)
    t = tsp.fit_sparse(*(t64(v) for v in (z, x, y.T) + hp),
                       mask=None if mask is None else torch.as_tensor(mask),
                       **kw)
    return j, t


@pytest.mark.parametrize('padded', [False, True])
def test_fit_sparse_matches_jax(padded):
    """alpha, W and the FITC ML; with padded rows (mask) the padded columns
    are inert. The state is a GPState over Z, tied when the lengthscale rows
    tie, and converts from JAX's fields (convert.gp_state_from_numpy)."""
    x, y = _data(n=50)
    mask = None
    if padded:
        mask = np.arange(50) < 41
        x[41:], y[41:] = 7.0, -3.0
    z = x[RNG.choice(41, 12, replace=False)]
    (js, jml), (ts, tml) = _fit_both(z, x, y, _hp(2, 2, lam=1.3, sn=0.2),
                                     mask)
    assert_close_to_max(ts.beta, js.beta, 1e-9)
    assert_close_to_max(ts.kinv, js.kinv, 1e-9)
    np.testing.assert_allclose(np_(tml), np.asarray(jml), rtol=RTOL)
    assert ts.config.tied_lambdas and js.config.tied_lambdas
    assert ts.config.capacity == 12 and int(ts.count) == 12
    conv = gp_state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                               tied_lambdas=True, device='cpu',
                               dtype=torch.float64)
    for k in FIELDS:
        np.testing.assert_array_equal(np_(getattr(conv, k)),
                                      np.asarray(getattr(js, k)), err_msg=k)


def test_prediction_through_sparse_state():
    x, y = _data(n=80)
    z = x[RNG.choice(80, 20, replace=False)]
    (js, _), (ts, _) = _fit_both(z, x, y, _hp(2, 2))
    xp = RNG.uniform(-2, 2, (7, 2))
    mj, vj = jpredict(js, jnp.asarray(xp))
    mt, vt = predict(ts, t64(xp))
    np.testing.assert_allclose(np_(mt), np.asarray(mj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(vt), np.asarray(vj), rtol=RTOL, atol=ATOL)


def test_full_inducing_matches_exact():
    """Z = X makes FITC exact (Qff = Kff, Lam = sigma_n^2 I)."""
    x, y = _data(n=30)
    state, ml = tsp.fit_sparse(t64(x), t64(x), t64(y.T),
                               *(t64(v) for v in _hp(2, 2)), jitter=1e-12)
    exact = make_gp(GPConfig(capacity=30, x_dim=2, out_dim=2), x, y,
                    log_sigma_n=np.log(0.1), dtype=torch.float64,
                    device='cpu')
    xp = t64(RNG.uniform(-2, 2, (6, 2)))
    for a, b in zip(predict(state, xp), predict(exact, xp)):
        np.testing.assert_allclose(np_(a), np_(b), atol=1e-6)
    np.testing.assert_allclose(np_(ml), np_(log_marginal_likelihood(exact)),
                               atol=1e-6)


def test_subset_inducing_approximates():
    x, y = _data(n=120)
    gen = torch.Generator().manual_seed(0)
    z = tsp.select_inducing(gen, t64(x), 40)
    assert z.shape == (40, 2)
    state, _ = tsp.fit_sparse(z, t64(x), t64(y.T), *(t64(v) for v in _hp(2, 2)))
    exact = make_gp(GPConfig(capacity=120, x_dim=2, out_dim=2), x, y,
                    log_sigma_n=np.log(0.1), dtype=torch.float64,
                    device='cpu')
    xp = t64(RNG.uniform(-1.5, 1.5, (20, 2)))
    rms = float(torch.sqrt(torch.mean((predict(state, xp)[0]
                                       - predict(exact, xp)[0]) ** 2)))
    assert rms < 0.1, rms


def test_optimize_inducing_matches_jax():
    """A few Adam steps on Z (optax's rule, gp.train.adam_step): the same
    Z and FITC ML as JAX's, and the ML rises."""
    x, y = _data(n=60, d=3)
    hp = _hp(2, 3)
    z0 = x[RNG.choice(60, 8, replace=False)]
    js, jml = jsp.optimize_inducing(
        *(jnp.asarray(v) for v in (z0, x, y.T) + hp), num_iters=12, lr=0.05)
    ts, tml = tsp.optimize_inducing(*(t64(v) for v in (z0, x, y.T) + hp),
                                    num_iters=12, lr=0.05)
    np.testing.assert_allclose(np_(ts.x), np.asarray(js.x), rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(np_(tml), np.asarray(jml), rtol=1e-8)
    _, ml0 = tsp.fit_sparse(*(t64(v) for v in (z0, x, y.T) + hp))
    assert float(tml.sum()) > float(ml0.sum())


def test_optimized_beats_random():
    """tests/test_sparse.py: 120 Adam steps raise the FITC ML by more than 1
    over the random start and improve held-out RMSE."""
    x, y = _data(n=80)
    x_te = RNG.uniform(-2, 2, (40, 2))
    y_te = np.stack([np.sin(1.5 * x_te[:, 0]) + 0.3 * x_te[:, 1],
                     np.cos(x_te[:, 1]) - 0.2 * x_te[:, 0]], axis=1)
    args = [t64(v) for v in (x, y.T) + _hp(2, 2)]
    z0 = tsp.select_inducing(torch.Generator().manual_seed(3), args[0], 8)
    sp0, ml0 = tsp.fit_sparse(z0, *args)
    sp1, ml1 = tsp.optimize_inducing(z0, *args, num_iters=120, lr=0.05)
    assert float(ml1.sum()) > float(ml0.sum()) + 1.0

    def rmse(sp):
        return float(torch.sqrt(torch.mean((predict(sp, t64(x_te))[0]
                                            - t64(y_te)) ** 2)))

    assert rmse(sp1) < rmse(sp0)


def test_cartpole_data_matches_jax():
    xj, nj = jproblems.cartpole_data(40, seed=2)
    xt, nt = tproblems.cartpole_data(40, seed=2)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_allclose(nt, nj, rtol=1e-15, atol=0)


def test_f32_operands_fit_in_f64():
    """f32 operands fit in f64 and round W, alpha and the ML to f32 (as the
    exact GP's fit does): the f64 fit of the same (upcast) operands,
    rounded; suite config 4's f32 fit is finite, where an f32 Cholesky of B
    fails (JAX's f32 fit of it on the CPU returns NaN)."""
    x, y = _data(n=50)
    z = x[RNG.choice(50, 10, replace=False)]
    args = [torch.tensor(v, dtype=torch.float32) for v in (z, x, y.T)
            + _hp(2, 2)]
    s32, ml32 = tsp.fit_sparse(*args)
    s64, ml64 = tsp.fit_sparse(*(a.double() for a in args))
    assert s32.kinv.dtype == ml32.dtype == torch.float32
    for a, b in ((s32.kinv, s64.kinv), (s32.beta, s64.beta), (ml32, ml64)):
        torch.testing.assert_close(a, b.float(), rtol=0, atol=0)
    gp = tproblems.make_sparse_fullcov_problem(b=2, dtype=torch.float32,
                                               device='cpu').gp
    assert bool(torch.isfinite(gp.kinv).all() and torch.isfinite(gp.beta).all())
