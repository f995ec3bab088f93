"""gpmpc_tpu_torch.gp.state's append, grow, set_hyperparams and eigh backend
against gpmpc_tpu.gp.state at f64 (the counterparts of tests/test_gp.py's
append, grow and hyperparameter tests), rtol 1e-8 on kinv, beta and logdet."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpmpc_tpu.gp import exact as jexact
from gpmpc_tpu.gp import state as gs
from gpmpc_tpu_torch.gp import exact as texact
from gpmpc_tpu_torch.gp import state as ts
from torch_port_common import np_, spd, t64

torch.set_num_threads(1)
RTOL = 1e-8
FIT = ('x', 'y', 'mask', 'count', 'log_lambdas', 'log_sigma_f',
       'log_sigma_n', 'kinv', 'beta', 'logdet')


def _data(n, seed=42, d=3, e=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, (n, d)), rng.normal(size=(n, e))


def _pair(cap, x=None, y=None, backend='chol', **hp):
    d, e = 3, 2
    jgp = gs.make_gp(gs.GPConfig(capacity=cap, x_dim=d, out_dim=e,
                                 solve_backend=backend), x, y,
                     dtype=jnp.float64, **hp)
    tgp = ts.make_gp(ts.GPConfig(capacity=cap, x_dim=d, out_dim=e,
                                 solve_backend=backend), x, y,
                     dtype=torch.float64, device='cpu', **hp)
    return jgp, tgp


def _assert_equal(tgp, jgp, rtol=RTOL, fields=FIT):
    for name in fields:
        np.testing.assert_allclose(
            np_(getattr(tgp, name)).astype(np.float64),
            np.asarray(getattr(jgp, name), np.float64), rtol=rtol,
            atol=1e-12, err_msg=name)
    assert tgp.config.tied_lambdas == bool(jgp.config.tied_lambdas)
    assert tgp.config.capacity == jgp.config.capacity


@pytest.mark.parametrize('alias', [False, True])
def test_append_rows_matches_jax(alias):
    """One row at a time (tensor and numpy rows), equal to JAX's and to the
    batch fit."""
    x, y = _data(10)
    jgp, tgp = _pair(16)
    t_append = ts.gp_append if alias else ts.append
    for i in range(10):
        jgp = gs.append(jgp, x[i], y[i])
        tgp = t_append(tgp, t64(x[i]) if i % 2 else x[i], y[i])
    _assert_equal(tgp, jgp)
    _, t_batch = _pair(16, x, y)
    np.testing.assert_allclose(np_(tgp.beta), np_(t_batch.beta), atol=1e-9)
    assert int(tgp.count) == 10


def test_append_matrix_matches_jax():
    x, y = _data(12)
    jgp, tgp = _pair(20, x[:5], y[:5], log_sigma_n=np.log(0.1))
    _assert_equal(ts.append(tgp, x[5:], y[5:]), gs.append(jgp, x[5:], y[5:]))


@pytest.mark.parametrize('start', [0, 2, 4])
def test_append_overflow_drops(start):
    """Rows past the capacity are dropped, one at a time or in one matrix
    that straddles the capacity; the kept rows are the first ones."""
    x, y = _data(7)
    jgp, tgp = _pair(4, x[:start] if start else None,
                     y[:start] if start else None)
    if start == 2:
        jgp, tgp = gs.append(jgp, x[2:7], y[2:7]), ts.append(tgp, x[2:7], y[2:7])
    else:
        for i in range(start, 7):
            jgp, tgp = gs.append(jgp, x[i], y[i]), ts.append(tgp, x[i], y[i])
    assert int(tgp.count) == 4
    np.testing.assert_allclose(np_(tgp.x), x[:4], atol=1e-12)
    np.testing.assert_allclose(np_(tgp.y), y[:4].T, atol=1e-12)
    assert bool(tgp.mask.all())
    if start != 2:
        _assert_equal(tgp, jgp)


def test_grow_matches_jax():
    x, y = _data(8)
    jgp, tgp = _pair(8, x, y, log_lambdas=np.log([1.0, 2.0, 1.5]))
    jg2, tg2 = gs.grow(jgp, 16), ts.grow(tgp, 16)
    _assert_equal(tg2, jg2)
    xp = np.random.default_rng(1).uniform(-2, 2, (3, 3))
    np.testing.assert_allclose(np_(texact.predict(tg2, t64(xp))[0]),
                               np_(texact.predict(tgp, t64(xp))[0]), atol=1e-9)
    with pytest.raises(ValueError):
        ts.grow(tgp, 4)


@pytest.mark.parametrize('lambdas', [[2.0, 2.0, 2.0], 1.5,
                                     [[1.0, 2.0, 3.0], [1.0, 2.0, 3.0]],
                                     [[1.0, 2.0, 3.0], [2.0, 2.0, 3.0]]])
def test_set_hyperparams_matches_jax(lambdas):
    """Refit, tied re-detection (rows equal or broadcast tie; differing rows
    untie)."""
    x, y = _data(25)
    jgp, tgp = _pair(32, x, y, log_lambdas=np.log([[1.0, 3.0, 1.0],
                                                   [2.0, 1.0, 1.0]]),
                     log_sigma_n=np.log(0.1))
    assert not tgp.config.tied_lambdas
    jg2 = gs.set_hyperparams(jgp, lambdas=lambdas, sigma_f=1.5, sigma_n=0.01)
    tg2 = ts.set_hyperparams(tgp, lambdas=lambdas, sigma_f=1.5, sigma_n=0.01)
    _assert_equal(tg2, jg2)
    np.testing.assert_allclose(np_(texact.log_marginal_likelihood(tg2)),
                               np.asarray(jexact.log_marginal_likelihood(jg2)),
                               rtol=RTOL)


def test_set_hyperparams_no_refit():
    x, y = _data(10)
    jgp, tgp = _pair(16, x, y)
    jg2 = gs.set_hyperparams(jgp, sigma_n=0.3, refit=False)
    tg2 = ts.set_hyperparams(tgp, sigma_n=torch.tensor(0.3, dtype=torch.float64),
                             refit=False)
    _assert_equal(tg2, jg2)
    np.testing.assert_allclose(np_(tg2.sigma_n), 0.3, rtol=1e-12)
    np.testing.assert_array_equal(np_(tg2.beta), np_(tgp.beta))


@pytest.mark.parametrize('sigma_n', [0.1, 1e-4])
def test_eigh_backend_matches_jax(sigma_n):
    """The spectrum-clipped eigh fit, at a well- and an ill-conditioned
    noise level, and its append."""
    x, y = _data(20)
    hp = dict(log_lambdas=np.log([1.0, 2.0, 1.5]), log_sigma_n=np.log(sigma_n))
    jgp, tgp = _pair(24, x[:18], y[:18], backend='eigh', **hp)
    # The clip floor is N eps w_max; the fit errs like eps cond(Ky).
    rtol = RTOL if sigma_n > 1e-2 else 1e-5
    _assert_equal(tgp, jgp, rtol=rtol)
    np.testing.assert_allclose(np_(tgp.jitter_used),
                               np.asarray(jgp.jitter_used), rtol=1e-6)
    _assert_equal(ts.append(tgp, x[18:], y[18:]),
                  gs.append(jgp, x[18:], y[18:]), rtol=rtol)
    _, t_chol = _pair(24, x[:18], y[:18], **hp)
    if sigma_n > 1e-2:
        np.testing.assert_allclose(np_(tgp.beta), np_(t_chol.beta), rtol=1e-7)


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        _pair(8, *_data(4), backend='lu')


def test_predict_with_nominal_model_matches_jax():
    """A GP with a nominal mean fits the residual and predicts f_nom(x*) plus
    the residual GP's mean (tests/test_gp.py's TestNominalModel), after an
    append."""
    import jax.numpy as jnp_
    x, y = _data(20)

    def j_nom(xs):
        return jnp_.stack([xs[:, 0] * 0.5, jnp_.sin(xs[:, 1])], axis=1)

    def t_nom(xs):
        return torch.stack([xs[:, 0] * 0.5, torch.sin(xs[:, 1])], dim=1)

    jgp = gs.make_gp(gs.GPConfig(capacity=24, x_dim=3, out_dim=2,
                                 nominal_fn=j_nom), x[:15], y[:15],
                     dtype=jnp.float64)
    tgp = ts.make_gp(ts.GPConfig(capacity=24, x_dim=3, out_dim=2,
                                 nominal_fn=t_nom), x[:15], y[:15],
                     dtype=torch.float64, device='cpu')
    jgp, tgp = gs.append(jgp, x[15:], y[15:]), ts.append(tgp, x[15:], y[15:])
    _assert_equal(tgp, jgp)
    xp = np.random.default_rng(2).uniform(-2, 2, (5, 3))
    for full_cov in (False, True):
        tm, tc = texact.predict(tgp, t64(xp), full_cov=full_cov)
        jm, jc = jexact.predict(jgp, jnp.asarray(xp), full_cov=full_cov)
        np.testing.assert_allclose(np_(tm), np.asarray(jm), rtol=RTOL,
                                   atol=1e-12)
        np.testing.assert_allclose(np_(tc), np.asarray(jc), rtol=1e-7,
                                   atol=1e-10)


def _jitter_matrices():
    """Four masked Ky-like matrices (N = 6, the last row padded) whose
    Cholesky needs 0, 1 and 3 jitter escalations and one that exhausts
    them: a dense SPD block, then diagonal blocks with one pivot -delta,
    delta below eps0 = 10 eps mean(diag) (~1.8e-15), between its 100x and
    its 1,000x, and far past its 1e7 x (the last escalation)."""
    rng = np.random.default_rng(7)
    n = 6
    mask = np.arange(n) < n - 1
    mats = [np.eye(n)]
    mats[0][:5, :5] = spd(rng, (), 5)
    for delta in (1e-15, 1e-13, 1.0):
        m = np.eye(n)
        m[4, 4] = -delta
        mats.append(m)
    return np.stack(mats), mask, rng.normal(size=(4, n)) * mask


def test_jitter_search_matches_jax_find_jitter():
    """The port's search over all four matrices at once (each its own
    escalation, the finished ones kept) against JAX's `_solve_chol` on each:
    jitters equal, beta and kinv at rtol 1e-10, NaN where both run out."""
    ky, mask, resid = _jitter_matrices()
    kinv_t, beta_t, logdet_t, j_t = ts._solve_chol(
        t64(ky), t64(mask.astype(np.float64)), t64(resid), 0.0, True)
    escalations = []
    for k in range(4):
        kinv_j, beta_j, logdet_j, j_j = gs._solve_chol(
            jnp.asarray(ky[k]), jnp.asarray(mask), jnp.asarray(resid[k]), 0.0)
        assert float(j_t[k]) == float(j_j)
        for got, want in ((kinv_t[k], kinv_j), (beta_t[k], beta_j),
                          (logdet_t[k], logdet_j)):
            np.testing.assert_allclose(np_(got), np.asarray(want),
                                       rtol=1e-10, atol=1e-14)
        eps0 = 10 * np.finfo(np.float64).eps * np.sum(
            np.diagonal(ky[k]) * mask) / mask.sum()
        escalations.append(0 if float(j_j) == 0.0
                           else round(np.log10(float(j_j) / eps0)) + 1)
    assert escalations == [0, 1, 3, 8]
    assert np.all(np.isnan(np_(beta_t[3]))) and np.all(np.isnan(np_(kinv_t[3])))
    assert np.all(np.isfinite(np_(beta_t[:3])))


def test_host_read_search_stops_when_all_factorize():
    """The CPU's form of the search reads all(done) on the host once an
    escalation (utils/replay_counts.HOST_READS): four reads for matrices
    that need at most three escalations, eight where one runs out."""
    from gpmpc_tpu_torch.utils import replay_counts
    ky, mask, _ = _jitter_matrices()
    dmask = t64(np.broadcast_to(mask, (4, 6)).astype(np.float64))
    eps0 = 10 * np.finfo(np.float64).eps * (
        np.sum(np.diagonal(ky, axis1=1, axis2=2) * mask, axis=1) / mask.sum())
    for n, reads in ((3, 4), (4, 8)):
        before = replay_counts.HOST_READS
        ts.find_jitter(t64(ky[:n]), dmask[:n], t64(eps0[:n]), 0.0)
        assert replay_counts.HOST_READS - before == reads


def test_stacked_fit_matches_per_lane_fits():
    """A GPState stacked over three lanes with different data: one append of
    a row a lane and its fit (all lanes' matrices in one search) against each
    lane's own append and fit."""
    from gpmpc_tpu_torch.parallel.batch import stack_gps
    lanes = [_pair(12, *_data(n, seed=n))[1] for n in (5, 7, 9)]
    rng = np.random.default_rng(3)
    xn, yn = t64(rng.uniform(-2, 2, (3, 3))), t64(rng.normal(size=(3, 2)))
    stacked = ts.append(stack_gps(lanes), xn, yn)
    assert stacked.kinv.shape == (3, 2, 12, 12)
    np.testing.assert_array_equal(np_(stacked.count), [6, 8, 10])
    for b, gp in enumerate(lanes):
        one = ts.append(gp, xn[b], yn[b])
        for name in ('x', 'y', 'mask', 'count', 'kinv', 'beta', 'logdet',
                     'jitter_used'):
            np.testing.assert_allclose(
                np_(getattr(stacked, name)[b]).astype(np.float64),
                np_(getattr(one, name)).astype(np.float64), rtol=1e-12,
                atol=1e-14, err_msg=f'lane {b} {name}')
