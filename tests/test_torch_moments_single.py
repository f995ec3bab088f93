"""The single-scenario forms of gpmpc_tpu_torch against gpmpc_tpu at f64 on
the CPU: the single-input moment ops of ops/moments.py in value and gradient
(rtol 1e-8), `rollout` and `rollout_from_gp` with a diagonal and a full
covariance, with and without delta dynamics; the Monte Carlo checks of
tests/test_moments.py (same sample counts and tolerances) on the port; and
the nominal-model cases of tests/test_nominal.py that need no controller,
with the port's nominal model in torch."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracles
from gpmpc_tpu import dynamics as jd
from gpmpc_tpu.gp import state as gs
from gpmpc_tpu.ops import moments as jm
from gpmpc_tpu_torch import dynamics as td
from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
from gpmpc_tpu_torch.ops import moments as tm
from torch_port_common import (jax_gp, np_, port_gp, spd, t64,
                               untied_log_lambdas)

torch.set_num_threads(1)
RTOL = 1e-8


def _inputs(tied, seed):
    jgp = jax_gp(n=20, cap=32, seed=seed,
                 log_lambdas=None if tied else untied_log_lambdas())
    rng = np.random.default_rng(seed + 30)
    u = rng.uniform(-1, 1, 3)
    s = spd(rng, (), 3, scale=0.02) * 0.05
    return jgp, u, s, rng.normal(size=2) * 0.1


def _single_ops(jgp, means):
    """(jax fn, torch fn) of (u, S) for each single-input op; output 0 for
    the per-output ops, the pair (0, 1) for covariance_prop."""
    j = {k: getattr(jgp, k) for k in ('x', 'beta', 'kinv', 'log_lambdas',
                                      'log_sigma_f', 'mask')}
    t = {k: (torch.tensor(np.asarray(v)) if k == 'mask' else t64(v))
         for k, v in j.items()}
    blam_j = jd.build_rollout_cache(jgp, 2, 1).b_lam
    blam_t = t64(blam_j)

    def both(fn):
        return (lambda u, s: fn(jm, j, blam_j, jnp.asarray(means), u, s),
                lambda u, s: fn(tm, t, blam_t, t64(means), u, s))

    def mean(m, g, _b, _mn, u, s):
        return m.mean_prop(u, s, g['x'], g['beta'][0], g['log_lambdas'][0],
                           g['log_sigma_f'][0], g['mask'])[1]

    def io_cov(m, g, _b, _mn, u, s):
        _, l = m.mean_prop(u, s, g['x'], g['beta'][0], g['log_lambdas'][0],
                           g['log_sigma_f'][0], g['mask'])
        return m.input_output_cov(u, s, g['x'], g['beta'][0], l,
                                  g['log_lambdas'][0])

    def var_cached(m, g, b, mn, u, s):
        cache = b[0] if m is tm else jm.VarianceCache(b_lam=b[0])
        return m.variance_prop_cached(u, s, g['x'], cache, g['log_lambdas'][0],
                                      g['log_sigma_f'][0], mn[0])

    def var(m, g, _b, mn, u, s):
        return m.variance_prop(u, s, g['x'], g['beta'][0], g['kinv'][0],
                               g['log_lambdas'][0], g['log_sigma_f'][0],
                               g['mask'], mn[0])

    def var_multi(m, g, b, mn, u, s):
        return m.variance_prop_multi(u, s, g['x'], b, g['log_lambdas'],
                                     g['log_sigma_f'], mn)

    def cov(m, g, _b, mn, u, s):
        return m.covariance_prop(u, s, g['x'], g['beta'][0], g['beta'][1],
                                 g['log_lambdas'][0], g['log_lambdas'][1],
                                 g['log_sigma_f'][0], g['log_sigma_f'][1],
                                 g['mask'], mn[0], mn[1])

    return {name: both(fn) for name, fn in (
        ('mean_prop', mean), ('input_output_cov', io_cov),
        ('variance_prop_cached', var_cached), ('variance_prop', var),
        ('variance_prop_multi', var_multi), ('covariance_prop', cov))}


@pytest.mark.parametrize('tied', [True, False])
@pytest.mark.parametrize('op', ['mean_prop', 'input_output_cov',
                                'variance_prop_cached', 'variance_prop',
                                'variance_prop_multi', 'covariance_prop'])
def test_single_input_op_matches_jax(op, tied):
    jgp, u, s, means = _inputs(tied, seed=1)
    jfn, tfn = _single_ops(jgp, means)[op]
    out_j = np.asarray(jfn(jnp.asarray(u), jnp.asarray(s)))
    w = np.random.default_rng(2).normal(size=out_j.shape)
    gj = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * w), argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(s))
    ut, st = t64(u).requires_grad_(), t64(s).requires_grad_()
    out_t = tfn(ut, st)
    gt = torch.autograd.grad(torch.sum(out_t * t64(w)), (ut, st))
    np.testing.assert_allclose(np_(out_t), out_j, rtol=RTOL, atol=1e-14)
    for got, want in zip(gt, gj):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                                   atol=1e-13)


@pytest.mark.parametrize('tied,full_cov,delta',
                         [(True, False, False), (True, False, True),
                          (True, True, False), (False, True, False),
                          (False, True, True)])
def test_rollout_matches_jax(tied, full_cov, delta):
    jgp = jax_gp(n=20, cap=32, seed=4,
                 log_lambdas=None if tied else untied_log_lambdas())
    rng = np.random.default_rng(5)
    x0, us = rng.uniform(-1, 1, 2), rng.uniform(-1, 1, (4, 1))
    jcache = jd.build_rollout_cache(jgp, 2, 1)
    w = rng.normal(size=(5, 2))

    def jf(u):
        m, c = jd.rollout(jcache, jnp.asarray(x0), u, full_cov=full_cov,
                          delta=delta)
        return jnp.sum(m * w) + 10 * jnp.sum(c ** 2), (m, c)

    (_, (mj, cj)), gj = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(us))
    ut = t64(us).requires_grad_()
    mt, ct = td.rollout_from_gp(port_gp(jgp), 2, 1, t64(x0), ut,
                                full_cov=full_cov, delta=delta)
    (gt,) = torch.autograd.grad(torch.sum(mt * t64(w)) + 10 * torch.sum(ct ** 2),
                                ut)
    assert mt.shape == (5, 2) and ct.shape == (5, 2, 2)
    # The off-diagonal entries (m1 m2 subtracted from beta^T Qt beta) cancel
    # to ~1e-4: atol 1e-12 there, under tests/test_batched.py's 1e-10.
    np.testing.assert_allclose(np_(mt), np.asarray(mj), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(np_(gt), np.asarray(gj), rtol=RTOL, atol=1e-13)


def test_rollout_batched_diag_equals_rollout_loop():
    """The batched diagonal rollout equals `rollout` over each lane
    (tests/test_batched.py's bars)."""
    tcache = td.build_rollout_cache(port_gp(jax_gp(n=20, cap=32, seed=6)), 2, 1)
    rng = np.random.default_rng(7)
    x0s, us = rng.uniform(-1, 1, (3, 2)), rng.uniform(-1, 1, (3, 4, 1))
    for delta in (False, True):
        mb, cb = td.rollout_batched(tcache, t64(x0s), t64(us), delta=delta)
        for k in range(3):
            m1, c1 = td.rollout(tcache, t64(x0s[k]), t64(us[k]), delta=delta)
            np.testing.assert_allclose(np_(mb[k]), np_(m1), rtol=1e-8,
                                       atol=1e-10)
            np.testing.assert_allclose(np_(cb[k]), np_(c1), rtol=1e-8,
                                       atol=1e-10)


# ------------------------------------------------------- Monte Carlo --
def _port_gp(x, y, log_lambdas, sf, sn, cap=16):
    return make_gp(GPConfig(capacity=cap, x_dim=x.shape[1], out_dim=y.shape[1]),
                   x, y, log_lambdas=log_lambdas, log_sigma_f=np.log(sf),
                   log_sigma_n=np.log(sn), dtype=torch.float64, device='cpu')


def test_mean_and_variance_mc():
    """tests/test_moments.py's Monte Carlo check on the port: 10,000 draws
    through the true GP predictive; mean within 2 %, variance within 5 %."""
    rng = np.random.default_rng(31)
    n, d = 15, 2
    x = rng.uniform(-2, 2, (n, d))
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1]
    lam, sf, sn = np.array([1.0, 1.5]), 1.2, 0.05
    u, S = np.array([0.3, -0.2]), np.array([[0.15, 0.03], [0.03, 0.1]])
    mc = np.random.default_rng(0)
    _, ky_inv, beta = oracles.gp_fit(x, y, lam, sf, sn)
    ks = oracles.gram(mc.multivariate_normal(u, S, size=10000), x, lam, sf)
    mus = ks @ beta
    mc_mean = mus.mean()
    mc_var = (sf ** 2 - np.einsum('tn,nm,tm->t', ks, ky_inv, ks)).mean() + mus.var()

    gp = _port_gp(x, y[:, None], np.log(lam), sf, sn)
    args = (gp.x, gp.beta[0], gp.log_lambdas[0], gp.log_sigma_f[0])
    m, _ = tm.mean_prop(t64(u), t64(S), *args, gp.mask)
    v = tm.variance_prop(t64(u), t64(S), gp.x, gp.beta[0], gp.kinv[0],
                         gp.log_lambdas[0], gp.log_sigma_f[0], gp.mask, m)
    assert abs(float(m) - mc_mean) / abs(mc_mean) < 0.02
    assert abs(float(v) - mc_var) / abs(mc_var) < 0.05


def test_covariance_mc():
    """tests/test_moments.py's cross-covariance check on the port: equal to
    the loop oracle (atol 1e-9) and to 10,000 Monte Carlo draws (atol 0.02,
    that test's tolerance)."""
    rng = np.random.default_rng(32)
    n, d = 15, 2
    x = rng.uniform(-2, 2, (n, d))
    y1 = np.sin(x[:, 0]) + 0.3 * x[:, 1]
    y2 = np.cos(x[:, 1]) - 0.2 * x[:, 0]
    lam1, lam2 = np.array([1.0, 1.5]), np.array([0.8, 1.2])
    sf, sn = 1.0, 0.05
    u, S = np.array([0.3, -0.2]), np.array([[0.15, 0.03], [0.03, 0.1]])
    mc = np.random.default_rng(3)
    xs = mc.multivariate_normal(u, S, size=10000)
    draws = []
    for y, lam in ((y1, lam1), (y2, lam2)):
        _, ki, b = oracles.gp_fit(x, y, lam, sf, sn)
        k = oracles.gram(xs, x, lam, sf)
        sd = np.sqrt(np.maximum(sf ** 2 - np.einsum('tn,nm,tm->t', k, ki, k), 0))
        draws.append((k @ b, sd, b))
    f1, f2 = (mc.normal(mu, sd) for mu, sd, _ in draws)
    mc_cov = np.cov(f1, f2)[0, 1]
    m1_ref, _ = oracles.mean_prop(u, S, x, draws[0][2], lam1, sf)
    m2_ref, _ = oracles.mean_prop(u, S, x, draws[1][2], lam2, sf)
    c_ref = oracles.covariance_prop(u, S, x, draws[0][2], draws[1][2], lam1,
                                    lam2, sf, sf, m1_ref, m2_ref)

    gp = _port_gp(x, np.stack([y1, y2], 1),
                  np.stack([np.log(lam1), np.log(lam2)]), sf, sn)
    ms = [tm.mean_prop(t64(u), t64(S), gp.x, gp.beta[k], gp.log_lambdas[k],
                       gp.log_sigma_f[k], gp.mask)[0] for k in range(2)]
    c = tm.covariance_prop(t64(u), t64(S), gp.x, gp.beta[0], gp.beta[1],
                           gp.log_lambdas[0], gp.log_lambdas[1],
                           gp.log_sigma_f[0], gp.log_sigma_f[1], gp.mask, *ms)
    np.testing.assert_allclose(float(c), c_ref, atol=1e-9)
    np.testing.assert_allclose(float(c), mc_cov, atol=0.02)


# ----------------------------------------------------- nominal model --
A_NOM = np.array([[0.9, 0.1], [-0.08, 0.85]])
B_NOM = np.array([[0.0], [0.12]])


def _nominal_j(xs):
    return xs[:, :2] @ jnp.asarray(A_NOM).T + xs[:, 2:] @ jnp.asarray(B_NOM).T


def _nominal_t(xs):
    return xs[:, :2] @ t64(A_NOM).T + xs[:, 2:] @ t64(B_NOM).T


def _truth(s, a):
    return (A_NOM @ s + B_NOM @ a
            + 0.25 * np.array([np.sin(s[0]), np.cos(2 * s[1])]))


def _residual_gps(n, seed=23):
    """tests/test_nominal.py's residual GP, in both packages: the JAX one and
    the port's own fit of the same data under the torch nominal model."""
    rng = np.random.default_rng(seed)
    states = rng.uniform(-2, 2, (n, 2))
    actions = rng.uniform(-1, 1, (n, 1))
    nxt = np.stack([_truth(s, a) for s, a in zip(states, actions)])
    x = np.concatenate([states, actions], axis=1)
    kw = dict(log_lambdas=np.log([2.0] * 3), log_sigma_f=np.log(0.5),
              log_sigma_n=np.log(0.05))
    jgp = gs.make_gp(gs.GPConfig(capacity=64, x_dim=3, out_dim=2,
                                 nominal_fn=_nominal_j), x, nxt,
                     dtype=jnp.float64, **kw)
    tgp = make_gp(GPConfig(capacity=64, x_dim=3, out_dim=2,
                           nominal_fn=_nominal_t), x, nxt,
                  dtype=torch.float64, device='cpu', **kw)
    return jgp, tgp


@pytest.mark.parametrize('full_cov', [False, True])
def test_nominal_rollout_matches_jax(full_cov):
    """The EKF terms of the nominal model: the port's fit and rollout against
    JAX's, value and gradient."""
    jgp, tgp = _residual_gps(40)
    np.testing.assert_allclose(np_(tgp.beta), np.asarray(jgp.beta), rtol=1e-8,
                               atol=1e-12)
    x0 = np.array([0.4, -0.3])
    us = np.random.default_rng(24).uniform(-0.5, 0.5, (3, 1))
    jcache = jd.build_rollout_cache(jgp, 2, 1)

    def jf(u):
        m, c = jd.rollout(jcache, jnp.asarray(x0), u, full_cov=full_cov)
        return jnp.sum(m) + 10 * jnp.sum(c ** 2), (m, c)

    (_, (mj, cj)), gj = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(us))
    ut = t64(us).requires_grad_()
    mt, ct = td.rollout(td.build_rollout_cache(tgp, 2, 1), t64(x0), ut,
                        full_cov=full_cov)
    (gt,) = torch.autograd.grad(torch.sum(mt) + 10 * torch.sum(ct ** 2), ut)
    np.testing.assert_allclose(np_(mt), np.asarray(mj), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(np_(gt), np.asarray(gj), rtol=RTOL, atol=1e-12)


def test_nominal_multi_step_means_track_truth():
    """tests/test_nominal.py: 5-step means with the nominal model track the
    true system within 0.1."""
    _, tgp = _residual_gps(60, seed=25)
    x0 = np.array([0.8, -0.5])
    us = np.random.default_rng(26).uniform(-0.5, 0.5, (5, 1))
    means, _ = td.rollout(td.build_rollout_cache(tgp, 2, 1), t64(x0), t64(us))
    xt = x0.copy()
    for t in range(5):
        xt = _truth(xt, us[t])
        np.testing.assert_allclose(np_(means[t + 1]), xt, atol=0.1)


def test_nominal_full_cov_psd_and_consistent():
    """tests/test_nominal.py: with a nominal model the full covariance stays
    PSD and its diagonal matches the diagonal path (rtol 0.15, atol 1e-3)."""
    _, tgp = _residual_gps(40, seed=27)
    cache = td.build_rollout_cache(tgp, 2, 1)
    x0 = t64([0.4, -0.3])
    us = t64(np.random.default_rng(28).uniform(-0.5, 0.5, (3, 1)))
    _, covs_d = td.rollout(cache, x0, us)
    _, covs_f = td.rollout(cache, x0, us, full_cov=True)
    assert np.all(np.linalg.eigvalsh(np_(covs_f)) >= -1e-12)
    np.testing.assert_allclose(np_(torch.diagonal(covs_f, dim1=1, dim2=2)),
                               np_(torch.diagonal(covs_d, dim1=1, dim2=2)),
                               rtol=0.15, atol=1e-3)


def test_nominal_guards():
    """Delta dynamics with a nominal model raise; the batched rollout raises
    on a nominal model, as the JAX package's."""
    _, tgp = _residual_gps(40, seed=29)
    cache = td.build_rollout_cache(tgp, 2, 1)
    with pytest.raises(ValueError, match='mutually exclusive'):
        td.rollout(cache, torch.zeros(2, dtype=torch.float64),
                   torch.zeros((2, 1), dtype=torch.float64), delta=True)
    with pytest.raises(NotImplementedError):
        td.rollout_batched(cache, torch.zeros((2, 2), dtype=torch.float64),
                           torch.zeros((2, 3, 1), dtype=torch.float64))
    assert td.build_rollout_cache(
        replace(tgp, config=replace(tgp.config, nominal_fn=None)), 2,
        1).nominal_fn is None
