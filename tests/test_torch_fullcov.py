"""The full-covariance batched path of gpmpc_tpu_torch against gpmpc_tpu at
f64 on the CPU: the four full-S moment ops of ops/moments.py, tied and
untied, in value and gradient (rtol 1e-8); rollout_batched(full_cov=True)
with and without delta dynamics, in value and gradient; the same rollout
against a loop of the port's single-scenario `rollout` (the bars of
tests/test_batched.py's full-covariance case); batch_objective and
solve_batch with full_cov=True (the bars of tests/test_torch_solver.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.problems import make_headline_problem as jmake
from gpmpc_tpu import dynamics as jd
from gpmpc_tpu.mpc.solver import SolverConfig as JSolverConfig
from gpmpc_tpu.ops import moments as jm
from gpmpc_tpu.parallel import batch as jbatch
from gpmpc_tpu_torch import dynamics as td
from gpmpc_tpu_torch.mpc.solver import SolverConfig
from gpmpc_tpu_torch.ops import moments as tm
from gpmpc_tpu_torch.parallel.batch import batch_objective, solve_batch
from gpmpc_tpu_torch.problems import make_headline_problem as tmake
from torch_port_common import (jax_gp, np_, port_gp, spd, t64,
                               untied_log_lambdas)

torch.set_num_threads(1)
RTOL = 1e-8
B, H = 4, 5


def _gp(tied, seed=0):
    jgp = jax_gp(n=20, cap=32, seed=seed,
                 log_lambdas=None if tied else untied_log_lambdas())
    return jgp, port_gp(jgp)


def _moment_inputs(tied, seed):
    jgp, tgp = _gp(tied, seed)
    rng = np.random.default_rng(seed + 50)
    u = rng.uniform(-1, 1, (B, 3))
    s = spd(rng, (B,), 3, scale=0.02) * 0.05
    means = rng.normal(size=(B, 2)) * 0.1
    blam = jd.build_rollout_cache(jgp, 2, 1).b_lam
    return jgp, tgp, u, s, means, blam


def _ops(jgp, tgp, blam, means):
    """Each full-S op as (jax fn, torch fn) of (u, S) -> one array, with the
    GP's arrays bound."""
    jx = (jgp.x, jgp.beta, jgp.log_lambdas, jgp.log_sigma_f)
    tx = tuple(t64(v) for v in jx)
    jmask, tmask = jgp.mask, torch.tensor(np.asarray(jgp.mask))
    jmn, tmn = jnp.asarray(means), t64(means)
    return {
        'mean': (lambda tied: (
            lambda u, s: jm.mean_prop_batched(u, s, *jx, jmask, tied=tied)[1],
            lambda u, s: tm.mean_prop_batched(u, s, *tx, tmask, tied=tied)[1])),
        'io_cov': (lambda tied: (
            lambda u, s: jm.input_output_cov_batched(
                u, s, jx[0], jx[1], jm.mean_prop_batched(
                    u, s, *jx, jmask, tied=tied)[1], jx[2]),
            lambda u, s: tm.input_output_cov_batched(
                u, s, tx[0], tx[1], tm.mean_prop_batched(
                    u, s, *tx, tmask, tied=tied)[1], tx[2]))),
        'variance': (lambda tied: (
            lambda u, s: jm.variance_prop_multi_batched(
                u, s, jx[0], blam, jx[2], jx[3], jmn, tied=tied),
            lambda u, s: tm.variance_prop_multi_batched(
                u, s, tx[0], t64(blam), tx[2], tx[3], tmn, tied=tied))),
        'covariance': (lambda tied: (
            lambda u, s: jm.covariance_prop_multi_batched(
                u, s, *jx, jmn, jmask, tied=tied),
            lambda u, s: tm.covariance_prop_multi_batched(
                u, s, *tx, tmn, tmask, tied=tied))),
    }


@pytest.mark.parametrize('tied', [True, False])
@pytest.mark.parametrize('op', ['mean', 'io_cov', 'variance', 'covariance'])
def test_full_s_moment_op_matches_jax(op, tied):
    jgp, tgp, u, s, means, blam = _moment_inputs(tied, seed=3)
    jfn, tfn = _ops(jgp, tgp, blam, means)[op](tied)
    out_j = np.asarray(jfn(jnp.asarray(u), jnp.asarray(s)))
    w = np.random.default_rng(9).normal(size=out_j.shape)
    gj = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * w), argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(s))
    ut, st = t64(u).requires_grad_(), t64(s).requires_grad_()
    out_t = tfn(ut, st)
    gt = torch.autograd.grad(torch.sum(out_t * t64(w)), (ut, st))
    np.testing.assert_allclose(np_(out_t), out_j, rtol=RTOL, atol=1e-14)
    for got, want in zip(gt, gj):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                                   atol=1e-13)


def test_full_s_ops_equal_diagonal_ops_on_diagonal_s():
    """On a diagonal S the full-S mean and variance equal the diagonal
    path's, which the main path runs."""
    jgp, _, u, _, means, blam = _moment_inputs(True, seed=4)
    sd = np.random.default_rng(5).uniform(0.01, 0.2, (B, 3))
    tx = (t64(jgp.x), t64(jgp.beta), t64(jgp.log_lambdas),
          t64(jgp.log_sigma_f), torch.tensor(np.asarray(jgp.mask)))
    for tied in (True, False):
        m_f, l_f = tm.mean_prop_batched(t64(u), torch.diag_embed(t64(sd)), *tx,
                                        tied=tied)
        m_d, l_d = tm.mean_prop_batched_diag(t64(u), t64(sd), *tx, tied=tied)
        v_f = tm.variance_prop_multi_batched(
            t64(u), torch.diag_embed(t64(sd)), tx[0], t64(blam), tx[2], tx[3],
            t64(means), tied=tied)
        v_d = tm.variance_prop_multi_batched_diag(
            t64(u), t64(sd), tx[0], t64(blam), tx[2], tx[3], t64(means),
            tied=tied)
        for got, want in ((m_f, m_d), (l_f, l_d), (v_f, v_d)):
            np.testing.assert_allclose(np_(got), np_(want), rtol=1e-10,
                                       atol=1e-14)


def _rollout_setup(tied, seed):
    jgp, tgp = _gp(tied, seed)
    rng = np.random.default_rng(seed + 7)
    return (jd.build_rollout_cache(jgp, 2, 1), td.build_rollout_cache(tgp, 2, 1),
            rng.uniform(-1, 1, (B, 2)), rng.uniform(-1, 1, (B, H, 1)))


@pytest.mark.parametrize('tied', [True, False])
@pytest.mark.parametrize('delta', [False, True])
def test_rollout_batched_full_cov_matches_jax(tied, delta):
    jcache, tcache, x0s, us = _rollout_setup(tied, seed=7)
    w = np.random.default_rng(4).normal(size=(B, H + 1, 2))

    def jf(u):
        m, c = jd.rollout_batched(jcache, jnp.asarray(x0s), u, delta=delta,
                                  full_cov=True)
        return jnp.sum(m * w) + 10 * jnp.sum(c ** 2), (m, c)

    (_, (mj, cj)), gj = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(us))
    ut = t64(us).requires_grad_()
    mt, ct = td.rollout_batched(tcache, t64(x0s), ut, delta=delta,
                                full_cov=True)
    (gt,) = torch.autograd.grad(torch.sum(mt * t64(w)) + 10 * torch.sum(ct ** 2),
                                ut)
    assert mt.shape == (B, H + 1, 2) and ct.shape == (B, H + 1, 2, 2)
    assert float(ct[:, 1:, 0, 1].detach().abs().min()) > 0   # not diagonal
    np.testing.assert_allclose(np_(mt), np.asarray(mj), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(np_(gt), np.asarray(gj), rtol=RTOL, atol=1e-13)


@pytest.mark.parametrize('tied', [True, False])
@pytest.mark.parametrize('delta', [False, True])
def test_rollout_batched_full_cov_equals_rollout_loop(tied, delta):
    """The batched full-covariance rollout equals the single-scenario rollout
    over each lane (tests/test_batched.py's bars: means rtol 1e-8, covs
    1e-7)."""
    _, tcache, x0s, us = _rollout_setup(tied, seed=8)
    mb, cb = td.rollout_batched(tcache, t64(x0s), t64(us), delta=delta,
                                full_cov=True)
    for k in range(B):
        m1, c1 = td.rollout(tcache, t64(x0s[k]), t64(us[k]), full_cov=True,
                            delta=delta)
        np.testing.assert_allclose(np_(mb[k]), np_(m1), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np_(cb[k]), np_(c1), rtol=1e-7, atol=1e-10)


def _headline_pair(b=4):
    kw = dict(b=b, seed=1, n_train=24, capacity=32, horizon=5)
    return jmake(dtype=jnp.float64, **kw), tmake(dtype=torch.float64,
                                                 device='cpu', **kw)


def test_batch_objective_full_cov_matches_jax():
    jp, tp = _headline_pair()
    u = np.random.default_rng(6).uniform(-2, 2, (4, 5, 1))
    jcache = jd.build_rollout_cache(jp.gp, 2, 1)

    def jf(uu):
        from gpmpc_tpu.mpc.cost import risk_sensitive_cost
        cost_b = jax.vmap(risk_sensitive_cost,
                          in_axes=(jbatch._params_axes(jp.params, 4), 0, 0, 0))
        m, c = jd.rollout_batched(jcache, jp.x0s, uu, full_cov=True)
        return cost_b(jp.params, m, c, uu)

    jv = np.asarray(jf(jnp.asarray(u)))
    jg = np.asarray(jax.grad(lambda uu: jnp.sum(jf(uu)))(jnp.asarray(u)))
    obj = batch_objective(td.build_rollout_cache(tp.gp, 2, 1), tp.x0s,
                          tp.params, full_cov=True)
    ut = t64(u).requires_grad_()
    tv = obj(ut)
    (tg,) = torch.autograd.grad(tv.sum(), ut)
    np.testing.assert_allclose(np_(tv), jv, rtol=RTOL)
    np.testing.assert_allclose(np_(tg), jg, rtol=RTOL, atol=1e-12)


def test_solve_batch_full_cov_matches_jax_f64():
    jp, tp = _headline_pair()
    jres = jbatch.solve_batch(jp.gp, 2, 1, jp.x0s, jp.params, jp.horizon,
                              jp.lb, jp.ub, JSolverConfig(max_iters=5, tol=1e-4),
                              full_cov=True, impl='fused')
    tres = solve_batch(tp.gp, 2, 1, tp.x0s, tp.params, tp.horizon, tp.lb,
                       tp.ub, SolverConfig(max_iters=5, tol=1e-4),
                       full_cov=True)
    np.testing.assert_allclose(np_(tres.u), np.asarray(jres.u), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(np_(tres.cost), np.asarray(jres.cost), rtol=1e-6)
    np.testing.assert_array_equal(np_(tres.iters), np.asarray(jres.iters))


def test_f64_full_cov_objective_matches_stored_jax_reference():
    """The port's f64 full-covariance headline objective at the reference
    controls against JAX's values in gpmpc_tpu_torch/data/headline_ref.npz
    (rtol 1e-8), value and gradient, on the gradient's lanes and on four
    lanes that take the PD-cone penalty: what chip_smoke.py phase 5e holds
    on the card for all 256 lanes."""
    from gpmpc_tpu_torch.problems import REF_FILE
    ref = np.load(REF_FILE)
    lanes = ref['grad_full_lanes']
    tp = tmake(b=256, dtype=torch.float64, device='cpu')
    cache = td.build_rollout_cache(tp.gp, 2, 1)
    for idx in (lanes, np.arange(4)):
        obj = batch_objective(cache, tp.x0s[idx],
                              tp.params._replace(gamma=tp.params.gamma[idx]),
                              full_cov=True)
        u = t64(ref['u_ref'][idx]).requires_grad_()
        j = obj(u)
        np.testing.assert_allclose(np_(j), ref['j_uref_full'][idx], rtol=RTOL)
        if idx is lanes:
            (g,) = torch.autograd.grad(j.sum(), u)
            np.testing.assert_allclose(np_(g), ref['grad_uref_full'],
                                       rtol=RTOL, atol=1e-10)
