"""gpmpc_tpu_torch.dynamics.rollout_lanes, the single-scenario rollout mapped
over lanes by torch.func.vmap, at f64 on the CPU: against `rollout` lane by
lane (values and gradients, rtol 1e-12) with a shared cache and with one GP
a lane, a diagonal and a full covariance, delta dynamics and a nominal
model; against JAX's jax.vmap(gpmpc_tpu.dynamics.rollout) (rtol 1e-8); with
no op on functorch's per-lane fallback; the lanes cache of a stacked GP; and
the vmap rules of the two autograd Functions it may reach (the eigensolver
and the tied-lengthscale guard) against their unmapped forms. And in f32 on
the headline GP (fault F4): the variances of an f32 lanes rollout within
F32_VAR_RTOL of the f64 lanes rollout of the same operands, where the plain
f32 single-input trace misses."""

import contextlib
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu import dynamics as jdyn
from gpmpc_tpu.gp import state as jgs
from gpmpc_tpu.parallel import batch as jbatch
from gpmpc_tpu_torch.dynamics import (build_rollout_cache, cache_from,
                                      rollout, rollout_lanes)
from gpmpc_tpu_torch.gp.state import GPConfig, make_gp
from gpmpc_tpu_torch.ops import moments
from gpmpc_tpu_torch.ops.kernels import eigh_small
from gpmpc_tpu_torch.parallel.batch import _GP_TENSORS, stack_gps
from gpmpc_tpu_torch.problems import make_headline_problem
from torch_port_common import nominal_gp_pair, np_, t64

torch.set_num_threads(2)
B, H = 3, 4
RTOL = 1e-12
JAX_RTOL = 1e-8


def _draw(seed, pkg):
    """One GP draw: 24 transitions of seed `seed` in capacity 32, tied
    lengthscales 2, sigma_n 0.05 (f64), in the JAX package or the port."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, (24, 2))
    a = rng.uniform(-1, 1, (24, 1))
    nxt = s + 0.1 * np.concatenate([s[:, 1:], -np.sin(s[:, :1]) + a], axis=1)
    x = np.concatenate([s, a], axis=1)
    kw = dict(log_lambdas=np.log([2.0, 1.5, 2.5]), log_sigma_f=0.0,
              log_sigma_n=np.log(0.05))
    if pkg == 'jax':
        return jgs.make_gp(jgs.GPConfig(capacity=32, x_dim=3, out_dim=2), x,
                           nxt, dtype=jnp.float64, **kw)
    return make_gp(GPConfig(capacity=32, x_dim=3, out_dim=2), x, nxt,
                   dtype=torch.float64, device='cpu', **kw)


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.8, 0.8, (B, 2)), rng.uniform(-1, 1, (B, H, 1))


def _lane_gp(gps, i):
    return dataclasses.replace(
        gps, **{name: getattr(gps, name)[i] for name in _GP_TENSORS})


def _setup(kind):
    """(cache for rollout_lanes, per-lane caches for rollout)
    of kind 'shared' (one GP), 'lanes' (one GP draw a lane) or 'nominal'
    (the affine residual model of torch_port_common)."""
    if kind == 'lanes':
        gps = stack_gps([_draw(s, 'torch') for s in range(B)])
        return (build_rollout_cache(gps, 2, 1),
                [build_rollout_cache(_lane_gp(gps, i), 2, 1)
                 for i in range(B)])
    gp = (_draw(0, 'torch') if kind == 'shared'
          else nominal_gp_pair()[1])
    cache = build_rollout_cache(gp, 2, 1)
    return cache, [cache] * B


CASES = [(kind, full_cov, delta) for kind in ('shared', 'lanes')
         for full_cov in (False, True) for delta in (False, True)]
CASES += [('nominal', False, False), ('nominal', True, False)]


def _weights(shape_m, shape_c, seed=11):
    rng = np.random.default_rng(seed)
    return t64(rng.normal(size=shape_m)), t64(rng.normal(size=shape_c))


@pytest.mark.parametrize('kind,full_cov,delta', CASES)
def test_lanes_equal_rollout_lane_by_lane(kind, full_cov, delta):
    """Lane b of rollout_lanes equals rollout(cache_b, x0s[b], u[b]): the
    means, covariances and the gradient of a weighted sum of both with
    respect to the actions, at rtol 1e-12 of each one's scale. A variance
    is sigma_f^2 - trace - m^2, a cancellation of terms of order sigma_f^2
    (1 here) down to ~0.01: the batched and unbatched contractions sum in
    other orders, so the covariances are held at 1e-12 of sigma_f^2 (the
    lanes read within 2.7e-13 of it on this CPU; the means and gradients
    within 5e-13 of their own largest entry)."""
    cache, caches = _setup(kind)
    sf2 = float(torch.exp(2.0 * cache.log_sigma_f).max())
    x0s, u = (t64(a) for a in _inputs())
    wm, wc = _weights((B, H + 1, 2), (B, H + 1, 2, 2))
    u_var = u.clone().requires_grad_(True)
    means, covs = rollout_lanes(cache, x0s, u_var, full_cov=full_cov,
                                delta=delta)
    (g,) = torch.autograd.grad((wm * means).sum() + (wc * covs).sum(), u_var)
    assert means.shape == (B, H + 1, 2) and covs.shape == (B, H + 1, 2, 2)
    for i in range(B):
        ui = u[i].clone().requires_grad_(True)
        mi, ci = rollout(caches[i], x0s[i], ui, full_cov=full_cov,
                         delta=delta)
        (gi,) = torch.autograd.grad((wm[i] * mi).sum() + (wc[i] * ci).sum(),
                                    ui)
        for name, got, want in (('means', means[i], mi), ('covs', covs[i], ci),
                                ('grad', g[i], gi)):
            want = want.detach()
            scale = float(want.abs().max())
            if name == 'covs':
                scale = max(scale, sf2)
            np.testing.assert_allclose(np_(got), np_(want), rtol=RTOL,
                                       atol=RTOL * scale,
                                       err_msg=f'lane {i} {name}')


@pytest.mark.parametrize('kind,full_cov,delta',
                         [c for c in CASES if c[0] != 'nominal']
                         + [('nominal', False, False)])
def test_lanes_match_jax_vmap_of_rollout(kind, full_cov, delta):
    """rollout_lanes against jax.vmap of gpmpc_tpu.dynamics.rollout (the
    cache shared, in_axes None, or built inside the map from a stacked GP
    as JAX's solve_batch_gp does): means, covariances and the gradient of
    a weighted sum, at rtol 1e-8."""
    x0s_np, u_np = _inputs()
    wm, wc = _weights((B, H + 1, 2), (B, H + 1, 2, 2))
    kw = dict(full_cov=full_cov, delta=delta)
    if kind == 'lanes':
        jgps = jbatch.stack_gps([_draw(s, 'jax') for s in range(B)])

        def jroll(x0s, u):
            return jax.vmap(lambda gp, x0, ui: jdyn.rollout(
                jdyn.build_rollout_cache(gp, 2, 1), x0, ui, **kw))(jgps, x0s,
                                                                   u)
    else:
        jgp = (_draw(0, 'jax') if kind == 'shared' else nominal_gp_pair()[0])
        jcache = jdyn.build_rollout_cache(jgp, 2, 1)

        def jroll(x0s, u):
            return jax.vmap(lambda x0, ui: jdyn.rollout(jcache, x0, ui, **kw))(
                x0s, u)

    jwm, jwc = jnp.asarray(np_(wm)), jnp.asarray(np_(wc))

    def jscalar(u, x0s):
        m, c = jroll(x0s, u)
        return jnp.sum(jwm * m) + jnp.sum(jwc * c)

    jm, jc = jroll(jnp.asarray(x0s_np), jnp.asarray(u_np))
    jg = jax.grad(jscalar)(jnp.asarray(u_np), jnp.asarray(x0s_np))

    cache, _ = _setup(kind)
    u_var = t64(u_np).requires_grad_(True)
    means, covs = rollout_lanes(cache, t64(x0s_np), u_var, **kw)
    (g,) = torch.autograd.grad((wm * means).sum() + (wc * covs).sum(), u_var)
    for name, got, want in (('means', means, jm), ('covs', covs, jc),
                            ('grad', g, jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(np_(got), want, rtol=JAX_RTOL,
                                   atol=JAX_RTOL * float(np.abs(want).max()),
                                   err_msg=name)


@contextlib.contextmanager
def _fallback_is_an_error():
    """functorch's per-lane fallback warning on, and raised as an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings('error', message='.*performance drop.*')
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def test_fallback_check_sees_a_fallback():
    """The check below catches an op without a batching rule (aten::histc
    runs lane by lane under vmap)."""
    with _fallback_is_an_error(), pytest.raises(UserWarning,
                                                match='performance drop'):
        torch.func.vmap(lambda a: torch.histc(a, bins=3))(
            torch.ones((2, 4), dtype=torch.float64))


@pytest.mark.parametrize('kind,full_cov,delta', CASES)
def test_no_op_takes_the_per_lane_fallback(kind, full_cov, delta):
    """The lanes rollout and its backward run every op through a batching
    rule: with functorch's fallback warning raised as an error, the forward
    and the gradient complete."""
    cache, _ = _setup(kind)
    x0s, u = (t64(a) for a in _inputs())
    u = u.requires_grad_(True)
    with _fallback_is_an_error():
        means, covs = rollout_lanes(cache, x0s, u, full_cov=full_cov,
                                    delta=delta)
        (g,) = torch.autograd.grad(means.sum() + covs.sum(), u)
    assert bool(torch.isfinite(g).all())


def test_lanes_cache_of_a_stacked_gp():
    """build_rollout_cache of stack_gps equals each draw's own cache to the
    bit, every tensor with the (B,) axis; the static fields come from the
    shared config; rollout_lanes raises for a cache of another lane
    count."""
    gps = stack_gps([_draw(s, 'torch') for s in range(B)])
    lanes = build_rollout_cache(gps, 2, 1)
    for i in range(B):
        one = build_rollout_cache(_lane_gp(gps, i), 2, 1)
        for a, b in zip(lanes.tensors(), one.tensors()):
            assert torch.equal(a[i], b)
        assert one.static_key() == lanes.static_key()
    x0s, u = (t64(a) for a in _inputs())
    with pytest.raises(ValueError, match='one GP a lane'):
        rollout_lanes(lanes, x0s[:2], u[:2])


@pytest.mark.parametrize('in_dim', [0, 1])
def test_eigh_vmap_rule_equals_unmapped(in_dim):
    """_Eigh under vmap (its rule moves the lanes to the front and calls
    the eigensolver once for all of them) equals the unmapped call on the
    stacked matrices to the bit, values and gradient."""
    rng = np.random.default_rng(3)
    m = rng.normal(size=(5, 4, 3, 3))
    a = t64(m + np.swapaxes(m, -1, -2)).requires_grad_(True)
    w, v = torch.func.vmap(eigh_small.eigh, in_dims=in_dim)(a)
    w0, v0 = eigh_small.eigh(a.movedim(in_dim, 0))
    assert torch.equal(w, w0) and torch.equal(v, v0)
    wv = t64(rng.normal(size=(3, 3)))
    (g,) = torch.autograd.grad((w ** 2).sum() + (v @ wv).sum(), a)
    (g0,) = torch.autograd.grad((w0 ** 2).sum() + (v0 @ wv).sum(), a)
    assert torch.equal(g, g0)


def test_tied_guard_vmap_rule_equals_unmapped():
    """_TiedHypergradGuard under vmap: the identity on the value and a NaN
    cotangent, as unmapped."""
    ll = t64(np.log([[2.0, 1.5, 3.0]] * 2)).expand(4, 2, 3).clone()
    ll.requires_grad_(True)
    out = torch.func.vmap(moments._tied_hypergrad_guard)(ll)
    assert torch.equal(out, ll.detach())
    (g,) = torch.autograd.grad(out.sum(), ll)
    assert bool(torch.isnan(g).all())
    x = t64(np.ones((5, 3))).requires_grad_(True)
    (g0,) = torch.autograd.grad(moments._tied_hypergrad_guard(x).sum(), x)
    assert bool(torch.isnan(g0).all())


# The f32 lanes rollout's variances against the f64 lanes rollout of the
# same f32 operands, each step: a variance is sigma_f^2 - det t - m^2 with
# terms up to ~1e3 times it (tests/diagnose_torch_f4.py), so the f32
# rounding of those terms alone moves it ~1e-4 a step. Measured on the
# headline GP (3 lanes, 8 steps): with the f64 single-input trace at most
# 2.9e-4 (shared cache) and 2.7e-4 (one GP a lane); with the plain f32
# trace 9.7e-3 and 7.6e-3.
F32_VAR_RTOL = 1e-3


@pytest.mark.parametrize('kind', ['shared', 'lanes'])
def test_f32_lanes_variances_near_f64(monkeypatch, kind):
    """An f32 rollout_lanes on the headline GP (kind 'shared') or on one
    headline GP draw a lane (seeds 0-2, 'lanes'), 8 steps under uniform
    controls: every variance within F32_VAR_RTOL of the f64 lanes rollout
    of the same f32 cache, x0s and controls; the plain f32 single-input
    trace (moments._single_trace bypassed) misses that bar."""
    b, h = 3, 8
    p = make_headline_problem(b=b, dtype=torch.float32, device='cpu')
    gp = (p.gp if kind == 'shared' else stack_gps([
        make_headline_problem(b=1, seed=s, dtype=torch.float32,
                              device='cpu').gp for s in range(b)]))
    cache = build_rollout_cache(gp, 2, 1)
    u = torch.tensor(np.random.default_rng(2).uniform(-5, 5, (b, h, 1)),
                     dtype=torch.float32)
    cache64 = cache_from(cache.static_key(),
                         [t.double() for t in cache.tensors()])
    want = torch.diagonal(rollout_lanes(cache64, p.x0s.double(),
                                        u.double())[1], dim1=-2, dim2=-1)

    def rel_err():
        got = torch.diagonal(rollout_lanes(cache, p.x0s, u)[1], dim1=-2,
                             dim2=-1)
        assert got.dtype == torch.float32
        return float(((got.double() - want).abs() / want).max())

    assert rel_err() <= F32_VAR_RTOL
    monkeypatch.setattr(moments, '_single_trace',
                        lambda chain, *ops: chain(*ops))
    assert rel_err() > 5 * F32_VAR_RTOL


def test_compat_nominal_models_run_in_the_lanes_rollout():
    """compat.Dynamics' per-output nominal models (its nominal_fn stacks
    them) run under the lanes map: rollout_lanes of its state equals
    rollout lane by lane, with no per-lane fallback."""
    from gpmpc_tpu_torch.compat import Dynamics
    dyn = Dynamics(state_dim=2, action_dim=1, capacity=32, device='cpu',
                   nominal_models=[lambda s, a: 0.9 * s[:, 0] + 0.1 * a[:, 0],
                                   lambda s, a: 0.8 * s[:, 1]])
    rng = np.random.default_rng(6)
    s, a = rng.uniform(-1, 1, (20, 2)), rng.uniform(-1, 1, (20, 1))
    dyn.append_train_data(s, a, 0.9 * s + 0.05 * np.sin(s))
    cache = build_rollout_cache(dyn.state, 2, 1)
    x0s, u = (t64(v) for v in _inputs())
    with _fallback_is_an_error():
        means, covs = rollout_lanes(cache, x0s, u)
    for i in range(B):
        mi, ci = rollout(cache, x0s[i], u[i])
        assert torch.equal(means[i], mi) and torch.equal(covs[i], ci)


def test_host_reading_nominal_model_raises():
    """A nominal model that reads a value on the host cannot run in the
    lanes map (nor in a capture): the controller's route (c) raises, and
    never falls back to an eager per-lane loop."""
    from gpmpc_tpu_torch.gp import state as gp_state
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.solver import SolverConfig

    def reads_host(xs):
        gain = 0.9 if float(xs[0, 0]) > -10.0 else 0.8
        return gain * xs[:, :2]

    mpc = RiskSensitiveMPC(gamma=0.2, horizon=3, state_dim=2, input_dim=1,
                           Q=np.eye(2), R=0.1 * np.eye(1), capacity=32,
                           dtype=torch.float64,
                           solver=SolverConfig(max_iters=3), device='cpu')
    mpc.gp = gp_state.make_gp(gp_state.GPConfig(
        capacity=32, x_dim=3, out_dim=2, nominal_fn=reads_host),
        dtype=torch.float64, device='cpu')
    rng = np.random.default_rng(7)
    mpc.dynamics.append_train_data(rng.uniform(-1, 1, (10, 2)),
                                   rng.uniform(-1, 1, (10, 1)),
                                   rng.uniform(-1, 1, (10, 2)))
    with pytest.raises(RuntimeError, match='vmap'):
        mpc.get_optimal_trajectory(np.array([0.1, -0.2]))
