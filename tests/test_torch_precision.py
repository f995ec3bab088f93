"""The variance trace's precision policy (ops/kernels/variance_trace.py): on
the headline GP's own x and b_lam, whose trace cancels, every trace path of
the port evaluated from f32 operands gives t and (du, dm2) equal to the
plain f64 trace's rounded to f32 (within one f32 ulp plus f64 rounding),
where a plain f32 evaluation misses by orders of magnitude more; f64
operands pass through the policy untouched, to the bit; the row block
returns its partial in f64; and the model-sharded trace on two gloo ranks
sums its partials in f64 and matches the unsharded f32 op. The same policy
for one input (ops/moments.py `_single_trace`, fault F4): the per-scenario
routes' variance (`variance_prop_multi`, `variance_prop_cached`) from f32
operands equals its f64 evaluation rounded, in value and cotangents, where
the plain f32 chain misses by two orders of magnitude.

On the CPU every path takes its plain rw version, so this holds the policy's
arithmetic, not the kernels (tests/test_torch_cuda.py holds those on the
card)."""

import os
import sys

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.dynamics import build_rollout_cache, rollout_lanes
from gpmpc_tpu_torch.ops import moments
from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt
from gpmpc_tpu_torch.parallel.distributed import launch_ranks
from gpmpc_tpu_torch.problems import (DATA_SCALE, headline_operands,
                                      make_headline_problem)

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
EPS32 = float(torch.finfo(F32).eps)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_dist_worker.py')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16


@pytest.fixture(scope='module')
def headline_cache():
    return build_rollout_cache(make_headline_problem(
        b=2, dtype=F32, device='cpu').gp, 2, 1)


def _block_trace(u, m2, x, blam, native=False):
    """The tied trace as the sum of two row blocks' partials (K3), as the
    sharded path takes it: u and M2 enter the blocks in f64 (so their
    partial cotangents are summed in f64 too) and only the sum of the
    partials is rounded to u's dtype."""
    n = x.shape[0] // 2
    dt = tvt.TRACE_DTYPE if not native else u.dtype
    u_w, m2_w = u.to(dt), m2.to(dt)
    parts = [tvt.variance_trace_tied_block(
        u_w, m2_w, x, x[k:k + n], blam[:, k:k + n].transpose(1, 2),
        native=native) for k in (0, n)]
    return (parts[0] + parts[1]).to(u.dtype)


# (trace, plain f64 oracle, tied, with the K4 opt-in GPMPC_SYM_KERNEL=1)
PATHS = {
    'K1 tied': (tvt.variance_trace_batched_tied,
                tvt.variance_trace_batched_tied_reference, True, False),
    'K2 untied': (tvt.variance_trace_batched,
                  tvt.variance_trace_batched_reference, False, False),
    'K3 row blocks': (_block_trace, tvt.variance_trace_batched_tied_reference,
                      True, False),
    'K4 tied': (tvt.variance_trace_batched_tied,
                tvt.variance_trace_batched_tied_reference, True, True),
    'K4 per-output': (tvt.variance_trace_batched,
                      tvt.variance_trace_batched_reference, False, True),
}


def _path(monkeypatch, path):
    """(trace, oracle, tied) of `path`, with the K4 opt-in set for it."""
    fn, ref, tied, sym = PATHS[path]
    if sym:
        monkeypatch.setenv('GPMPC_SYM_KERNEL', '1')
    else:
        monkeypatch.delenv('GPMPC_SYM_KERNEL', raising=False)
    return fn, ref, tied


def _value_and_grads(fn, u, m2, x, blam, ct, **kw):
    uu, mm = u.clone().requires_grad_(), m2.clone().requires_grad_()
    t = fn(uu, mm, x, blam, **kw)
    return (t, *torch.autograd.grad(torch.sum(t * ct.to(t.dtype)), (uu, mm)))


def _within_rounding(got, want64, what):
    """got (f32) is want64 rounded to f32, up to f64 noise: |got - want64|
    <= eps32 |want64| + eps32 1e-6 max|want64|."""
    assert got.dtype == F32, what
    err = (got.double() - want64).abs()
    bar = EPS32 * want64.abs() + EPS32 * 1e-6 * want64.abs().max()
    assert bool((err <= bar).all()), (
        f'{what}: up to {float((err / bar).max()):.2f}x the rounding bar')


@pytest.mark.parametrize('path', list(PATHS))
def test_f32_trace_equals_f64_trace_rounded(monkeypatch, headline_cache,
                                            path):
    fn, ref, tied = _path(monkeypatch, path)
    rng = np.random.default_rng(40)
    ops32 = [v.to(F32) for v in headline_operands(rng, B, headline_cache,
                                                   tied)]
    ct = torch.tensor(rng.normal(size=(B, ops32[3].shape[0])), dtype=F32)
    # The oracle: the plain trace in f64 of the same (f32) operands and
    # cotangent.
    want = _value_and_grads(ref, *(v.double() for v in ops32), ct)
    got = _value_and_grads(fn, *ops32, ct)
    for name, g, w in zip(('t', 'du', 'dm2'), got, want):
        _within_rounding(g.detach(), w.detach(), f'{path} {name}')
    # The plain f32 evaluation of the same operands misses by far more.
    plain = ref(*ops32).double()
    t64 = want[0].detach()
    rel = ((plain - t64).abs() / t64.abs()).max()
    assert float(rel) > 1e3 * EPS32, f'{path}: plain f32 rel err {float(rel)}'


@pytest.mark.parametrize('path', list(PATHS))
def test_f64_operands_pass_through_the_policy(monkeypatch, headline_cache,
                                              path):
    """With f64 operands the policy changes nothing: the same bits as the
    native evaluation, value and gradients."""
    fn, _, tied = _path(monkeypatch, path)
    rng = np.random.default_rng(41)
    u, m2, x, blam = headline_operands(rng, 4, headline_cache, tied)
    ct = torch.tensor(rng.normal(size=(4, blam.shape[0])), dtype=F64)
    policy = _value_and_grads(fn, u, m2, x, blam, ct)
    native = _value_and_grads(fn, u, m2, x, blam, ct, native=True)
    for p, n in zip(policy, native):
        assert p.dtype == F64 and torch.equal(p, n)


def test_native_f32_is_the_plain_f32_evaluation(headline_cache):
    """native=True keeps f32 arithmetic: on the CPU exactly the plain rw in
    f32 summed in f32 (what the k1_f32 diagnostic measures on the card)."""
    rng = np.random.default_rng(42)
    u, m2, x, blam = (v.to(F32) for v in headline_operands(
        rng, 4, headline_cache, True))
    t = tvt.variance_trace_batched_tied(u, m2, x, blam, native=True)
    a, g, dv = tvt._prep_tied(u, m2, x)
    rw = tvt.rw_tied_reference(g, dv, a, tvt._aug(a) * dv[..., None], blam)
    assert t.dtype == F32 and torch.equal(t, rw[..., 0].sum(-1))


def test_row_block_partial_stays_f64(headline_cache):
    """The row block returns its partial in f64 from f32 operands (the
    partials cancel across blocks), its cotangents in f32."""
    rng = np.random.default_rng(43)
    u, m2, x, blam = (v.to(F32) for v in headline_operands(
        rng, 4, headline_cache, True))
    uu = u.clone().requires_grad_()
    part = tvt.variance_trace_tied_block(uu, m2, x, x[:128],
                                         blam[:, :128].transpose(1, 2))
    (du,) = torch.autograd.grad(part.sum(), uu)
    assert part.dtype == F64 and du.dtype == F32
    native = tvt.variance_trace_tied_block(u, m2, x, x[:128],
                                           blam[:, :128].transpose(1, 2),
                                           native=True)
    assert native.dtype == F32


def test_sharded_trace_sums_partials_in_f64(tmp_path):
    """Two gloo ranks of the row-sharded tied variance op in f32 on the
    headline GP: each rank sums f64 partials, and the f32 result and its
    gradient match the unsharded f32 op (whose trace is the f64 trace
    rounded) to a few f32 ulps of sigma_f^2."""
    rng = np.random.default_rng(44)
    b = 6
    inputs = dict(u=rng.uniform(-1, 1, (b, 3)) * DATA_SCALE,
                  s_diag=rng.uniform(1e-3, 2e-2, (b, 3)),
                  means=rng.normal(size=(b, 2)) * 0.1,
                  w=rng.uniform(0.5, 1.5, (b, 2)))
    inp = os.path.join(tmp_path, 'rows32_in.npz')
    prefix = os.path.join(tmp_path, 'rows32_out')
    np.savez(inp, **inputs)
    env = {k: v for k, v in os.environ.items()
           if k not in ('PYTHONPATH', 'XLA_FLAGS')}
    env['OMP_NUM_THREADS'] = '1'
    launch_ranks([sys.executable, WORKER, 'rows32', inp, prefix], 2, 120,
                 env=env, cwd=ROOT)
    outs = [np.load(f'{prefix}_rank{r}.npz') for r in range(2)]
    for out in outs:
        assert list(out['summed_dtypes']) == ['torch.float64']
        assert str(out['v_dtype']) == 'float32'
        for k in ('v', 'gu', 'gs'):
            want = out[f'unsharded_{k}'].astype(np.float64)
            np.testing.assert_allclose(out[f'sharded_{k}'], want, rtol=0,
                                       atol=8 * EPS32 * np.abs(want).max(),
                                       err_msg=k)
    for k in ('sharded_v', 'sharded_gu', 'sharded_gs'):
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


# ------------------------------------------ one input (F4, ops/moments) --
# The operands of the per-scenario routes' variance: the joint means and
# covariances that dynamics._step forms at SINGLE_STEPS of an f64 lanes
# rollout of the headline GP (4 of its x0s; zero and uniform controls),
# rounded to f32, beside the headline GP's own f32 x, b_lam, lengthscales
# and the f32 means there. On them the variance sigma_f^2 - det t - m^2 has
# terms up to ~1e3 times it, and t's up to ~1e6 times t.
SINGLE_STEPS = (1, 5, 10, 19)
# The plain f32 chain misses the bars below by at least this factor
# (measured here: the variance 189x, du 305-310x, dS 38x).
PLAIN_MISS = 30


def _plain(chain, u, S, x, b_lam, log_lambdas):
    """`moments._single_trace` before the policy: the chain in the
    operands' dtype."""
    return chain(u, S, x, b_lam, log_lambdas)


@pytest.fixture(scope='module')
def single_operands(headline_cache):
    """(u (P, 3), S (P, 3, 3), means (P, E)) in f32."""
    p = make_headline_problem(b=4, dtype=F64, device='cpu')
    cache = build_rollout_cache(p.gp, 2, 1)
    us, ss = [], []
    for ctrl in (np.zeros((4, 20, 1)),
                 np.random.default_rng(45).uniform(-5, 5, (4, 20, 1))):
        ctrl = torch.tensor(ctrl, dtype=F64)
        means, covs = rollout_lanes(cache, p.x0s, ctrl)
        idx = list(SINGLE_STEPS)
        us.append(torch.cat([means[:, idx], ctrl[:, idx]], -1).reshape(-1, 3))
        s = torch.zeros(us[-1].shape[0], 3, 3, dtype=F64)
        s[:, :2, :2] = covs[:, idx].reshape(-1, 2, 2)
        s[:, 2, 2] = 1e-3
        ss.append(s)
    u, s = torch.cat(us).to(F32), torch.cat(ss).to(F32)
    c = headline_cache
    means = torch.stack([torch.func.vmap(lambda a, b, k=k: moments.mean_prop(
        a, b, c.x, c.beta[k], c.log_lambdas[k], c.log_sigma_f[k],
        c.mask)[0])(u, s) for k in range(c.beta.shape[0])], dim=-1)
    return u, s, means


def _single_variance(op, cache, u, s, means, dtype):
    """The variance of each point by `op` ('multi': variance_prop_multi, all
    outputs; 'cached': variance_prop_cached, output by output) in `dtype`,
    from the same (f32) operands: (P, E)."""
    x, blam, ll, lsf = (v.to(dtype) for v in (
        cache.x, cache.b_lam, cache.log_lambdas, cache.log_sigma_f))
    u, s, means = u.to(dtype), s.to(dtype), means.to(dtype)
    vm = torch.func.vmap
    if op == 'multi':
        return vm(moments.variance_prop_multi,
                  in_dims=(0, 0, None, None, None, None, 0))(
            u, s, x, blam, ll, lsf, means)
    return torch.stack([vm(moments.variance_prop_cached,
                           in_dims=(0, 0, None, None, None, None, 0))(
        u, s, x, blam[k], ll[k], lsf[k], means[:, k])
        for k in range(blam.shape[0])], dim=-1)


def _largest_term(cache, u, s, means):
    """max(sigma_f^2, |det t|, m^2) of each point's final subtraction, in
    f64 from the f32 operands: (P, E)."""
    t, log_det = torch.func.vmap(moments._trace_multi,
                                 in_dims=(0, 0, None, None, None))(
        *(v.double() for v in (u, s, cache.x, cache.b_lam,
                               cache.log_lambdas)))
    sf2 = torch.exp(2.0 * cache.log_sigma_f.double()).expand_as(t)
    return torch.maximum(torch.maximum(sf2, (torch.exp(log_det) * t).abs()),
                         means.double() ** 2)


def _misses(got, want, bar):
    """The largest |got - want| / bar."""
    return float(((got.double() - want).abs() / bar).max())


@pytest.mark.parametrize('op', ['multi', 'cached'])
def test_single_input_variance_equals_f64_rounded(monkeypatch, headline_cache,
                                                  single_operands, op):
    """From f32 operands the variance is the f64 evaluation of the same
    operands rounded, within two f32 ulps of the final subtraction's
    largest term (sigma_f^2, det t, m^2; measured: 0.42 of it); the plain f32
    chain misses that bar by PLAIN_MISS or more."""
    want = _single_variance(op, headline_cache, *single_operands, F64)
    bar = 2 * EPS32 * _largest_term(headline_cache, *single_operands)
    got = _single_variance(op, headline_cache, *single_operands, F32)
    assert got.dtype == F32
    assert _misses(got, want, bar) <= 1.0, f'{op}: {_misses(got, want, bar)}'
    monkeypatch.setattr(moments, '_single_trace', _plain)
    plain = _single_variance(op, headline_cache, *single_operands, F32)
    assert _misses(plain, want, bar) > PLAIN_MISS


def test_single_input_trace_within_rounding(monkeypatch, headline_cache,
                                            single_operands):
    """t alone through the policy's helper: the f64 trace of the f32
    operands rounded (the batched cases' _within_rounding); the plain f32
    chain misses by more than 1e3 f32 ulps of t."""
    u, s, _ = single_operands
    c = headline_cache
    ops = (u, s, c.x, c.b_lam, c.log_lambdas)

    def trace(*v):
        return torch.func.vmap(
            lambda a, b: moments._single_trace(moments._trace_multi, a, b,
                                               *v[2:])[0])(*v[:2])

    want = trace(*(v.double() for v in ops))
    _within_rounding(trace(*ops), want, 'single-input t')
    monkeypatch.setattr(moments, '_single_trace', _plain)
    plain = trace(*ops).double()
    assert float(((plain - want).abs() / want.abs()).max()) > 1e3 * EPS32


def _variance_grads(op, cache, u, s, means, dtype, ct):
    uu = u.to(dtype).clone().requires_grad_()
    ss = s.to(dtype).clone().requires_grad_()
    v = _single_variance(op, cache, uu, ss, means, dtype)
    return (v, *torch.autograd.grad(torch.sum(v * ct.to(dtype)), (uu, ss)))


@pytest.mark.parametrize('op', ['multi', 'cached'])
def test_single_input_cotangents_equal_f64_rounded(monkeypatch, headline_cache,
                                                   single_operands, op):
    """The cotangents of u and S from f32 operands: the f64 ones rounded,
    within two f32 ulps of each entry plus two of the point's largest entry
    (measured: 0.49 of it); the plain f32 chain misses by PLAIN_MISS or
    more."""
    ct = torch.tensor(np.random.default_rng(46).normal(
        size=tuple(single_operands[2].shape)))
    args = (op, headline_cache, *single_operands)
    want = _variance_grads(*args, F64, ct)[1:]
    got = _variance_grads(*args, F32, ct)[1:]
    monkeypatch.setattr(moments, '_single_trace', _plain)
    plain = _variance_grads(*args, F32, ct)[1:]
    for name, g, p, w in zip(('du', 'dS'), got, plain, want):
        peak = w.abs().flatten(1).max(dim=1).values
        bar = 2 * EPS32 * (w.abs() + peak.view(-1, *([1] * (w.ndim - 1))))
        assert g.dtype == F32
        assert _misses(g, w, bar) <= 1.0, f'{op} {name}: {_misses(g, w, bar)}'
        assert _misses(p, w, bar) > PLAIN_MISS, f'{op} {name} plain'


@pytest.mark.parametrize('op', ['multi', 'cached'])
def test_single_input_f64_operands_pass_through(monkeypatch, headline_cache,
                                                single_operands, op):
    """With f64 operands the policy changes nothing: the variance and its
    cotangents equal the chain's own evaluation to the bit."""
    u, s, means = (v.double() for v in single_operands)
    cache = build_rollout_cache(make_headline_problem(
        b=2, dtype=F64, device='cpu').gp, 2, 1)
    ct = torch.tensor(np.random.default_rng(47).normal(size=means.shape))
    policy = _variance_grads(op, cache, u, s, means, F64, ct)
    monkeypatch.setattr(moments, '_single_trace', _plain)
    plain = _variance_grads(op, cache, u, s, means, F64, ct)
    for p, n in zip(policy, plain):
        assert p.dtype == F64 and torch.equal(p, n)
