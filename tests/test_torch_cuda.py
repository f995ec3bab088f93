"""The CUDA kernels of gpmpc_tpu_torch on the card, against their plain
PyTorch versions. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor gpmpc_tpu, so it also runs on a machine
with the card and no JAX: from the repository root,

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(tests/conftest.py configures JAX, hence --noconftest there).
"""

import functools
import types

import numpy as np
import pytest
import torch

import chip_smoke

from gpmpc_tpu_torch.benchmarks.chain import kernel_args
from gpmpc_tpu_torch.ops.kernels import eigh_small, probe
from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt
from gpmpc_tpu_torch.utils import replay_counts

torch.set_num_threads(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda')


def _problem(tied, b, e, n, d, seed):
    """The JAX kernel test's inputs (tests/test_batched.py,
    TestTiedStreamedKernel._problem), as numpy f64."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, d))
    m = rng.normal(size=(b, d, d) if tied else (b, e, d, d))
    m2 = m @ np.swapaxes(m, -1, -2) * 0.1 + np.eye(d)
    x = rng.normal(size=(n, d))
    br = rng.normal(size=(e, n, n)) * 0.003
    return u, m2, x, br + np.swapaxes(br, -1, -2), rng.normal(size=(b, e))


@pytest.mark.cuda
@pytest.mark.parametrize('tied', [True, False])
@pytest.mark.parametrize('shape', [(7, 2, 200, 3), (256, 2, 256, 3),
                                   (3, 8, 130, 8)])
def test_cuda_kernel_matches_plain_version(tied, shape):
    """K1 / K2's f32 instances on the card (the trace evaluated natively in
    f32) against the plain version in f64: forward rtol 5e-5 (atol 5e-5),
    backward rtol 2e-3 (atol 2e-4), the bars of the JAX kernel test
    (tests/test_batched.py TestTiedStreamedKernel). One launch a trace, K2's
    for all E outputs."""
    dev = _cuda()
    b, e, n, d = shape
    u, m2, x, blam, ct = _problem(tied, b, e, n, d, seed=5)
    tfn = functools.partial(tvt.variance_trace_batched_tied if tied
                            else tvt.variance_trace_batched, native=True)
    rfn = (tvt.variance_trace_batched_tied_reference if tied
           else tvt.variance_trace_batched_reference)

    def run(fn, dtype):
        ut = torch.tensor(u, dtype=dtype, device=dev, requires_grad=True)
        mt = torch.tensor(m2, dtype=dtype, device=dev, requires_grad=True)
        out = fn(ut, mt, torch.tensor(x, dtype=dtype, device=dev),
                 torch.tensor(blam, dtype=dtype, device=dev))
        grads = torch.autograd.grad(
            torch.sum(out * torch.tensor(ct, dtype=dtype, device=dev)), (ut, mt))
        return [v.detach().cpu().double().numpy() for v in (out, *grads)]

    before = tvt.LAUNCHES + tvt.LAUNCHES_UNTIED
    k_out, k_gu, k_gm = run(tfn, torch.float32)
    torch.cuda.synchronize()
    assert tvt.LAUNCHES + tvt.LAUNCHES_UNTIED == before + 1
    r_out, r_gu, r_gm = run(rfn, torch.float64)
    np.testing.assert_allclose(k_out, r_out, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(k_gu, r_gu, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(k_gm, r_gm, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n', [200, 256])
@pytest.mark.parametrize('b', [64, 128, 1024, 2048, 3584])
def test_cuda_k1_at_recipe_widths(b, n, dtype):
    """K1 at the lane counts of the multistart recipe (polish and refinement
    chunks, pruned and full phase-0 rounds, the exchange rounds' 14
    candidates of 256 lanes): value and analytic gradients in `dtype`
    against the plain version in f64 at the JAX kernel test's bars (forward
    rtol 5e-5 atol 5e-5, backward rtol 2e-3 atol 2e-4); the f64 instance's
    value also at rtol 1e-12. One counted launch of the `dtype` instance
    (the trace evaluated natively)."""
    dev = _cuda()
    u, m2, x, blam, ct = _problem(True, b, 2, n, 3, seed=13)

    def run(fn, dt):
        f = lambda v: torch.tensor(v, dtype=dt, device=dev)
        ut, mt = f(u).requires_grad_(), f(m2).requires_grad_()
        out = fn(ut, mt, f(x), f(blam))
        grads = torch.autograd.grad(torch.sum(out * f(ct)), (ut, mt))
        return [v.detach().cpu().double().numpy() for v in (out, *grads)]

    before = (tvt.LAUNCHES, tvt.LAUNCHES_F64)
    k_out, k_gu, k_gm = run(functools.partial(tvt.variance_trace_batched_tied,
                                              native=True), dtype)
    torch.cuda.synchronize()
    f64 = int(dtype == torch.float64)
    assert (tvt.LAUNCHES, tvt.LAUNCHES_F64) == (before[0] + 1, before[1] + f64)
    r_out, r_gu, r_gm = run(tvt.variance_trace_batched_tied_reference,
                            torch.float64)
    np.testing.assert_allclose(k_out, r_out, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(k_gu, r_gu, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(k_gm, r_gm, rtol=2e-3, atol=2e-4)
    if dtype == torch.float64:
        np.testing.assert_allclose(k_out, r_out, rtol=1e-12, atol=1e-15)


@pytest.mark.cuda
def test_cuda_f64_instance_matches_plain_version():
    """The f64 instance (the reference objective on the card): the same sums
    in another order, rtol 1e-12."""
    dev = _cuda()
    u, m2, x, blam, _ = _problem(True, 5, 2, 200, 3, seed=6)
    args = [torch.tensor(v, dtype=torch.float64, device=dev)
            for v in (u, m2, x, blam)]
    np.testing.assert_allclose(
        tvt.variance_trace_batched_tied(*args).cpu().numpy(),
        tvt.variance_trace_batched_tied_reference(*args).cpu().numpy(),
        rtol=1e-12, atol=1e-15)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['d9', 'mixed_devices'])
def test_cuda_launch_raises_instead_of_falling_back(case):
    dev = _cuda()
    b, e, n, d = 2, 2, 8, 9 if case == 'd9' else 3
    z = lambda *s: torch.zeros(*s, device=dev)
    args = [z(b, n, d), z(b, n), z(b, n, d), z(b, n, d + 1), z(e, n, n)]
    if case == 'mixed_devices':
        args[4] = args[4].cpu()
    before = tvt.LAUNCHES
    with pytest.raises(ValueError):
        tvt.rw_tied(*args)
    assert tvt.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize('n_blocks', [2, 4])
def test_cuda_block_kernel_matches_plain_version(n_blocks):
    """K3: the f32 instance's row-block partials on the card (evaluated
    natively), summed over n_blocks, against the plain full trace in f64
    (fwd rtol 5e-5 atol 5e-5, bwd rtol 2e-3 atol 2e-4); the f64 instance per
    block against the plain block, rtol 1e-12."""
    dev = _cuda()
    b, e, n, d = 256, 2, 256, 3
    u, m2, x, blam, ct = _problem(True, b, e, n, d, seed=7)
    n_loc = n // n_blocks

    def run(dtype):
        f = lambda v: torch.tensor(v, dtype=dtype, device=dev)
        ut, mt = f(u).requires_grad_(), f(m2).requires_grad_()
        parts = [tvt.variance_trace_tied_block(
            ut, mt, f(x), f(x[k:k + n_loc]),
            f(np.ascontiguousarray(np.swapaxes(blam[:, k:k + n_loc], 1, 2))),
            native=True) for k in range(0, n, n_loc)]
        out = sum(parts)
        grads = torch.autograd.grad(torch.sum(out * f(ct)), (ut, mt))
        return [v.detach().cpu().double().numpy() for v in (out, *grads)]

    before = tvt.LAUNCHES_BLOCK
    k_out, k_gu, k_gm = run(torch.float32)
    torch.cuda.synchronize()
    assert tvt.LAUNCHES_BLOCK == before + n_blocks
    r_out, r_gu, r_gm = run_reference(u, m2, x, blam, ct, dev)
    np.testing.assert_allclose(k_out, r_out, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(k_gu, r_gu, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(k_gm, r_gm, rtol=2e-3, atol=2e-4)

    f64 = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    a, _, dv = tvt._prep_tied(f64(u), f64(m2), f64(x))
    aod = tvt._aug(a) * dv[..., None]
    for k in range(0, n, n_loc):
        _, g_b, dv_b = tvt._prep_tied(f64(u), f64(m2), f64(x[k:k + n_loc]))
        blk = f64(np.ascontiguousarray(np.swapaxes(blam[:, k:k + n_loc], 1, 2)))
        np.testing.assert_allclose(
            tvt.rw_tied_block(g_b, dv_b, a, aod, blk).cpu().numpy(),
            tvt.rw_tied_block_reference(g_b, dv_b, a, aod, blk).cpu().numpy(),
            rtol=1e-12, atol=1e-15)


def run_reference(u, m2, x, blam, ct, dev):
    """The plain tied trace in f64 and its autograd gradient."""
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    ut, mt = f(u).requires_grad_(), f(m2).requires_grad_()
    out = tvt.variance_trace_batched_tied_reference(ut, mt, f(x), f(blam))
    grads = torch.autograd.grad(torch.sum(out * f(ct)), (ut, mt))
    return [v.detach().cpu().double().numpy() for v in (out, *grads)]


@pytest.mark.cuda
@pytest.mark.parametrize('tied', [True, False])
@pytest.mark.parametrize('shape', [(7, 2, 200, 3), (256, 2, 256, 3),
                                   (3, 8, 130, 8)])
def test_cuda_sym_kernel_matches_plain_version(monkeypatch, tied, shape):
    """K4's f32 instance (GPMPC_SYM_KERNEL=1, the trace evaluated natively)
    on the card against the plain column sweep in f64, at the bars of the K1
    test above; one launch a trace for all E."""
    dev = _cuda()
    monkeypatch.setenv('GPMPC_SYM_KERNEL', '1')
    b, e, n, d = shape
    u, m2, x, blam, ct = _problem(tied, b, e, n, d, seed=8)
    tfn = functools.partial(tvt.variance_trace_batched_tied if tied
                            else tvt.variance_trace_batched, native=True)
    rfn = (tvt.variance_trace_batched_tied_reference if tied
           else tvt.variance_trace_batched_reference)

    def run(fn, dtype):
        f = lambda v: torch.tensor(v, dtype=dtype, device=dev)
        ut, mt = f(u).requires_grad_(), f(m2).requires_grad_()
        out = fn(ut, mt, f(x), f(blam))
        grads = torch.autograd.grad(torch.sum(out * f(ct)), (ut, mt))
        return [v.detach().cpu().double().numpy() for v in (out, *grads)]

    before = (tvt.LAUNCHES, tvt.LAUNCHES_UNTIED, tvt.LAUNCHES_SYM)
    k_out, k_gu, k_gm = run(tfn, torch.float32)
    torch.cuda.synchronize()
    assert (tvt.LAUNCHES, tvt.LAUNCHES_UNTIED, tvt.LAUNCHES_SYM) == (
        before[0], before[1], before[2] + 1)
    r_out, r_gu, r_gm = run(rfn, torch.float64)
    np.testing.assert_allclose(k_out, r_out, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(k_gu, r_gu, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(k_gm, r_gm, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('tied', [True, False])
def test_cuda_sym_f64_instance_matches_plain_version(tied):
    """K4's f64 instance against its plain version in f64, rtol 1e-12."""
    dev = _cuda()
    u, m2, x, blam, _ = _problem(tied, 5, 2, 200, 3, seed=9)
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    a, z, dv = tvt._prep_sym(f(u), f(m2), f(x), 1 if tied else 2)
    args = (z.contiguous(), a, dv.contiguous(), tvt._aug(a), f(blam))
    np.testing.assert_allclose(
        tvt.rw_sym(*args, shared_chain=tied).cpu().numpy(),
        tvt.rw_sym_reference(*args, shared_chain=tied).cpu().numpy(),
        rtol=1e-12, atol=1e-15)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['d9', 'mixed_devices'])
def test_cuda_sym_launch_raises_instead_of_falling_back(case):
    dev = _cuda()
    b, e, n, d = 2, 2, 8, 9 if case == 'd9' else 3
    z = lambda *s: torch.zeros(*s, device=dev)
    args = [z(b, n, d), z(b, n, d), z(b, n), z(b, n, d + 1), z(e, n, n)]
    if case == 'mixed_devices':
        args[4] = args[4].cpu()
    before = (tvt.LAUNCHES, tvt.LAUNCHES_SYM)
    with pytest.raises(ValueError):
        tvt.rw_sym(*args, shared_chain=True)
    assert (tvt.LAUNCHES, tvt.LAUNCHES_SYM) == before


def _probe_args(b, n, seed, dev):
    """K1's f32 arguments on the JAX kernel test's inputs."""
    u, m2, x, blam, _ = _problem(True, b, 2, n, 3, seed)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    return kernel_args(f(u), f(m2), f(x), f(blam))


@pytest.mark.cuda
@pytest.mark.parametrize('variant', probe.VARIANTS)
@pytest.mark.parametrize('shape', [(256, 256), (7, 200)])
def test_cuda_probe_variant_matches_plain_versions(variant, shape):
    """The probe kernel's variant against each plain version of
    probe.checks, elementwise within its bar: scalar variants rtol 5e-5 atol
    5e-5 against their f64 plain version; hwexp at those bars plus __expf's
    documented 2 + 1.173 |x| ulp; the tensor-core variants against their
    TF32-emulating plain version at 2 N eps a pass of the terms' magnitude
    sum plus the operands' rounding slack, and red_3xtf32 and tc_p also
    against the plain f64 full at 5e-5. One launch, counted."""
    dev = _cuda()
    args = _probe_args(*shape, seed=10, dev=dev)
    before = probe.LAUNCHES_PROBE
    out = probe.rw_probe(variant, *args).double()
    torch.cuda.synchronize()
    assert probe.LAUNCHES_PROBE == before + 1
    for label, want, bar in probe.checks(variant, *args):
        ratio = float(((out - want).abs() / bar).max())
        assert ratio <= 1.0, f'{variant} vs {label}: {ratio:.3f}x its bar'


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(256, 256), (7, 200), (3, 130), (1, 1),
                                   (257, 257)])
def test_cuda_probe_full_equals_k1_to_the_bit(shape):
    """`full` is K1's body instantiated as K1 is: the same rw bits."""
    dev = _cuda()
    args = _probe_args(*shape, seed=11, dev=dev)
    assert torch.equal(probe.rw_probe('full', *args), tvt.rw_tied(*args))


def _rw_args(kernel, b, n, d, e, dtype, dev):
    """The wrapper's arguments for `kernel` on the JAX kernel test's inputs
    (prepared in f64, then cast), and its plain version."""
    u, m2, x, blam, _ = _problem(kernel not in ('K2', 'K4 per-output'), b,
                                 e, n, d, seed=12)
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    cast = lambda ts: [t.to(dtype).contiguous() for t in ts]
    if kernel == 'K2':
        a, g, dv = tvt._prep_batched(f(u), f(m2), f(x))
        return (cast((g, dv, a, tvt._aug(a), f(blam))), tvt.rw_untied,
                tvt.rw_untied_reference, 'LAUNCHES_UNTIED')
    if kernel in ('K1', 'K3'):
        a, g, dv = tvt._prep_tied(f(u), f(m2), f(x))
        aod = tvt._aug(a) * dv[..., None]
        if kernel == 'K1':
            return (cast((g, dv, a, aod, f(blam))), tvt.rw_tied,
                    tvt.rw_tied_reference, 'LAUNCHES')
        n_loc = max(1, n // 2 + 1) if n > 1 else 1
        _, g_b, dv_b = tvt._prep_tied(f(u), f(m2), f(x[:n_loc]))
        blk = f(np.ascontiguousarray(np.swapaxes(blam[:, :n_loc], 1, 2)))
        return (cast((g_b, dv_b, a, aod, blk)), tvt.rw_tied_block,
                tvt.rw_tied_block_reference, 'LAUNCHES_BLOCK')
    tied = kernel == 'K4 tied'
    a, z, dv = tvt._prep_sym(f(u), f(m2), f(x), 1 if tied else 2)
    args = cast((z, a, dv, tvt._aug(a), f(blam)))
    return (args, lambda *t: tvt.rw_sym(*t, shared_chain=tied),
            lambda *t: tvt.rw_sym_reference(*t, tied), 'LAUNCHES_SYM')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('de', [(1, 1), (3, 2), (8, 8)])
@pytest.mark.parametrize('n', [1, 130, 200, 257])
@pytest.mark.parametrize('b', [1, 3, 7, 257])
@pytest.mark.parametrize('kernel', ['K1', 'K2', 'K3', 'K4 tied',
                                    'K4 per-output'])
def test_cuda_rw_ragged_plans_match_plain_version(kernel, b, n, de, dtype):
    """K1's body (K1, K2 in one launch for all E, and K3 on n // 2 + 1 of n
    rows) and K4 at B not a multiple of S, N not a multiple of a block's
    rows or tile, and the (d, E) corners: rw against the plain version in f64 on the same inputs, f32 at
    rtol 5e-5 atol 5e-5 (the JAX kernel test's bar), f64 at rtol 1e-12. One
    counted launch."""
    dev = _cuda()
    d, e = de
    args, fn, ref, counter = _rw_args(kernel, b, n, d, e, dtype, dev)
    before = getattr(tvt, counter)
    got = fn(*args).double()
    torch.cuda.synchronize()
    assert getattr(tvt, counter) == before + 1
    want = ref(*(t.double() for t in args))
    tol = (dict(rtol=5e-5, atol=5e-5) if dtype == torch.float32
           else dict(rtol=1e-12, atol=1e-15))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


# ------------------------------------------- the precision policy, full S --
def _headline(dev, b, seed):
    """The headline GP's x and b_lam (f64) on `dev`, with B scenarios' u in
    its data range and M2 = (Lambda/2 + S)^{-1} as the full-covariance
    rollout makes it: Lambda = 4 I and a joint covariance S whose state block
    is a correlated SPD matrix of the size a 20-step rollout reaches (0.001
    to 0.6, correlations up to 0.95) and whose action block is 1e-3."""
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.problems import DATA_SCALE, make_headline_problem
    cache = build_rollout_cache(make_headline_problem(
        b=2, dtype=torch.float64, device=dev).gp, 2, 1)
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, (b, 3)) * DATA_SCALE
    sd = np.exp(rng.uniform(np.log(0.03), np.log(0.8), (b, 2)))
    rho = rng.uniform(-0.95, 0.95, b)
    s = np.zeros((b, 3, 3))
    s[:, 0, 0], s[:, 1, 1] = sd[:, 0] ** 2, sd[:, 1] ** 2
    s[:, 0, 1] = s[:, 1, 0] = rho * sd[:, 0] * sd[:, 1]
    s[:, 2, 2] = 1e-3
    m2 = np.linalg.inv(2.0 * np.eye(3) + s)
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    return f(u), f(m2), cache.x, cache.b_lam


def _conditioned_bar(ref, u, m2, x, blam, rtol, eps):
    """rtol |t64| + 16 eps of the terms' magnitude sum (chip_smoke.py's bar
    on the cancelling headline trace)."""
    return rtol * ref(u, m2, x, blam).abs() + 16 * eps * ref(u, m2, x,
                                                            blam.abs())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('b', [64, 256, 1024, 3584])
def test_cuda_k1_full_cov_m2_on_headline(b, dtype):
    """K1's `dtype` instance (evaluated natively) with the non-diagonal SPD
    M2 of a full-covariance rollout on the headline GP's x and b_lam,
    against the plain f64 trace: rtol 5e-5 (f32) or 1e-12 (f64) of |t| plus
    16 ulps of the terms' magnitude sum."""
    dev = _cuda()
    u, m2, x, blam = _headline(dev, b, seed=20)
    assert float(m2[:, 0, 1].abs().max()) > 1e-2
    ops = [v.to(dtype) for v in (u, m2, x, blam)]
    ref = tvt.variance_trace_batched_tied_reference
    want = ref(*(v.double() for v in ops))
    before = tvt.LAUNCHES_F64
    got = tvt.variance_trace_batched_tied(*ops, native=True).double()
    torch.cuda.synchronize()
    assert tvt.LAUNCHES_F64 == before + int(dtype == torch.float64)
    rtol = 5e-5 if dtype == torch.float32 else 1e-12
    bar = _conditioned_bar(ref, *(v.double() for v in ops), rtol,
                           torch.finfo(dtype).eps)
    ratio = float(((got - want).abs() / bar).max())
    assert ratio <= 1.0, f'{ratio:.3f}x the bar'


@pytest.mark.cuda
@pytest.mark.parametrize('path', ['K1', 'K2', 'K4 tied', 'K4 per-output'])
def test_cuda_policy_trace_matches_plain_f64(monkeypatch, path):
    """The precision policy on the card: from f32 operands (the headline
    GP's, full-covariance M2) every path launches its f64 instance and
    returns f32 t within one f32 ulp of the plain f64 trace of the same
    operands, plus 16 f64 ulps of the terms' magnitude sum."""
    dev = _cuda()
    b, tied = 256, path in ('K1', 'K4 tied')
    u, m2, x, blam = _headline(dev, b, seed=21)
    if not tied:
        m2 = torch.stack([m2, m2.flip(0)], dim=1)           # (B, E, d, d)
    ops = [v.to(torch.float32) for v in (u, m2, x, blam)]
    fn = tvt.variance_trace_batched_tied if tied else tvt.variance_trace_batched
    ref = (tvt.variance_trace_batched_tied_reference if tied
           else tvt.variance_trace_batched_reference)
    if path.startswith('K4'):
        monkeypatch.setenv('GPMPC_SYM_KERNEL', '1')
    before = (tvt.LAUNCHES - tvt.LAUNCHES_F64, tvt.LAUNCHES_F64)
    got = fn(*ops)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    if path == 'K1':
        assert (tvt.LAUNCHES - tvt.LAUNCHES_F64, tvt.LAUNCHES_F64) == (
            before[0], before[1] + 1)
    ops64 = [v.double() for v in ops]
    want = ref(*ops64)
    bar = (torch.finfo(torch.float32).eps * want.abs()
           + 16 * torch.finfo(torch.float64).eps * ref(*ops64[:3],
                                                        ops64[3].abs()))
    ratio = float(((got.double() - want).abs() / bar).max())
    assert ratio <= 1.0, f'{path}: {ratio:.3f}x the bar'


@pytest.mark.cuda
@pytest.mark.parametrize('delta', [False, True])
def test_cuda_full_cov_rollout_matches_cpu(delta):
    """rollout_batched(full_cov=True) on the card (K1's f64 instance) against
    the same call on the CPU (the plain trace), f64, on the headline problem
    at B = 16: means, covariances and d/du, rtol 1e-9."""
    from gpmpc_tpu_torch.dynamics import build_rollout_cache, rollout_batched
    from gpmpc_tpu_torch.problems import make_headline_problem
    dev = _cuda()
    us = np.random.default_rng(22).uniform(-2, 2, (16, 20, 1))
    outs = {}
    for where in ('cpu', dev):
        p = make_headline_problem(b=16, dtype=torch.float64, device=where)
        cache = build_rollout_cache(p.gp, 2, 1)
        u = torch.tensor(us, dtype=torch.float64, device=where,
                         requires_grad=True)
        m, c = rollout_batched(cache, p.x0s, u, full_cov=True, delta=delta)
        (g,) = torch.autograd.grad(m.sum() + c.sum(), u)
        outs[str(where)] = [v.detach().cpu().numpy() for v in (m, c, g)]
    for got, want in zip(outs[str(dev)], outs['cpu']):
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize('de', [(2, 1), (3, 2), (5, 4)])
@pytest.mark.parametrize('nv', [(128, 100), (512, 320)])
@pytest.mark.parametrize('b', [1, 5])
@pytest.mark.parametrize('tied', [True, False])
def test_cuda_kernel_at_closed_loop_shapes(tied, b, nv, de):
    """K1 / K2's f32 instances at the closed loop's shapes (B = 1 and the
    multistart's 5 candidates; capacity N with the padded rows' x and blam
    zeroed; the integrator's, pendulum's and cartpole's (d, E)) against the
    plain version in f64 at the JAX kernel test's bars, and the f64
    instances within 1e-12 relative plus 16 ulps of the magnitude sum."""
    dev = _cuda()
    (n, n_valid), (d, e) = nv, de
    u, m2, x, blam, ct = _problem(tied, b, e, n, d, seed=13)
    x[n_valid:] = 0.0
    blam[:, n_valid:] = 0.0
    blam[:, :, n_valid:] = 0.0
    tfn = functools.partial(tvt.variance_trace_batched_tied if tied
                            else tvt.variance_trace_batched, native=True)
    rfn = (tvt.variance_trace_batched_tied_reference if tied
           else tvt.variance_trace_batched_reference)

    def run(fn, dtype):
        ut = torch.tensor(u, dtype=dtype, device=dev, requires_grad=True)
        mt = torch.tensor(m2, dtype=dtype, device=dev, requires_grad=True)
        out = fn(ut, mt, torch.tensor(x, dtype=dtype, device=dev),
                 torch.tensor(blam, dtype=dtype, device=dev))
        grads = torch.autograd.grad(
            torch.sum(out * torch.tensor(ct, dtype=dtype, device=dev)), (ut, mt))
        return [v.detach().cpu().double().numpy() for v in (out, *grads)]

    k_out, k_gu, k_gm = run(tfn, torch.float32)
    r_out, r_gu, r_gm = run(rfn, torch.float64)
    np.testing.assert_allclose(k_out, r_out, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(k_gu, r_gu, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(k_gm, r_gm, rtol=2e-3, atol=2e-4)
    k64 = run(tfn, torch.float64)[0]
    mag = np.abs(run(lambda uu, mm, xx, bb: rfn(uu, mm, xx, bb.abs()),
                     torch.float64)[0])
    assert np.all(np.abs(k64 - r_out) <= 1e-12 * np.abs(r_out)
                  + 16 * np.finfo(np.float64).eps * mag)


@pytest.mark.cuda
def test_cuda_closed_loop_matches_cpu():
    """The integrator's controller (K1 f64 at B = 1) and a train_gp followed
    by an untied solve (K2, one launch a trace, H (1 + iters) a B = 1 solve)
    on the card against the same on the CPU, f64."""
    from gpmpc_tpu_torch.experiments.integrator import integrator_experiment
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    dev = _cuda()
    u_gpu, err = integrator_experiment(verbose=False, device=dev)
    u_cpu, _ = integrator_experiment(verbose=False, device='cpu')
    assert err < 5e-3
    np.testing.assert_allclose(u_gpu, u_cpu, rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(3)
    s, a = rng.uniform(-1, 1, (40, 2)), rng.uniform(-1, 1, (40, 1))
    ns = s + 0.1 * np.concatenate([s[:, 1:], a], 1) + 0.02 * np.sin(s)
    outs = {}
    for where in (dev, 'cpu'):
        mpc = RiskSensitiveMPC(gamma=0.2, horizon=5, state_dim=2, input_dim=1,
                               Q=np.eye(2), R=0.1 * np.eye(1), capacity=64,
                               delta_dynamics=True, dtype=torch.float64,
                               solver=SolverConfig(max_iters=30), device=where)
        mpc.set_ub([1.0])
        mpc.set_lb([-1.0])
        mpc.dynamics.append_train_data(s, a, ns)
        res = mpc.train_gp(num_iters=20)
        replay_counts.settle()
        before = tvt.LAUNCHES_UNTIED
        u = mpc.get_optimal_trajectory(np.array([0.5, -0.2]))
        # The device loop's replays count once its passes are read.
        replay_counts.settle()
        outs[str(where)] = (res.iters, mpc.gp.log_lambdas.cpu().numpy(), u,
                            tvt.LAUNCHES_UNTIED - before,
                            5 * (1 + int(mpc.last_result.iters)))
    g, c = outs[str(dev)], outs['cpu']
    # One K2 launch a trace for both outputs: H traces a value-and-grad.
    assert g[0] == c[0] and g[3] == g[4] and c[3] == 0
    np.testing.assert_allclose(g[1], c[1], rtol=1e-8)
    np.testing.assert_allclose(g[2], c[2], rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(256, 128, 128, 5, 4), (64, 128, 128, 3, 2),
                                   (1, 512, 400, 4, 2),
                                   chip_smoke.CONFIG3_SHAPE])
def test_cuda_k1_at_sparse_shapes(shape):
    """K1 at the shapes of the sparse workloads, the uncertainty experiment
    and suite config 3 ((B, N, valid rows, d, E): config 3b, config 4, the
    experiment's 400 points in capacity 512, config 3's 1,000 in 1,024):
    the f32 instance against the plain version in f64 at the JAX kernel
    test's bars, the f64 instance within 1e-12 relative plus 16 ulps of the
    magnitude sum. Above N = 512 the plain version is taken in lane chunks
    (chip_smoke.chunked): whole, its f64 intermediates at config 3's shape
    are 8.6 GB each."""
    dev = _cuda()
    b, n, n_valid, d, e = shape
    u, m2, x, blam, ct = _problem(True, b, e, n, d, seed=31)
    x[n_valid:] = 0.0
    blam[:, n_valid:] = 0.0
    blam[:, :, n_valid:] = 0.0
    tfn = functools.partial(tvt.variance_trace_batched_tied, native=True)
    rfn = tvt.variance_trace_batched_tied_reference
    if n > 512:
        rfn = chip_smoke.chunked(rfn, chip_smoke.CONFIG3_CHUNK)

    def run(fn, dtype, bl=blam):
        ut = torch.tensor(u, dtype=dtype, device=dev, requires_grad=True)
        mt = torch.tensor(m2, dtype=dtype, device=dev, requires_grad=True)
        out = fn(ut, mt, torch.tensor(x, dtype=dtype, device=dev),
                 torch.tensor(bl, dtype=dtype, device=dev))
        grads = torch.autograd.grad(
            torch.sum(out * torch.tensor(ct, dtype=dtype, device=dev)), (ut, mt))
        return [v.detach().cpu().double().numpy() for v in (out, *grads)]

    k_out, k_gu, k_gm = run(tfn, torch.float32)
    r_out, r_gu, r_gm = run(rfn, torch.float64)
    np.testing.assert_allclose(k_out, r_out, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(k_gu, r_gu, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(k_gm, r_gm, rtol=2e-3, atol=2e-4)
    k64 = run(tfn, torch.float64)[0]
    mag = np.abs(run(rfn, torch.float64, np.abs(blam))[0])
    assert np.all(np.abs(k64 - r_out) <= 1e-12 * np.abs(r_out)
                  + 16 * np.finfo(np.float64).eps * mag)


@pytest.mark.cuda
def test_cuda_k1_bodies_at_config3_shape():
    """At suite config 3's shape (chip_smoke.CONFIG3_SHAPE) the route takes
    the tensor-core body, and rw in each body, forced, is within phase 3's
    f64 bar."""
    dev = _cuda()
    b, n, _, d, e = chip_smoke.CONFIG3_SHAPE
    assert tvt.rw_tied_body(b, n, n, d, e, torch.float64,
                            tvt.device_sms(dev)) == 'mma'
    args = _mma_args(b, n, n, d, e, dev, seed=33)
    for body in ('mma', 'scalar'):
        got, launched = tvt._launch(*args, body=body)
        torch.cuda.synchronize()
        assert launched
        _assert_mma_bar(got, args, f'{body} B={b} N={n} d={d} E={e}')


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['3b_sparse_cartpole', '4_sparse_fullcov'])
def test_cuda_fit_sparse_matches_cpu(name):
    """The suite's sparse problems fitted on the card (f64 FITC, cuSOLVER)
    against the same fit on the CPU: W and alpha within 1e-6 of their
    largest entry (the fits' condition reaches 5e5; the CPU and JAX read
    3.3e-8 on config 4), and the f32 problem's fit (run in f64 and rounded)
    finite and within 1e-5 of the f64 one."""
    from gpmpc_tpu_torch.problems import sparse_problem
    dev = _cuda()
    fits = {str(where): sparse_problem(name, b=4, dtype=torch.float64,
                                       device=where).gp
            for where in (dev, 'cpu')}
    for k in ('kinv', 'beta'):
        got = getattr(fits[str(dev)], k).cpu().numpy()
        want = getattr(fits['cpu'], k).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
    gp32 = sparse_problem(name, b=4, dtype=torch.float32, device=dev).gp
    assert gp32.kinv.dtype == torch.float32 and gp32.kinv.is_cuda
    want = fits['cpu'].beta.numpy()
    np.testing.assert_allclose(gp32.beta.cpu().double().numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())


# ------------------------------------- the small-B plan (K1's body, K2) --
LOOP_SHAPES = [(b, n, v, d, e) for b in (1, 5) for n, v in ((128, 100),
                                                          (512, 320))
               for d, e in ((2, 1), (3, 2), (5, 4))] + [(64, 128, 128, 3, 2)]


def _split_args(kernel, shape, dtype, dev, seed):
    """K1's or K2's arguments at a loop shape (padded rows zeroed), prepped
    in f64 and cast; the wrapper, the split sum's plain version under the
    wrapper's plan on this card, its counter and the plan."""
    b, n, n_valid, d, e = shape
    tied = kernel == 'K1'
    u, m2, x, blam, _ = _problem(tied, b, e, n, d, seed)
    x[n_valid:] = 0.0
    blam[:, n_valid:] = 0.0
    blam[:, :, n_valid:] = 0.0
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    sms = tvt.device_sms(dev)
    if tied:
        a, g, dv = tvt._prep_tied(f(u), f(m2), f(x))
        args = [t.to(dtype).contiguous()
                for t in (g, dv, a, tvt._aug(a) * dv[..., None], f(blam))]
        plan = tvt.rw_tied_plan(b, n, n, d, e, dtype, sms)
        return (args, tvt.rw_tied, functools.partial(
            tvt.rw_split_reference, plan=plan), 'LAUNCHES', plan)
    a, g, dv = tvt._prep_batched(f(u), f(m2), f(x))
    args = [t.to(dtype).contiguous() for t in (g, dv, a, tvt._aug(a), f(blam))]
    plan = tvt.rw_untied_plan(b, n, d, e, dtype, sms)
    return (args, tvt.rw_untied, functools.partial(
        tvt.rw_untied_split_reference, plan=plan), 'LAUNCHES_UNTIED', plan)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('shape', LOOP_SHAPES)
@pytest.mark.parametrize('kernel', ['K1', 'K2'])
def test_cuda_small_b_plan_matches_split_plain_version(kernel, shape, dtype):
    """K1 and K2 (one launch for all E) at every closed-loop shape and at
    config 4, at the plan for this card (S <= B, the contraction split over
    a cluster where the grid is small): rw against the split sum's plain
    version in f64 on the same operands, f32 at the JAX kernel test's bar
    (rtol 5e-5 atol 5e-5), f64 at the conditioned bar (1e-12 |rw| plus 16
    f64 ulps of the terms' magnitude sum). One counted launch."""
    dev = _cuda()
    args, fn, ref, counter, plan = _split_args(kernel, shape, dtype, dev, 40)
    assert plan.scenarios <= shape[0]
    before = getattr(tvt, counter)
    got = fn(*args).double()
    torch.cuda.synchronize()
    assert getattr(tvt, counter) == before + 1
    a64 = [t.double() for t in args]
    want = ref(*a64)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=5e-5, atol=5e-5)
        return
    mag = ref(a64[0], a64[1], a64[2], a64[3].abs(), a64[4].abs())
    err = (got - want).abs()
    bar = 1e-12 * want.abs() + 16 * torch.finfo(torch.float64).eps * mag
    # The padded rows are 0 in both, their bar 0: compare, do not divide.
    assert bool((err <= bar).all()), (
        f'{kernel} {shape}: {float((err / bar)[bar > 0].max()):.3f}x the bar')


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 512, 320, 3, 2), (5, 512, 320, 5, 4),
                                   (1, 128, 100, 2, 1), (256, 256, 200, 3, 2)])
@pytest.mark.parametrize('kernel', ['K1', 'K2'])
def test_cuda_same_inputs_same_bits(kernel, shape):
    """The ranks' partials are added in a fixed order, so the same f64
    operands give the same rw to the bit, split or not."""
    dev = _cuda()
    args, fn, _, _, _ = _split_args(kernel, shape, torch.float64, dev, 41)
    first = fn(*args)
    for _ in range(3):
        assert torch.equal(fn(*args), first)


@pytest.mark.cuda
def test_cuda_refused_launch_raises():
    """A plan the card refuses (a cluster of 32 blocks, past the hardware's
    16, asked for through the launch's split cap) raises RuntimeError and
    counts nothing; the next launch runs and is right."""
    dev = _cuda()
    rng = np.random.default_rng(42)
    f = lambda *s: torch.tensor(rng.normal(size=s), device=dev)
    args = [f(1, 64, 1), f(1, 64), f(1, 512, 1), f(1, 512, 2), f(1, 512, 64)]
    assert tvt._plan(1, 64, 512, 1, 1, 1, torch.float64, tvt.device_sms(dev),
                     False, max_split=32).split == 32
    before = tvt.LAUNCHES
    with pytest.raises(RuntimeError):
        tvt._launch(*args, max_split=32)
    assert tvt.LAUNCHES == before
    got = tvt.rw_tied(*args)
    torch.cuda.synchronize()
    want = tvt.rw_tied_reference(*args).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


# ------------------------------- K1's f64 tensor-core body (K1 and K3) --
# (d, E) of the tensor-core body's cases: every d at the headline's E, every
# E at its d, the corners and config 3b's (5, 4).
MMA_DE = sorted({(d, 2) for d in range(1, 9)} | {(3, e) for e in range(1, 9)}
                | {(8, 8), (5, 4), (1, 1)})


def _mma_b(d, e):
    """B across the S boundaries of the tensor-core body's plan: 1, S - 1,
    S, S + 1 and 2 S + 1 at S = S_max(d, E)."""
    s = tvt.rw_tied_mma_scenarios(d, e)
    return sorted({1, max(1, s - 1), s, s + 1, 2 * s + 1})


def _mma_args(b, n, n_loc, d, e, dev, seed):
    """f64 K1 arguments on the JAX kernel test's inputs, the output rows cut
    to the first n_loc (K3's rectangle, blam's column block transposed as
    mesh.row_block stores it; n_loc = n is K1)."""
    u, m2, x, blam, _ = _problem(True, b, e, n, d, seed)
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    a, _, dv = tvt._prep_tied(f(u), f(m2), f(x))
    _, g_b, dv_b = tvt._prep_tied(f(u), f(m2), f(x[:n_loc]))
    blk = np.ascontiguousarray(np.swapaxes(blam[:, :n_loc], 1, 2))
    return [t.contiguous() for t in (g_b, dv_b, a,
                                     tvt._aug(a) * dv[..., None], f(blk))]


def _assert_mma_bar(got, args, tag):
    """rw against the plain f64 version: 1e-12 |rw| plus 16 f64 ulps of the
    terms' magnitude sum (phase 3's f64 bar); compare, do not divide (the
    ragged rows are 0 in both)."""
    g, dv, a, aod, blam = args
    want = tvt.rw_tied_reference(g, dv, a, aod, blam)
    mag = tvt.rw_tied_reference(g, dv.abs(), a, aod.abs(), blam.abs())
    err = (got - want).abs()
    bar = 1e-12 * want.abs() + 16 * torch.finfo(torch.float64).eps * mag
    assert bool((err <= bar).all()), (
        f'{tag}: {float((err / bar)[bar > 0].max()):.3f}x the bar')


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 130, 256])
@pytest.mark.parametrize('de', MMA_DE)
def test_cuda_mma_f64_matches_plain_version(de, n):
    """The tensor-core body (forced with body='mma', at its plan, S = S_max
    or 1) at every d and E, ragged N and B across the S
    boundaries: rw within phase 3's f64 bar of the plain version. And the
    trace's own launch (rw_tied, its route) within the same bar, counted
    once in LAUNCHES and LAUNCHES_F64."""
    dev = _cuda()
    d, e = de
    for b in _mma_b(d, e):
        args = _mma_args(b, n, n, d, e, dev, seed=60 + b)
        got, launched = tvt._launch(*args, body='mma')
        torch.cuda.synchronize()
        assert launched
        _assert_mma_bar(got, args, f'mma B={b} N={n} d={d} E={e}')
        before = (tvt.LAUNCHES, tvt.LAUNCHES_F64)
        routed = tvt.rw_tied(*args)
        torch.cuda.synchronize()
        assert (tvt.LAUNCHES, tvt.LAUNCHES_F64) == (before[0] + 1,
                                                    before[1] + 1)
        _assert_mma_bar(routed, args, f'routed B={b} N={n} d={d} E={e}')
        if tvt.rw_tied_body(b, n, n, d, e, torch.float64,
                            tvt.device_sms(dev)) == 'mma':
            assert torch.equal(routed, got)


@pytest.mark.cuda
@pytest.mark.parametrize('n_loc', ['N', 'N/2'])
@pytest.mark.parametrize('de', [(3, 2), (5, 4), (8, 8), (1, 1)])
@pytest.mark.parametrize('b', [7, 256])
def test_cuda_mma_f64_block_matches_plain_version(b, de, n_loc):
    """K3 in the tensor-core body: the shard's Nl = N or N / 2 rows against
    all N = 256 contraction rows, through rw_tied_block (its route),
    counted in LAUNCHES_BLOCK; rw within phase 3's f64 bar."""
    dev = _cuda()
    d, e = de
    n = 256
    args = _mma_args(b, n, n if n_loc == 'N' else n // 2, d, e, dev, seed=70)
    before = tvt.LAUNCHES_BLOCK
    got = tvt.rw_tied_block(*args)
    torch.cuda.synchronize()
    assert tvt.LAUNCHES_BLOCK == before + 1
    _assert_mma_bar(got, args, f'K3 B={b} Nl={n_loc} d={d} E={e}')
    forced, _ = tvt._launch(*args, body='mma')
    _assert_mma_bar(forced, args, f'K3 mma B={b} Nl={n_loc} d={d} E={e}')


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(256, 256, 3, 2), (3584, 256, 3, 2),
                                   (256, 128, 5, 4), (64, 128, 3, 2),
                                   (1, 512, 3, 2), (9, 130, 8, 8)])
def test_cuda_mma_same_inputs_same_bits(shape):
    """Each warp walks the contraction in a fixed order: the same f64
    operands give the same rw to the bit, at S_max and at S = 1."""
    dev = _cuda()
    b, n, d, e = shape
    args = _mma_args(b, n, n, d, e, dev, seed=71)
    first, _ = tvt._launch(*args, body='mma')
    for _ in range(3):
        assert torch.equal(tvt._launch(*args, body='mma')[0], first)


@pytest.mark.cuda
@pytest.mark.parametrize('variant', probe.F64_VARIANTS)
@pytest.mark.parametrize('shape', [(256, 256), (7, 200)])
def test_cuda_probe_f64_variant_matches_plain_version(variant, shape):
    """The probe's f64 variants (the scalar body's stages at T = double and
    the tensor-core body's variants) against their plain f64 versions
    within probe.checks' f64 bar (1e-12 |rw| plus 16 f64 ulps of the terms'
    magnitude sum). One launch, counted."""
    dev = _cuda()
    u, m2, x, blam, _ = _problem(True, shape[0], 2, shape[1], 3, seed=13)
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    args = kernel_args(f(u), f(m2), f(x), f(blam))
    before = probe.LAUNCHES_PROBE
    out = probe.rw_probe(variant, *args)
    torch.cuda.synchronize()
    assert probe.LAUNCHES_PROBE == before + 1
    for label, want, bar in probe.checks(variant, *args):
        ratio = float(((out - want).abs() / bar).max())
        assert ratio <= 1.0, f'{variant} vs {label}: {ratio:.3f}x its bar'


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(256, 256), (3584, 256), (7, 200)])
def test_cuda_probe_f64_full_and_mma_equal_k1_to_the_bit(shape):
    """The probe's f64 `full` is the scalar body at its plan and `mma` the
    tensor-core body at its plan: each equals K1's f64 launch in that body
    to the bit."""
    dev = _cuda()
    u, m2, x, blam, _ = _problem(True, shape[0], 2, shape[1], 3, seed=14)
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    args = kernel_args(f(u), f(m2), f(x), f(blam))
    assert torch.equal(probe.rw_probe('full', *args),
                       tvt._launch(*args, body='scalar')[0])
    assert torch.equal(probe.rw_probe('mma', *args),
                       tvt._launch(*args, body='mma')[0])


@pytest.mark.cuda
def test_cuda_exp_table_within_one_ulp():
    """The table-driven double exp (the mma_texp variant's) within one ulp
    of the CPU's exp over the arguments the traces see (-p / 4 of the
    headline-scale operands reach about -60 .. 10) and past them, its
    special-case branch included."""
    dev = _cuda()
    rng = np.random.default_rng(15)
    x = np.concatenate([rng.uniform(-60, 10, 200_000),
                        rng.uniform(-1e-3, 1e-3, 20_000),
                        rng.uniform(-745, 709, 20_000),
                        [0.0, -0.0, 1e-300, -700.0, 700.0, 709.7, -745.0]])
    got = probe.exp_table(torch.tensor(x, device=dev)).cpu().numpy()
    want = np.exp(x)
    ulp = np.spacing(np.abs(want))
    assert float(np.max(np.abs(got - want) / ulp)) <= 1.0


# ------------------------------------------- the graphed lockstep loop --
def _launches():
    """The kernels' launch counts, the device loops that ran counted first
    (utils/replay_counts.settle)."""
    replay_counts.settle()
    return {'K1': tvt.LAUNCHES, 'K1 f64': tvt.LAUNCHES_F64,
            'K2': tvt.LAUNCHES_UNTIED, 'K3': tvt.LAUNCHES_BLOCK,
            'K4': tvt.LAUNCHES_SYM, 'eigh': eigh_small.LAUNCHES_EIGH}


def _eager_then_graphed(monkeypatch, solve):
    """solve() with the solver's loop forced eager, then as its caller runs
    it (graphed, its program captured anew): [(result, launches counted
    during the call)] x 2."""
    from gpmpc_tpu_torch.mpc import solver
    out = []
    for eager in (True, False):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(solver, '_run_graphed', solver._run_eager)
            else:
                solver.clear_programs()
            before = _launches()
            res = solve()
            torch.cuda.synchronize()
            out.append((res, {k: v - before[k]
                              for k, v in _launches().items()}))
    return out


def _noted_captures(monkeypatch):
    """The kernel launches a replay of each graph the solver captures
    (by its nodes), in a list; the program cache emptied first."""
    from gpmpc_tpu_torch.mpc import solver
    solver.clear_programs()
    graphs = []
    capture = solver._capture

    def noted(record, s, pool=None, **kw):
        graph, counts = capture(record, s, pool, **kw)
        graphs.append(counts.launches)
        return graph, counts

    monkeypatch.setattr(solver, '_capture', noted)
    return graphs


def _swing_up_solve(dev, full_cov=False):
    """One control step of `_swing_up_controller`, the B = 1 route through
    K2 at (1, 512, 3, 2), from the stored episode's second state, with a
    diagonal or a full covariance. Returns (solve, H, kernel)."""
    mpc = _swing_up_controller(dev, full_cov)
    traj = mpc.last_traj.copy()
    state = _closed_loop_ref()['ep_states'][1]

    def solve():
        mpc.last_traj = traj.copy()
        mpc.get_optimal_trajectory(state)
        return mpc.last_result
    return solve, 8, 'K2'


def _closed_loop_ref():
    import os
    return np.load(os.path.join(os.path.dirname(__file__), '..',
                                'gpmpc_tpu_torch', 'data',
                                'closed_loop_ref.npz'))


def _swing_up_controller(dev, full_cov=False):
    """chip_smoke.swing_up_controller: the swing-up controller of phase 7
    (f64, N = 512, delta dynamics) on the stored 250 transitions with
    their trained, untied hyperparameters, bounds +-5."""
    mpc = chip_smoke.swing_up_controller(dev, full_cov)
    assert not mpc.gp.config.tied_lambdas
    return mpc


def _batch_solve(case, dev, iters=40, full_cov=False):
    """The plain solve_batch at the headline (B = 256, f32), on suite
    config 3b (B = 256, M = 128, (d, E) = (5, 4), f32) or on config 4
    ('4': B = 64, H = 50, M = 128, (d, E) = (3, 2), f32), with a diagonal or
    a full covariance. Returns (solve, H, kernel)."""
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem, sparse_problem
    if case == 'headline':
        p = make_headline_problem(b=256, dtype=torch.float32, device=dev)
    else:
        p = sparse_problem({'3b': '3b_sparse_cartpole',
                            '4': '4_sparse_fullcov'}[case],
                           dtype=torch.float32, device=dev)
    cfg = SolverConfig(max_iters=iters, tol=1e-4)
    return (lambda: solve_batch(p.gp, p.state_dim, 1, p.x0s, p.params,
                                p.horizon, p.lb, p.ub, cfg,
                                full_cov=full_cov)), p.horizon, 'K1 f64'


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['headline', 'swing_up', '3b'])
def test_cuda_graphed_solve_equals_eager_to_the_bit(monkeypatch, case):
    """The lockstep loop as replays of one captured CUDA graph against the
    eager loop: u, cost, iters, pg_norm and converged equal to the bit, at
    the headline (K1 f64 at B = 256), the swing-up's B = 1 control step
    (K2 at (1, 512, 3, 2)) and config 3b (K1 at (256, 128, 5, 4)); each
    call launches its kernel exactly H * (1 + iters) times by the counters
    and no other."""
    dev = _cuda()
    solve, h, kernel = (_swing_up_solve(dev) if case == 'swing_up'
                        else _batch_solve(case, dev))
    (res_e, n_e), (res_g, n_g) = _eager_then_graphed(monkeypatch, solve)
    chip_smoke.same_bits(case, res_e, res_g)
    want = h * (1 + int(res_g.iters.max()))
    assert int(res_g.iters.max()) > 1         # the graph was replayed
    for n in (n_e, n_g):
        assert n[kernel] == want
        assert sum(n.values()) == want * (2 if kernel == 'K1 f64' else 1)


@pytest.mark.cuda
def test_cuda_graphed_solve_counts_each_replay(monkeypatch):
    """A graphed solve_batch at the headline, at a cap that ends it before
    convergence (iters = 5), twice: its program's two graphs (step and init)
    hold H K1 f64 launches each by their own kernel nodes and are captured
    once, and the counters count H * (1 + iters) on each call, the captures
    nothing and each replay its graph's H."""
    dev = _cuda()
    solve, h, _ = _batch_solve('headline', dev, iters=5)
    graphs = _noted_captures(monkeypatch)
    for call in range(2):
        replay_counts.settle()
        before = (tvt.LAUNCHES, tvt.LAUNCHES_F64)
        res = solve()
        torch.cuda.synchronize()
        replay_counts.settle()
        assert int(res.iters.max()) == 5
        assert graphs == [{'LAUNCHES': h, 'LAUNCHES_F64': h}] * 2
        assert (tvt.LAUNCHES - before[0], tvt.LAUNCHES_F64 - before[1]) == (
            h * 6, h * 6)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['headline', '4', 'swing_up'])
def test_cuda_graphed_full_cov_solve_equals_eager_to_the_bit(monkeypatch,
                                                             case):
    """Full covariance through the graphed lockstep loop against the eager
    loop: u, cost, iters, pg_norm and converged equal to the bit at the
    headline (K1 f64 at B = 256), config 4 (K1 f64 at (64, 128, 3, 2),
    H = 50, 5 iterations) and the swing-up's B = 1 control step (K2 at
    (1, 512, 3, 2)); each call launches its kernel and the eigensolver
    exactly H * (1 + iters) times each by the counters, and no other."""
    dev = _cuda()
    if case == 'swing_up':
        solve, h, kernel = _swing_up_solve(dev, full_cov=True)
    else:
        solve, h, kernel = _batch_solve(case, dev, full_cov=True,
                                        iters=5 if case == '4' else 40)
    (res_e, n_e), (res_g, n_g) = _eager_then_graphed(monkeypatch, solve)
    chip_smoke.same_bits(f'{case} full_cov', res_e, res_g)
    want = h * (1 + int(res_g.iters.max()))
    assert int(res_g.iters.max()) > 1         # the graph was replayed
    for n in (n_e, n_g):
        assert n[kernel] == want and n['eigh'] == want
        assert sum(n.values()) == want * (3 if kernel == 'K1 f64' else 2)


@pytest.mark.cuda
def test_cuda_forced_capture_of_full_cov_equals_eager(monkeypatch):
    """A capture forced on the full-covariance objective succeeds (its PSD
    clip reads nothing on the host) and equals the eager loop to the bit;
    its program's two graphs hold H K1 f64 and H eigensolver launches a
    replay each."""
    from gpmpc_tpu_torch.dynamics import build_rollout_cache
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.parallel.batch import batch_objective
    from gpmpc_tpu_torch.problems import make_headline_problem
    dev = _cuda()
    p = make_headline_problem(b=8, dtype=torch.float32, device=dev)
    obj = batch_objective(build_rollout_cache(p.gp, 2, 1), p.x0s, p.params,
                          full_cov=True)
    u0 = torch.zeros((8, p.horizon, 1), dtype=torch.float32, device=dev)
    cfg = solver.SolverConfig(max_iters=5, tol=0.0)
    graphs = _noted_captures(monkeypatch)
    res_g = solver.solve_trajectory_batched(obj, u0, p.lb, p.ub, cfg,
                                            _graph=True)
    graphed = solver._run_graphed
    try:
        solver._run_graphed = solver._run_eager
        res_e = solver.solve_trajectory_batched(obj, u0, p.lb, p.ub, cfg,
                                                _graph=True)
    finally:
        solver._run_graphed = graphed
    torch.cuda.synchronize()
    chip_smoke.same_bits('forced full_cov capture', res_e, res_g)
    assert graphs == [{'LAUNCHES': p.horizon, 'LAUNCHES_F64': p.horizon,
                       'LAUNCHES_EIGH': p.horizon}] * 2


@pytest.mark.cuda
def test_cuda_graphed_full_cov_counts_each_replay(monkeypatch):
    """A graphed solve_batch(full_cov=True) at the headline, cut at 5
    iterations, twice: its program's two graphs hold H K1 f64 and H
    eigensolver launches each by their own kernel nodes and are captured
    once, and LAUNCHES_EIGH counts H * (1 + iters) on each call, the
    captures nothing and each replay its graph's H."""
    dev = _cuda()
    solve, h, _ = _batch_solve('headline', dev, iters=5, full_cov=True)
    graphs = _noted_captures(monkeypatch)
    for call in range(2):
        replay_counts.settle()
        before = eigh_small.LAUNCHES_EIGH
        res = solve()
        torch.cuda.synchronize()
        replay_counts.settle()
        assert int(res.iters.max()) == 5
        assert graphs == [{'LAUNCHES': h, 'LAUNCHES_F64': h,
                           'LAUNCHES_EIGH': h}] * 2
        assert eigh_small.LAUNCHES_EIGH - before == h * 6


# ------------------------------------------------ kept solve programs --
def _three_modes(solve, calls):
    """Each of `calls` (zero-arg callables run in order, each a list of
    solves) under the three executions of the solver's loop: 'reused' (the
    program cache kept across all of them), 'fresh' (emptied before each
    solve) and 'eager' (the loop swapped for the eager one); returns
    {mode: [results]} and the captures 'reused' took."""
    from gpmpc_tpu_torch.mpc import solver
    out, captured = {}, {}
    for mode in ('reused', 'fresh', 'eager'):
        solver.clear_programs()
        graphs = []
        capture, graphed = solver._capture, solver._run_graphed

        def noted(record, s, pool=None, **kw):
            graph, counts = capture(record, s, pool, **kw)
            graphs.append(counts.launches)
            return graph, counts

        solver._capture = noted
        if mode == 'eager':
            solver._run_graphed = solver._run_eager
        try:
            out[mode] = [solve(call, fresh=mode == 'fresh') for call in calls]
        finally:
            solver._capture, solver._run_graphed = capture, graphed
        torch.cuda.synchronize()
        captured[mode] = graphs
    assert not captured['eager']
    return out, captured


def _fresh_solve(fn, fresh):
    from gpmpc_tpu_torch.mpc import solver
    if fresh:
        solver.clear_programs()
    return fn()


@pytest.mark.cuda
@pytest.mark.parametrize('full_cov', [False, True])
def test_cuda_reused_program_equals_fresh_and_eager(full_cov):
    """The headline solve_batch (B = 256, f32, K1 f64; 40 iterations, 5 with
    a full covariance) on three batches of x0s: reused, fresh-capture and
    eager equal to the bit on each; the reused program is captured once
    (a step and an init graph, H K1 f64 launches a replay each, and H
    eigensolver launches with a full covariance) for all three calls."""
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch
    from gpmpc_tpu_torch.problems import make_headline_problem
    dev = _cuda()
    p = make_headline_problem(b=256, dtype=torch.float32, device=dev)
    cfg = SolverConfig(max_iters=5 if full_cov else 40, tol=1e-4)
    rng = np.random.default_rng(7)
    batches = [torch.tensor(rng.uniform(-1, 1, (256, 2)), dtype=torch.float32,
                            device=dev) for _ in range(3)]

    def solve(x0s, fresh):
        return _fresh_solve(lambda: solve_batch(
            p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub, cfg,
            full_cov=full_cov), fresh)

    out, captured = _three_modes(solve, batches)
    for k in range(3):
        for mode in ('fresh', 'eager'):
            chip_smoke.same_bits(f'batch {k} {mode}', out['reused'][k],
                                 out[mode][k])
    h = p.horizon
    each = {'LAUNCHES': h, 'LAUNCHES_F64': h,
            **({'LAUNCHES_EIGH': h} if full_cov else {})}
    assert captured['reused'] == [each] * 2
    assert captured['fresh'] == [each] * 6


@pytest.mark.cuda
def test_cuda_reused_recipe_equals_fresh_and_eager():
    """One call of the production recipe (solve_batch_multistart_retired
    with problems.RECIPE and REFINE, at B = 64), then a second on other
    x0s: reused, fresh-capture and eager equal to the bit on both; in
    'reused' every key is captured once over the two calls (a step and an
    init graph a program), the second call capturing nothing."""
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch_multistart_retired
    from gpmpc_tpu_torch.problems import (RECIPE, REFINE,
                                          make_headline_problem)
    dev = _cuda()
    p = make_headline_problem(b=64, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(8)
    batches = [p.x0s, torch.tensor(rng.uniform(-1, 1, (64, 2)),
                                   dtype=torch.float32, device=dev)]
    seen = []

    def solve(x0s, fresh):
        from gpmpc_tpu_torch.mpc import solver
        res = solve_batch_multistart_retired(
            p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub,
            SolverConfig(**REFINE), **RECIPE)
        seen.append(len(solver._PROGRAMS))
        return res

    out, captured = _three_modes(solve, batches)
    for k in range(2):
        for mode in ('fresh', 'eager'):
            chip_smoke.same_bits(f'recipe call {k} {mode}', out['reused'][k],
                                 out[mode][k])
    programs = seen[1]
    assert seen[0] == programs > 1
    assert len(captured['reused']) == 2 * programs


@pytest.mark.cuda
@pytest.mark.parametrize('full_cov', [False, True])
def test_cuda_swing_up_sequence_reuses_one_program(full_cov):
    """Five swing-up control steps (the controller of chip_smoke's phase
    7b, f64, N = 512, the B = 1 route through K2, the pendulum stepped and
    each transition appended between steps): reused, fresh-capture and
    eager give the same actions, states, costs and iterations to the bit;
    in 'reused' the one key is captured once for all five steps (its step
    and init graphs H K2 launches a replay each, and H eigensolver
    launches with a full covariance)."""
    from gpmpc_tpu_torch.envs.pendulum import PendulumEnv, PendulumParams
    from gpmpc_tpu_torch.sim.simulator import Simulator
    dev = _cuda()
    params = PendulumParams(g=10.0, max_torque=5.0)
    logs = {}

    def episode(_, fresh):
        mpc = _swing_up_controller(dev, full_cov)
        if fresh:
            orig = mpc.get_optimal_trajectory
            mpc.get_optimal_trajectory = lambda x: _fresh_solve(
                lambda: orig(x), True)
        env = PendulumEnv(params=params, device=dev,
                          init_state={'th_init': 1.0, 'thdot_init': 0.5})
        return Simulator(mpc, env, num_iters=5).run()

    out, captured = _three_modes(episode, [None])
    ref = out['reused'][0]
    for mode in ('fresh', 'eager'):
        got = out[mode][0]
        for name in ('actions', 'states', 'costs', 'iters'):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(ref, name), err_msg=mode)
    each = {'LAUNCHES_UNTIED': 8, **({'LAUNCHES_EIGH': 8} if full_cov
                                     else {})}
    assert captured['reused'] == [each] * 2
    assert captured['fresh'] == [each] * 10


@pytest.mark.cuda
@pytest.mark.parametrize('full_cov', [False, True])
def test_cuda_single_route_capture_equals_eager(full_cov):
    """The audit of run_episode_on_device's single-scenario route: its
    L-BFGS solves run the kept program (a capture of the single-scenario
    rollout, which must read nothing on the host) and equal the eager loop
    to the bit over a 4-step episode (chip_smoke phase 7e's settings);
    one key, captured once (no kernel in its graphs with a diagonal
    covariance, H eigensolver launches a replay each with a full one)."""
    from gpmpc_tpu_torch.envs import pendulum
    from gpmpc_tpu_torch.gp import state as gp_state
    from gpmpc_tpu_torch.mpc.cost import CostParams
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.sim.simulator import run_episode_on_device
    dev = _cuda()
    pp = pendulum.PendulumParams(max_torque=3.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s, a, ns = pendulum.sample_transitions(gen, 20, pp, dtype=torch.float64,
                                           device=dev)
    gp = gp_state.make_gp(
        gp_state.GPConfig(capacity=32, x_dim=3, out_dim=2),
        torch.cat([s, a], 1).cpu().numpy(), (ns - s).cpu().numpy(),
        log_lambdas=np.log(np.full((2, 3), 3.0)),
        log_sigma_n=np.log(np.full(2, 0.05)), dtype=torch.float64,
        device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    cp = CostParams(Q=2 * torch.eye(2, **f64), R=0.1 * torch.eye(1, **f64),
                    gamma=torch.tensor(0.0, **f64),
                    x_ref=torch.zeros(2, **f64), u_ref=torch.zeros(1, **f64))

    def episode(_, fresh):
        return run_episode_on_device(
            gp, lambda st, u: pendulum.step(st, u, pp),
            torch.tensor([0.5, 0.0], **f64), cp, horizon=3, num_steps=4,
            lb=-3.0, ub=3.0, solver=SolverConfig(max_iters=25),
            delta_dynamics=True, full_cov=full_cov)[1]

    out, captured = _three_modes(episode, [None])
    for mode in ('fresh', 'eager'):
        for name, v in out['reused'][0].items():
            chip_smoke.same_bits(f'episode {name} {mode}',
                                 _Bits(v), _Bits(out[mode][0][name]))
    each = {'LAUNCHES_EIGH': 3} if full_cov else {}
    assert captured['reused'] == [each] * 2


@pytest.mark.cuda
@pytest.mark.parametrize('route', ['vmap', 'adam', 'gp_draws',
                                   'vmap_full_cov'])
def test_cuda_lanes_route_reused_equals_fresh_and_eager(route):
    """The per-scenario routes as one lockstep solve of all lanes
    (dynamics.rollout_lanes; f32, 16 headline lanes): impl='vmap' by L-BFGS
    with a diagonal and a full covariance, projected Adam and
    solve_batch_gp over 16 GP draws, on two batches of x0s: reused,
    fresh-capture and eager equal to the bit; 'reused' captures its
    program once (a step and an init graph, and Adam's polish step) for both
    calls, no kernel in its graphs but the eigensolver's H launches (at
    (16, 2, 2), through its vmap rule) with a full covariance."""
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import (solve_batch, solve_batch_gp,
                                                stack_gps)
    from gpmpc_tpu_torch.problems import make_headline_problem
    dev = _cuda()
    b = 16
    p = make_headline_problem(b=b, dtype=torch.float32, device=dev)
    gps = (stack_gps([make_headline_problem(b=1, seed=s, dtype=torch.float32,
                                            device=dev).gp for s in range(b)])
           if route == 'gp_draws' else None)
    cfg = (SolverConfig(method='adam', max_iters=20, tol=1e-4,
                        learning_rate=0.05, polish_iters=3)
           if route == 'adam' else SolverConfig(max_iters=20, tol=1e-4))
    rng = np.random.default_rng(9)
    batches = [p.x0s, torch.tensor(rng.uniform(-1, 1, (b, 2)),
                                   dtype=torch.float32, device=dev)]

    def solve(x0s, fresh):
        if route == 'gp_draws':
            return _fresh_solve(lambda: solve_batch_gp(
                gps, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub, cfg), fresh)
        return _fresh_solve(lambda: solve_batch(
            p.gp, 2, 1, x0s, p.params, p.horizon, p.lb, p.ub, cfg,
            full_cov=route == 'vmap_full_cov', impl='vmap'), fresh)

    out, captured = _three_modes(solve, batches)
    for k in range(2):
        for mode in ('fresh', 'eager'):
            chip_smoke.same_bits(f'{route} batch {k} {mode}',
                                 out['reused'][k], out[mode][k])
        assert bool(torch.isfinite(out['reused'][k].cost).all())
    each = ({'LAUNCHES_EIGH': p.horizon} if route == 'vmap_full_cov'
            else {})
    graphs = 3 if route == 'adam' else 2
    assert captured['reused'] == [each] * graphs
    assert captured['fresh'] == [each] * (2 * graphs)


@pytest.mark.cuda
def test_cuda_capture_after_the_cache_fills():
    """A program's capture (mpc/solver.py `_Program._capture`) of code that
    allocates 2 GiB, on a side stream as the solver captures, while the
    allocator's cache holds all of the card's free memory but 1 GiB in
    blocks of the default stream (as earlier work leaves it): a capture
    cannot free cached blocks, so the solver frees them before it
    captures. The capture succeeds, the pool's growth is counted, and a
    replay computes what the code does."""
    from gpmpc_tpu_torch.mpc import solver
    dev = _cuda()
    need, blk = 2 ** 31, 2 ** 28
    s = (torch.zeros(1, device=dev),)

    def record(st, n=need // 4):
        st[0].copy_(torch.full((n,), 2.0, device=dev)[-1:])

    prog = types.SimpleNamespace(pool=torch.cuda.graph_pool_handle(),
                                 pool_bytes=0)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        record(s, 1024)                    # the warm-up, small
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    blocks = [torch.empty(blk, dtype=torch.uint8, device=dev)
              for _ in range(max(free - need // 2, 0) // blk)]
    del blocks
    assert torch.cuda.mem_get_info(dev)[0] < need // 2 + blk
    with torch.cuda.stream(side):
        graph, _ = solver._Program._capture(prog, record, s, dev)
    s[0].zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert float(s[0]) == 2.0
    assert prog.pool_bytes >= need
    graph.reset()


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['shared', 'shared_full_cov', 'gp_draws'])
def test_cuda_lanes_equal_rollout_lane_by_lane(kind):
    """On the card, in f64: lane b of dynamics.rollout_lanes (a shared
    cache with a diagonal or a full covariance, or one GP draw a lane)
    equals rollout of lane b alone, means and covariances, at rtol 1e-12
    of each one's scale (the covariances of sigma_f^2), the bar of the
    CPU test in test_torch_lanes.py."""
    from gpmpc_tpu_torch.dynamics import build_rollout_cache, rollout
    from gpmpc_tpu_torch.dynamics import rollout_lanes
    from gpmpc_tpu_torch.parallel.batch import stack_gps
    from gpmpc_tpu_torch.problems import make_headline_problem
    dev = _cuda()
    b, h = 8, 6
    f64 = dict(dtype=torch.float64, device=dev)
    p = make_headline_problem(b=b, horizon=h, **f64)
    gps = ([make_headline_problem(b=1, seed=s, **f64).gp for s in range(b)]
           if kind == 'gp_draws' else [p.gp] * b)
    cache = build_rollout_cache(stack_gps(gps) if kind == 'gp_draws'
                                else p.gp, 2, 1)
    u = torch.tensor(np.random.default_rng(3).uniform(-1, 1, (b, h, 1)),
                     **f64)
    full_cov = kind == 'shared_full_cov'
    means, covs = rollout_lanes(cache, p.x0s, u, full_cov=full_cov)
    for i in range(b):
        ci = build_rollout_cache(gps[i], 2, 1)
        mi, vi = rollout(ci, p.x0s[i], u[i], full_cov=full_cov)
        sf2 = float(torch.exp(2.0 * ci.log_sigma_f).max())
        for name, got, want, scale in (
                ('means', means[i], mi, float(mi.abs().max())),
                ('covs', covs[i], vi, max(float(vi.abs().max()), sf2))):
            np.testing.assert_allclose(
                got.cpu().numpy(), want.cpu().numpy(), rtol=1e-12,
                atol=1e-12 * scale, err_msg=f'lane {i} {name}')


@pytest.mark.cuda
@pytest.mark.parametrize('method', ['lbfgs', 'adam'])
def test_cuda_route_c_nominal_model_forced_capture(method):
    """The controller's route (c) on a GP with the pendulum's nominal
    model (models/pendulum.py, its Jacobian by torch.func.jacrev inside the
    lanes map): three control steps with appends between them, reused,
    fresh-capture and eager equal to the bit; 'reused' captures its one
    program once."""
    from gpmpc_tpu_torch.gp import state as gp_state
    from gpmpc_tpu_torch.models import pendulum
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    dev = _cuda()
    cfg = (SolverConfig(method='adam', max_iters=20, tol=1e-4,
                        learning_rate=0.05, polish_iters=3)
           if method == 'adam' else SolverConfig(max_iters=30, tol=1e-6))
    rng = np.random.default_rng(2)
    s, a = rng.uniform(-1, 1, (40, 2)), rng.uniform(-2, 2, (40, 1))
    xs = np.concatenate([s, a], 1)
    nxt = pendulum.nominal_residual_fn(torch.tensor(xs)).numpy() + 0.05 * s

    def episode(_, fresh):
        mpc = RiskSensitiveMPC(gamma=0.2, horizon=5, state_dim=2,
                               input_dim=1, Q=np.eye(2), R=0.1 * np.eye(1),
                               capacity=64, dtype=torch.float64, solver=cfg,
                               device=dev)
        mpc.gp = gp_state.make_gp(gp_state.GPConfig(
            capacity=64, x_dim=3, out_dim=2,
            nominal_fn=pendulum.nominal_residual_fn), dtype=torch.float64,
            device=dev)
        mpc.set_ub([2.0])
        mpc.set_lb([-2.0])
        mpc.dynamics.append_train_data(s, a, nxt)
        x, us = np.array([0.5, -0.3]), []
        for _ in range(3):
            u = _fresh_solve(lambda: mpc.get_optimal_trajectory(x), fresh)
            us.append(u)
            x_next = x + 0.1 * np.array([x[1], u[0, 0]])
            mpc.dynamics.append_train_data(x, u[0], x_next)
            x = x_next
        return np.stack(us)

    out, captured = _three_modes(episode, [None])
    for mode in ('fresh', 'eager'):
        np.testing.assert_array_equal(out[mode][0], out['reused'][0],
                                      err_msg=mode)
    assert captured['reused'] == [{}] * (3 if method == 'adam' else 2)


class _Bits:
    """One tensor as chip_smoke.same_bits reads a SolveResult."""
    def __init__(self, t):
        self.u = self.cost = self.iters = self.pg_norm = self.converged = t


# ------------------------------------------------ the small eigensolver --
@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('d', [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize('kind', ['definite', 'indefinite',
                                  'near-degenerate', 'diagonal'])
def test_cuda_eigh_small_matches_plain_version(kind, d, dtype):
    """The eigensolver kernel against its plain version on the card and
    torch.linalg.eigh: kernel and plain version within 4 ulps of ||A||_F
    (the same IEEE operations in the same order: equal to the bit but for
    the library's own rounding); eigenvalues within 16 d eps ||A||_F of
    torch.linalg.eigh's; ||V diag(w) V^T - A|| within 16 d eps ||A||_F and
    ||V^T V - I|| within 16 d eps, eps the dtype's."""
    dev = _cuda()
    a = torch.tensor(chip_smoke.sym_inputs(kind, 300, d, dtype, seed=d), device=dev)
    w, v = eigh_small.eigh(a)
    wp, vp = eigh_small.eigh_reference(a)
    torch.cuda.synchronize()
    chip_smoke.check_eigh(f'{kind} d={d}', a, w, v, wp, vp)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', chip_smoke.EIGH_PATH_SHAPES)
def test_cuda_eigh_small_at_path_shapes(shape):
    """The kernel at the shapes the paths launch it at, on the covariance
    matrices of the f64 headline full-covariance rollout (and random
    definite ones beside them), at the bars of the test above."""
    dev = _cuda()
    for dtype in (torch.float32, torch.float64):
        a = torch.tensor(chip_smoke.sym_inputs('definite', shape[0], shape[1], dtype,
                                     seed=shape[0]), device=dev)
        w, v = eigh_small.eigh(a)
        wp, vp = eigh_small.eigh_reference(a)
        chip_smoke.check_eigh(f'{shape} {dtype}', a, w, v, wp, vp)


@pytest.mark.cuda
def test_cuda_eigh_small_gradient_matches_plain():
    """The eigensolver's backward on the card against the same backward on
    the CPU on the same inputs (rtol 1e-10, f64), through the PSD clip."""
    from gpmpc_tpu_torch.dynamics import _psd_clip
    dev = _cuda()
    a = torch.tensor(chip_smoke.sym_inputs('indefinite', 64, 2, torch.float64, 3))
    g = torch.tensor(np.random.default_rng(4).normal(size=(64, 2, 2)))
    out = []
    for where in ('cpu', dev):
        x = a.to(where).requires_grad_()
        (ga,) = torch.autograd.grad((_psd_clip(x) * g.to(where)).sum(), x)
        out.append(ga.cpu())
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.cuda
def test_cuda_eigh_small_refuses_what_it_cannot_take():
    """d = 9 raises ValueError; so do a non-square and a non-contiguous
    operand at the launch, and an integer dtype TypeError."""
    dev = _cuda()
    with pytest.raises(ValueError, match='d <= 8'):
        eigh_small.eigh(torch.eye(9, device=dev))
    with pytest.raises(ValueError):
        eigh_small.launch(torch.zeros((3, 2, 3), device=dev))
    with pytest.raises(ValueError):
        eigh_small.launch(torch.zeros((4, 4), device=dev).t()[:2, :2])
    with pytest.raises(TypeError):
        eigh_small.launch(torch.zeros((2, 2), dtype=torch.int32, device=dev))


# ------------------------------------------- the solver's loop on the card --
@pytest.mark.cuda
def test_cuda_loop_form_is_the_device_loop():
    """This card's CUDA runtime and driver have conditional WHILE nodes, so
    kept programs run their loop on the device (solver.loop_form())."""
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.ops.kernels import loop_cond
    _cuda()
    assert min(loop_cond.versions()) >= loop_cond.MIN_CUDA
    assert solver.loop_form() == 'while'


@pytest.mark.cuda
def test_cuda_loop_cond_matches_plain_version():
    """The condition kernel's plain launch equals its plain version
    (t < max_iters and a lane not done) at 1 to 3,584 lanes, every done
    pattern and t around the cap."""
    dev = _cuda()
    err, cases = chip_smoke.check_loop_cond_kernel(dev,
                                                   chip_smoke.LOOP_COND_LANES)
    assert err == 0 and cases > 0


@pytest.mark.cuda
@pytest.mark.parametrize('case', chip_smoke.LOOP_GRAPH_CASES)
def test_cuda_loop_graph_equals_host_read_loop(case):
    """The loop graph over a captured counting body against the host-read
    loop on the same graph: t and done equal, with 0 passes (every lane
    done, t at the cap), the cap, one live lane and spread stops."""
    dev = _cuda()
    r = chip_smoke.check_loop_graph(dev, *case)
    b, t0, cap, kind = case
    if kind == 'all done' or t0 >= cap:
        assert r['passes'] == 0
    if kind == 'cap':
        assert r['passes'] == cap - t0


@pytest.mark.cuda
def test_cuda_loop_graph_refuses_what_it_cannot_take():
    """A loop graph takes a CUDA int64 scalar t and a contiguous bool done,
    and captures on a side stream; on the CPU go_on takes its plain
    version."""
    from gpmpc_tpu_torch.ops.kernels import loop_cond
    dev = _cuda()
    t = torch.zeros((), dtype=torch.long, device=dev)
    done = torch.zeros(4, dtype=torch.bool, device=dev)
    pool = torch.cuda.graph_pool_handle()
    with pytest.raises(ValueError):
        loop_cond.DeviceLoop(lambda: None, t.int(), done, 5, pool)
    with pytest.raises(ValueError):
        loop_cond.DeviceLoop(lambda: None, t, done.view(2, 2).t(), 5, pool)
    with pytest.raises(ValueError, match='side stream'):
        loop_cond.DeviceLoop(lambda: None, t, done, 5, pool)
    assert bool(loop_cond.go_on(t.cpu(), done.cpu(), 5))


@pytest.fixture(scope='module')
def loop_routes():
    return chip_smoke.device_loop_routes(_cuda())


@pytest.mark.cuda
@pytest.mark.parametrize('route', chip_smoke.DEVICE_LOOP_ROUTES)
def test_cuda_device_loop_equals_host_read_loop(loop_routes, route):
    """Each kept route's loop on the device against its host-read loop
    (chip_smoke.check_device_loop): a miss on the device loop, a miss on
    the host-read loop and a hit on the device loop equal to the bit in u,
    cost, iters, pg_norm and converged; the hit captures nothing and syncs
    nothing with the host (set_sync_debug_mode('error')); the device loop
    makes 0 host reads in the solver's loop, the host-read loop at least
    one. The headline at tol 1e9 runs its miss's loop for 0 passes; at a
    cap of 5 it stops at the cap."""
    dev = torch.device('cuda')
    r = chip_smoke.check_device_loop(route, loop_routes[route], dev)
    if route == 'headline, 0 passes':
        assert r['iters'] == 1
        # The miss: the condition kernel once, before a loop of 0 passes.
        assert r['cond_launches']['device miss'] == 1
    if route == 'headline, cap 5':
        assert r['iters'] == 5
        assert r['cond_launches']['device hit'] == 1 + 5
        # A miss runs iteration 1 eagerly, then reads at t = 1..4.
        assert r['host_reads']['host miss'] == 4
    assert r['guarded_runs'] >= 1


def _small_kept_solve(dev, cfg):
    """A kept solve of 4 lanes of a smooth objective (H = 5, da = 2) on the
    card: solve(u0) -> SolveResult."""
    from gpmpc_tpu_torch.mpc import solver
    rng = np.random.default_rng(16)
    tg = torch.tensor(rng.uniform(-1.5, 1.5, (4, 5, 2)), device=dev)

    def build(tg):
        return lambda u: ((u - tg) ** 2
                          + 0.3 * torch.sin(3.0 * u) * u.flip(-1)).sum((1, 2))

    obj = solver.Objective(('small kept solve',), (tg,), build)
    return lambda u0: solver.solve_trajectory_batched(obj, u0, -1.0, 1.0, cfg)


@pytest.mark.cuda
def test_cuda_sync_guard_fails_a_host_read_in_a_hit(monkeypatch):
    """no_host_sync, which chip_smoke's device-loop gates run hits under,
    raises where a kept program's call reads the host: the guard itself
    (check_sync_guard), and a hit whose loop is made to read all(done)."""
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    dev = _cuda()
    chip_smoke.check_sync_guard(dev)
    solver.clear_programs()
    solve = _small_kept_solve(dev, SolverConfig(max_iters=20, tol=1e-6))
    u0 = torch.zeros((4, 5, 2), dtype=torch.float64, device=dev)
    solve(u0)
    with chip_smoke.no_host_sync() as guard:
        solve(u0)
    assert guard['runs'] == 1
    loop = solver._Program._loop

    def reads(prog, s, t):
        loop(prog, s, t)
        bool(s.done.all())

    monkeypatch.setattr(solver._Program, '_loop', reads)
    with pytest.raises(RuntimeError), chip_smoke.no_host_sync():
        solve(u0)
    torch.cuda.synchronize()
    solver.clear_programs()


@pytest.mark.cuda
def test_cuda_device_loop_counts_stay_bounded():
    """10,000 hits of a kept solve on the device loop, no counter read
    between them: the program is watched once and keeps one device sum of
    its passes (no per-call state: the allocator holds what it held after
    the first hits); settle() then counts every pass once, in the step's
    replays and the condition kernel's launches."""
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.ops.kernels import loop_cond
    from gpmpc_tpu_torch.utils import replay_counts
    dev = _cuda()
    solver.clear_programs()
    solve = _small_kept_solve(dev, SolverConfig(max_iters=20, tol=1e-6))
    u0 = torch.zeros((4, 5, 2), dtype=torch.float64, device=dev)
    solve(u0)
    torch.cuda.synchronize()
    (prog,) = solver._PROGRAMS.values()
    replay_counts.settle()
    cond0 = loop_cond.LAUNCHES_COND
    steps0 = replay_counts.replays_run()[prog.step_counts]
    iters = torch.zeros((), dtype=torch.long, device=dev)
    calls = 10_000
    for call in range(calls):
        iters += solve(u0).iters.max()
        if call == 100:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) <= held
    assert list(replay_counts._LOOPS).count(prog) == 1
    assert prog.launched == calls
    # A hit's loop runs from t = 0: its passes are its iterations.
    passes = int(iters)
    replay_counts.settle()
    assert prog.launched == 0
    assert loop_cond.LAUNCHES_COND - cond0 == calls + passes
    assert replay_counts.replays_run()[prog.step_counts] - steps0 == passes
    solver.clear_programs()


# The batched episode's two shapes (chip_smoke.GROUPED_SHAPES) and small
# ones: groups of five, one, three and nine (two blocks a group), and E = 7,
# where an f64 slab's two staged chunks do not fit (one is kept).
_GROUPED_SHAPES = [(10, 130, 3, 2, 5), (6, 64, 3, 2, 1), (12, 200, 5, 4, 3),
                   (18, 100, 3, 2, 9), (6, 100, 3, 7, 2),
                   (1280, 512, 3, 2, 5), (256, 512, 3, 2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize('slab', ['f32', 'f64'])
@pytest.mark.parametrize('body', ['scalar', 'mma'])
@pytest.mark.parametrize('shape', _GROUPED_SHAPES)
def test_cuda_grouped_k1_matches_plain_version(shape, body, slab):
    """K1's grouped form (one blam slab a group of scenarios, at f32 or f64)
    in each body against the plain version of that body's order and
    against the former grouped launch on the widened slab, chip_smoke's bar
    (1e-12 |rw| + 16 ulps of the terms' magnitude); one counted launch a
    call."""
    dev = _cuda()
    b, n, d, e, k = shape
    args, _ = chip_smoke.grouped_args(np.random.default_rng(3), b, n, d, e,
                                      k, dev, slab)
    chip_smoke.check_grouped(f'grouped {shape}', args, body, dev)
    before = tvt.LAUNCHES_GROUPED
    tvt.rw_tied(*args)
    torch.cuda.synchronize()
    assert tvt.LAUNCHES_GROUPED == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize('slab', ['f32', 'f64'])
@pytest.mark.parametrize('body', ['scalar', 'mma'])
@pytest.mark.parametrize('shape', [(20, 128, 3, 2, 5), (1280, 512, 3, 2, 5),
                                   (256, 512, 3, 2, 1)])
def test_cuda_grouped_k1_is_k1_on_each_group(shape, body, slab):
    """A grouped launch equals, to the bit, K1's ungrouped launch (unsplit)
    on each group alone with that group's slab widened to f64 (the
    scenarios' order of accumulation does not depend on the grouping), in
    each body, the slab at f32 and at f64, at the episode's shapes."""
    dev = _cuda()
    b, n, d, e, k = shape
    args, _ = chip_smoke.grouped_args(np.random.default_rng(4), b, n, d, e,
                                      k, dev, slab)
    got, _ = tvt._launch(*args, body=body)
    assert torch.equal(got, chip_smoke.per_group_launch(args, body))


@pytest.mark.cuda
def test_cuda_grouped_k1_refuses_a_wider_slab():
    """A grouped launch takes an f64 slab only under f64 operands: f32
    operands with an f64 slab raise rather than narrow."""
    dev = _cuda()
    args, _ = chip_smoke.grouped_args(np.random.default_rng(5), 10, 64, 3,
                                      2, 5, dev)
    with pytest.raises(TypeError):
        tvt._launch(*(t.float() for t in args[:4]), args[4])


@pytest.mark.cuda
def test_cuda_jitter_search_equals_host_read_search():
    """The fit's jitter search as a kept loop graph against its host-read
    form: jitters and fits equal to the bit at 0, 1, 3, 5 escalations and
    one that runs out (chip_smoke phase 9b)."""
    dev = _cuda()
    res = chip_smoke.check_jitter_search(dev)
    assert res['escalations'] == [0, 1, 3, 5, 8] and res['device_reads'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('recipe', ['multistart', 'single'])
def test_cuda_batched_episode_capture_equals_eager(recipe):
    """A small batched episode (six lanes, capacity 64): the step capture
    against the eager step loop, equal to the bit over three steps; the
    captured run's steps after the first under
    set_sync_debug_mode('error') with no host read."""
    from gpmpc_tpu_torch.envs import pendulum
    from gpmpc_tpu_torch.gp import state as gp_state
    from gpmpc_tpu_torch.mpc.cost import CostParams
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.sim import simulator
    dev = _cuda()
    p = pendulum.PendulumParams(max_torque=3.0)
    rng = np.random.default_rng(2)
    s = np.stack([rng.uniform(0, np.pi, 40), rng.uniform(-8, 8, 40)], 1)
    a = rng.uniform(-3, 3, (40, 1))
    ns = pendulum.step_batch(torch.tensor(s), torch.tensor(a), p)[0].numpy()
    f32 = dict(dtype=torch.float32, device=dev)
    gp = gp_state.make_gp(gp_state.GPConfig(capacity=64, x_dim=3, out_dim=2),
                          np.concatenate([s, a], 1), ns - s,
                          log_lambdas=np.log(np.full((2, 3), 3.0)),
                          log_sigma_n=np.log(np.full(2, 0.05)), **f32)
    cp = CostParams(Q=2 * torch.eye(2, **f32), R=0.1 * torch.eye(1, **f32),
                    gamma=torch.tensor(0.0, **f32), x_ref=torch.zeros(2, **f32),
                    u_ref=torch.zeros(1, **f32))
    x0s = torch.tensor(rng.uniform(-0.5, 0.5, (6, 2)), **f32)

    def run(guard):
        return simulator.run_episode_on_device(
            gp, lambda st, u: pendulum.step(st, u, p), x0s, cp, horizon=4,
            num_steps=3, lb=-3.0, ub=3.0, solver=SolverConfig(max_iters=20),
            delta_dynamics=True, solver_recipe=recipe,
            sync_guard=chip_smoke.sync_error if guard else None)

    ga, oa = run(True)
    assert simulator.LAST_EPISODE['host_reads_after_first'] == 0
    with simulator.eager_steps():
        gb, ob = run(False)
    for k in oa:
        assert torch.equal(oa[k], ob[k]), k
    for k in ('x', 'count', 'kinv', 'beta', 'jitter_used'):
        assert torch.equal(getattr(ga, k), getattr(gb, k)), k
    assert torch.equal(ga.count.cpu(), torch.full((6,), 43, dtype=torch.int32))


# ------------------------------------ the model-sharded solve, kept (NCCL) --
@pytest.mark.cuda
def test_cuda_graph_node_types_follow_the_driver_enum():
    """utils/replay_counts names a node by cuda.h's CUgraphNodeType: a
    graph of an empty node and a child graph (itself one empty node) reads
    {'empty': 2, 'graph': 1}."""
    import ctypes
    _cuda()
    torch.zeros(1, device='cuda')
    cu = replay_counts._cu()
    vp = ctypes.c_void_p
    graph, child, node = vp(), vp(), vp()
    assert cu.cuGraphCreate(ctypes.byref(graph), 0) == 0
    assert cu.cuGraphCreate(ctypes.byref(child), 0) == 0
    try:
        assert cu.cuGraphAddEmptyNode(ctypes.byref(node), child, None, 0) == 0
        assert cu.cuGraphAddEmptyNode(ctypes.byref(node), graph, None, 0) == 0
        assert cu.cuGraphAddChildGraphNode(ctypes.byref(node), graph, None, 0,
                                           child) == 0
        assert replay_counts.graph_node_types(graph.value) == {
            'empty': 2, 'graph': 1}
        assert replay_counts.graph_kernel_names(graph.value) == []
    finally:
        cu.cuGraphDestroy(graph)
        cu.cuGraphDestroy(child)


@pytest.fixture(scope='module')
def nccl_mesh():
    """A (1, 1) mesh over an NCCL group of this process alone, left by
    destroy_group (which releases its programs first)."""
    from gpmpc_tpu_torch.parallel.distributed import (destroy_group,
                                                      free_port, initialize)
    from gpmpc_tpu_torch.parallel.mesh import make_mesh
    dev = _cuda()
    initialize(f'tcp://localhost:{free_port()}', world_size=1, rank=0,
               device=dev, timeout_s=120.0)
    try:
        yield make_mesh(1, 1, device=dev)
    finally:
        destroy_group()


def _sharded_solve(mesh, b=256, iters=10):
    """solve_batch_2d of the headline (f32, K3 f64) on `mesh`: (solve(),
    H)."""
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.model_sharded import solve_batch_2d
    from gpmpc_tpu_torch.problems import make_headline_problem
    p = make_headline_problem(b=b, dtype=torch.float32, device='cuda')
    cfg = SolverConfig(max_iters=iters, tol=1e-4)
    return (lambda: solve_batch_2d(mesh, p.gp, 2, 1, p.x0s, p.params,
                                   p.horizon, p.lb, p.ub, cfg)), p.horizon


@pytest.mark.cuda
def test_cuda_nccl_all_reduce_runs_in_a_loop_body(nccl_mesh):
    """One NCCL collective of each of chip_smoke.COLLECTIVES captured by
    torch and into a device loop's body (chip_smoke.collective_graphs):
    each loop runs its two passes and leaves the collective's values."""
    from gpmpc_tpu_torch.parallel.mesh import MODEL_AXIS
    r = chip_smoke.collective_graphs(nccl_mesh.get_group(MODEL_AXIS),
                                     torch.device('cuda'))
    assert [r[k]['loop_passes'] for k in chip_smoke.COLLECTIVES] == [2] * 3


@pytest.mark.cuda
def test_cuda_sharded_program_equals_host_read_loop(nccl_mesh):
    """The (1, 1) NCCL solve_batch_2d as a kept program
    (chip_smoke.check_device_loop): a device-loop miss, a host-read miss
    and a device-loop hit equal to the bit; the hit captures nothing and
    syncs nothing with the host; the device loop makes 0 host reads."""
    solve, _ = _sharded_solve(nccl_mesh)
    r = chip_smoke.check_device_loop('sharded 1x1', solve,
                                     torch.device('cuda'))
    assert r['guarded_runs'] >= 1 and r['captures']['device hit'] == 0


@pytest.mark.cuda
def test_cuda_sharded_program_counts_k3_and_equals_eager(nccl_mesh,
                                                         monkeypatch):
    """Eager and kept, counted: equal to the bit, exactly H * (1 + iters)
    K3 launches (replays included) and no other kernel; each graph of the
    program (step and init) H K3 launches a replay, and its step graph H
    K3 kernel nodes (chip_smoke.program_census)."""
    from gpmpc_tpu_torch.mpc import solver
    solve, h = _sharded_solve(nccl_mesh)
    graphs = _noted_captures(monkeypatch)
    (eager, n_e), (kept, n_k) = _eager_then_graphed(monkeypatch, solve)
    chip_smoke.same_bits('sharded eager vs kept', eager, kept)
    want = h * (1 + int(kept.iters.max()))
    for n in (n_e, n_k):
        assert n == dict(K1=0, **{'K1 f64': 0}, K2=0, K3=want, K4=0, eigh=0)
    assert graphs == [{'LAUNCHES_BLOCK': h, 'LAUNCHES_BLOCK_F64': h}] * 2
    (prog,) = solver._PROGRAMS.values()
    census = chip_smoke.program_census(prog)
    assert census['step']['k3'] == census['init']['k3'] == h
