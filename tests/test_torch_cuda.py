"""The CUDA kernels of gpmpc_tpu_torch on the card, against their plain
PyTorch versions. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor gpmpc_tpu, so it also runs on a machine
with the card and no JAX: from the repository root,

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(tests/conftest.py configures JAX, hence --noconftest there).
"""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.benchmarks.chain import kernel_args
from gpmpc_tpu_torch.ops.kernels import probe
from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt

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
    """K1 / K2 in f32 on the card against the plain version in f64: forward
    rtol 5e-5 (atol 5e-5), backward rtol 2e-3 (atol 2e-4), the bars of the
    JAX kernel test (tests/test_batched.py TestTiedStreamedKernel)."""
    dev = _cuda()
    b, e, n, d = shape
    u, m2, x, blam, ct = _problem(tied, b, e, n, d, seed=5)
    tfn = tvt.variance_trace_batched_tied if tied else tvt.variance_trace_batched
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
    assert tvt.LAUNCHES + tvt.LAUNCHES_UNTIED == before + (1 if tied else e)
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
    value also at rtol 1e-12. One counted launch."""
    dev = _cuda()
    u, m2, x, blam, ct = _problem(True, b, 2, n, 3, seed=13)

    def run(fn, dt):
        f = lambda v: torch.tensor(v, dtype=dt, device=dev)
        ut, mt = f(u).requires_grad_(), f(m2).requires_grad_()
        out = fn(ut, mt, f(x), f(blam))
        grads = torch.autograd.grad(torch.sum(out * f(ct)), (ut, mt))
        return [v.detach().cpu().double().numpy() for v in (out, *grads)]

    before = tvt.LAUNCHES
    k_out, k_gu, k_gm = run(tvt.variance_trace_batched_tied, dtype)
    torch.cuda.synchronize()
    assert tvt.LAUNCHES == before + 1
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
    """K3: the f32 row-block partials on the card, summed over n_blocks,
    against the plain full trace in f64 (fwd rtol 5e-5 atol 5e-5, bwd rtol
    2e-3 atol 2e-4); the f64 instance per block against the plain block,
    rtol 1e-12."""
    dev = _cuda()
    b, e, n, d = 256, 2, 256, 3
    u, m2, x, blam, ct = _problem(True, b, e, n, d, seed=7)
    n_loc = n // n_blocks

    def run(dtype):
        f = lambda v: torch.tensor(v, dtype=dtype, device=dev)
        ut, mt = f(u).requires_grad_(), f(m2).requires_grad_()
        parts = [tvt.variance_trace_tied_block(
            ut, mt, f(x), f(x[k:k + n_loc]),
            f(np.ascontiguousarray(np.swapaxes(blam[:, k:k + n_loc], 1, 2))))
            for k in range(0, n, n_loc)]
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
    """K4 (GPMPC_SYM_KERNEL=1) in f32 on the card against the plain column
    sweep in f64, at the bars of the K1 test above; one launch a trace for
    all E."""
    dev = _cuda()
    monkeypatch.setenv('GPMPC_SYM_KERNEL', '1')
    b, e, n, d = shape
    u, m2, x, blam, ct = _problem(tied, b, e, n, d, seed=8)
    tfn = tvt.variance_trace_batched_tied if tied else tvt.variance_trace_batched
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
    u, m2, x, blam, _ = _problem(kernel != 'K4 per-output', b, e, n, d,
                                 seed=12)
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
    cast = lambda ts: [t.to(dtype).contiguous() for t in ts]
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
@pytest.mark.parametrize('kernel', ['K1', 'K3', 'K4 tied', 'K4 per-output'])
def test_cuda_rw_ragged_plans_match_plain_version(kernel, b, n, de, dtype):
    """K1's body (K1, and K3 on n // 2 + 1 of n rows) and K4 at B not a
    multiple of S, N not a multiple of a block's rows or tile, and the (d, E)
    corners: rw against the plain version in f64 on the same inputs, f32 at
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
