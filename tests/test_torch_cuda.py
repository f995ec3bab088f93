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
