"""The small symmetric eigensolver of gpmpc_tpu_torch (ops/kernels/
eigh_small.py) against gpmpc_tpu's jnp.linalg.eigh at f64 on the CPU, where
it runs its plain version: the eigendecomposition at d = 1 ... 8 on definite,
indefinite, near-degenerate and diagonal inputs and with leading batch axes;
the PSD clip of the full-covariance rollout (dynamics._psd_clip) against
JAX's clip expression in value and gradient; a ds = 4 full-covariance
rollout (d > 2, where one Jacobi rotation no longer suffices) against
gpmpc_tpu.dynamics.rollout_batched(full_cov=True); the d = 9 refusal and the
wrapper's CPU route.

Tolerances and why:
- eigenvalues within 16 d eps ||A||_F of JAX's, ||V diag(w) V^T - A||_F
  within 16 d eps ||A||_F and ||V^T V - I||_F within 16 d eps: the backward
  error of a stable eigensolver is a few eps ||A|| per rotation pass, and
  both solvers are stable (the port reads about 1 d eps ||A||_F here). f32
  at the same bars with f32's eps.
- the clip at rtol 1e-10 (atol 1e-14 of the entries' unit scale), where
  every eigengap is at least 1e-4 ||A||: two solvers' eigenvectors differ
  by about eps ||A|| / gap, and eigh's gradient divides by the gaps.
- the rollout at rtol 1e-8, the bar of tests/test_torch_fullcov.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from gpmpc_tpu import dynamics as jd
from gpmpc_tpu_torch import dynamics as td
from gpmpc_tpu_torch.ops.kernels import eigh_small
from torch_port_common import jax_gp, np_, port_gp, t64

torch.set_num_threads(1)
BAR = 16
KINDS = chip_smoke.EIGH_KINDS


def _bars(a, w, v, w_ref, eps):
    """The three errors in their units (see the module docstring)."""
    d = a.shape[-1]
    fro = np.linalg.norm(a, axis=(-2, -1))
    rec = np.linalg.norm(v @ (w[..., None] * np.swapaxes(v, -1, -2)) - a,
                         axis=(-2, -1))
    orth = np.linalg.norm(np.swapaxes(v, -1, -2) @ v - np.eye(d),
                          axis=(-2, -1))
    return (np.max(np.abs(w - w_ref).max(-1) / (d * eps * fro)),
            np.max(rec / (d * eps * fro)), np.max(orth / (d * eps)))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('d', range(1, 9))
def test_plain_eigh_matches_jax(d, kind, dtype):
    """eigh_small.eigh on CPU tensors (the plain version) against
    jnp.linalg.eigh at f64 of the same (rounded) input: eigenvalues,
    reconstruction and orthonormality at 16 d eps, eps of the dtype; the
    eigenvalues ascending."""
    a = chip_smoke.sym_inputs(kind, 64, d, dtype, seed=10 * d)
    w, v = eigh_small.eigh(torch.tensor(a))
    assert w.dtype == v.dtype == dtype
    w, v = np_(w).astype(np.float64), np_(v).astype(np.float64)
    w_ref = np.asarray(jnp.linalg.eigh(jnp.asarray(a, jnp.float64))[0])
    eps = np.finfo(a.dtype).eps
    errs = _bars(a.astype(np.float64), w, v, w_ref, eps)
    assert max(errs) <= BAR, errs
    assert np.all(np.diff(w, axis=-1) >= 0)


def test_plain_eigh_takes_leading_axes():
    """A (3, 5, 4, 4) batch gives what its flattened (15, 4, 4) batch gives,
    to the bit, and JAX's eigenvalues at the bars."""
    a = chip_smoke.sym_inputs('indefinite', 15, 4, torch.float64, seed=3)
    w, v = eigh_small.eigh(torch.tensor(a.reshape(3, 5, 4, 4)))
    wf, vf = eigh_small.eigh(torch.tensor(a))
    assert w.shape == (3, 5, 4) and v.shape == (3, 5, 4, 4)
    assert torch.equal(w.reshape(15, 4), wf)
    assert torch.equal(v.reshape(15, 4, 4), vf)
    w_ref = np.asarray(jnp.linalg.eigh(jnp.asarray(a))[0])
    assert max(_bars(a, np_(wf), np_(vf), w_ref,
                     np.finfo(np.float64).eps)) <= BAR


def test_plain_eigh_stops_where_the_kernel_stops():
    """d = 2 needs one rotation, exact: a second sweep rotates nothing, so
    the matrix comes out diagonal in V^T A V to the rounding; a diagonal
    input is returned as it is, sorted, with a permutation for V."""
    a = torch.tensor([[[2.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 0.5]]],
                     dtype=torch.float64)
    w, v = eigh_small.eigh(a)
    assert w.tolist() == [[-1.0, 0.5, 2.0]]
    assert v.tolist() == [[[0.0, 0.0, 1.0], [1.0, 0.0, 0.0],
                           [0.0, 1.0, 0.0]]]
    b = torch.tensor([[[1.0, 0.3], [0.3, 2.0]]], dtype=torch.float64)
    w, v = eigh_small.eigh(b)
    off = (v.transpose(-1, -2) @ b @ v)[0, 0, 1]
    assert abs(float(off)) < 4 * np.finfo(np.float64).eps


def _gapped(rng, n, d, gap):
    """Symmetric (n, d, d) with eigenvalues in [-1, 2] at least gap apart,
    the smallest negative (so the clip acts), and random eigenvectors."""
    q = np.linalg.qr(rng.normal(size=(n, d, d)))[0]
    w = np.sort(rng.uniform(-1.0, 2.0, (n, d)), axis=-1)
    w[:, 0] = np.minimum(w[:, 0], -0.2)
    w = w + gap * np.arange(d)
    a = q @ (w[..., None] * np.swapaxes(q, -1, -2))
    return (a + np.swapaxes(a, -1, -2)) / 2


def _jax_clip(a):
    """JAX's PSD clip (gpmpc_tpu/dynamics.py:312-313)."""
    w, v = jnp.linalg.eigh(a)
    return jnp.einsum('...ik,...k,...jk->...ij', v, jnp.maximum(w, 1e-8), v)


@pytest.mark.parametrize('shape', [(32, 2), (32, 3), (32, 4), (None, 2),
                                   (None, 4)])
def test_psd_clip_matches_jax_value_and_grad(shape):
    """dynamics._psd_clip on (B, d, d) (the batched step) and (d, d) (the
    single-scenario step) against JAX's clip expression, value and jax.grad
    of a weighted sum, rtol 1e-10, on inputs whose eigengaps are at least
    1e-4 ||A|| and some of whose eigenvalues the clip raises."""
    b, d = shape
    rng = np.random.default_rng(d)
    a = _gapped(rng, b or 1, d, gap=1e-3)
    if b is None:
        a = a[0]
    fro = np.linalg.norm(a, axis=(-2, -1))
    gaps = np.diff(np.linalg.eigvalsh(a), axis=-1).min(-1)
    assert np.all(gaps >= 1e-4 * fro)
    assert np.any(np.linalg.eigvalsh(a) < 1e-8)          # the clip acts
    g = rng.normal(size=a.shape)
    cj = np.asarray(_jax_clip(jnp.asarray(a)))
    gj = np.asarray(jax.grad(lambda x: jnp.sum(_jax_clip(x) * g))(
        jnp.asarray(a)))
    x = t64(a).requires_grad_()
    c = td._psd_clip(x)
    (gt,) = torch.autograd.grad(torch.sum(c * t64(g)), x)
    np.testing.assert_allclose(np_(c), cj, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(np_(gt), gj, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize('delta', [False, True])
def test_rollout_ds4_full_cov_matches_jax(delta):
    """A cartpole-shaped full-covariance rollout (ds = 4, da = 1, tied,
    N = 24 in capacity 32, B = 3, H = 4) against gpmpc_tpu's
    rollout_batched(full_cov=True): means, covariances and the gradient of
    a weighted sum w.r.t. the actions at rtol 1e-8. Each step's 4 x 4
    covariance takes several Jacobi sweeps."""
    jgp = jax_gp(n=24, cap=32, ds=4, da=1, seed=5)
    tgp = port_gp(jgp)
    rng = np.random.default_rng(12)
    b, h = 3, 4
    x0s = rng.uniform(-1, 1, (b, 4))
    us = rng.uniform(-1, 1, (b, h, 1))
    wts = rng.normal(size=(b, h + 1, 4))
    jcache = jd.build_rollout_cache(jgp, 4, 1)
    tcache = td.build_rollout_cache(tgp, 4, 1)

    def jf(u):
        m, c = jd.rollout_batched(jcache, jnp.asarray(x0s), u, delta=delta,
                                  full_cov=True)
        return jnp.sum(m * wts) + 10 * jnp.sum(c ** 2), (m, c)

    (_, (mj, cj)), gj = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(us))
    ut = t64(us).requires_grad_()
    mt, ct = td.rollout_batched(tcache, t64(x0s), ut, delta=delta,
                                full_cov=True)
    (gt,) = torch.autograd.grad(
        torch.sum(mt * t64(wts)) + 10 * torch.sum(ct ** 2), ut)
    assert ct.shape == (b, h + 1, 4, 4)
    assert float(ct[:, 1:, 0, 3].detach().abs().min()) > 0   # not diagonal
    np.testing.assert_allclose(np_(mt), np.asarray(mj), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(np_(gt), np.asarray(gj), rtol=1e-8, atol=1e-13)


def test_d9_raises():
    """d = 9 is past the kernel's instances: ValueError naming the limit,
    from the entry point and from the plain version."""
    a = torch.eye(9, dtype=torch.float64)
    with pytest.raises(ValueError, match='d <= 8'):
        eigh_small.eigh(a)
    with pytest.raises(ValueError, match='d <= 8'):
        eigh_small.eigh_reference(a)


def test_cpu_tensors_take_the_plain_version():
    """On a CPU tensor the wrapper takes the plain version and counts no
    launch; the kernel's own launch refuses a CPU tensor."""
    a = torch.tensor(chip_smoke.sym_inputs('definite', 8, 3, torch.float64, 1))
    before = eigh_small.LAUNCHES_EIGH
    w, v = eigh_small.eigh(a)
    wp, vp = eigh_small.eigh_reference(a)
    assert torch.equal(w, wp) and torch.equal(v, vp)
    assert eigh_small.LAUNCHES_EIGH == before
    with pytest.raises(ValueError, match='CUDA'):
        eigh_small.launch(a)


@pytest.mark.parametrize('name, keys', [
    ('_ZN12_GLOBAL__N_117eigh_small_kernelIfLi2EEEvPKT_PS1_S4_x',
     ('LAUNCHES_EIGH',)),
    ('void <unnamed>::eigh_small_kernel<double, 4>(const double *, double *, '
     'double *, long long)', ('LAUNCHES_EIGH',)),
    ('_ZN12_GLOBAL__N_114rw_tied_kernelIdLi3ELi2EEEvv', ()),
    ('elementwise_kernel', ())])
def test_graph_counters_sort_the_eigensolver(name, keys):
    """A captured graph's kernel node counts in LAUNCHES_EIGH where it is
    the eigensolver, and in nothing of this module otherwise."""
    assert eigh_small.graph_counters(name) == keys
