"""K4 (the symmetric-pair trace, GPMPC_SYM_KERNEL=1) and K3 (the row block
of the model-sharded path) of gpmpc_tpu_torch against gpmpc_tpu, on the CPU,
where the wrappers take their plain versions.

Bars: the plain K4 against JAX's `_prep_sym` + `_rw_call_sym`, the Pallas
kernel run interpreted (JAX's K4 is f32 only), f32 rtol 5e-5 of the largest
|rw| (the JAX kernel test's bar); the port's traces and gradients with the
opt-in on against the column sweep at f64, rtol 1e-10 (the same function in
another parametrisation: z = a chol(M2) for g = a M2); the K3 op against JAX
`variance_trace_tied_block` on the interpreted K3, f32 rtol 5e-5; the K3
partials summed over row blocks against the full trace and gradient, f64
rtol 1e-10. The kernels against their plain versions on the card are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu.ops.pallas import variance_trace as jvt
from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt
from torch_port_common import np_, spd, sym, t64

torch.set_num_threads(1)
F32 = torch.float32


def _problem(tied, b, e, n, d, seed):
    """The JAX kernel test's inputs (tests/test_batched.py,
    TestTiedStreamedKernel._problem), numpy f64."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, d))
    m2 = spd(rng, (b,) if tied else (b, e), d)
    x = rng.normal(size=(n, d))
    return u, m2, x, sym(rng, e, n), rng.normal(size=(b, e))


@pytest.mark.parametrize('tied', [True, False])
def test_rw_sym_reference_matches_interpreted_tpu_kernel(tied):
    b, e, n, d = 2, 2, 256, 3
    u, m2, x, blam, _ = _problem(tied, b, e, n, d, seed=11)
    j32 = lambda v: jnp.asarray(v, jnp.float32)
    a, z, dv = jvt._prep_sym(j32(u), j32(m2), j32(x), 1 if tied else 2)
    rw_j = np.asarray(jvt._rw_call_sym(z, a, dv, jvt._aug(a), j32(blam),
                                       shared_chain=tied))
    zt, at, dvt = (torch.tensor(np.asarray(v), dtype=F32) for v in (z, a, dv))
    rw_t = tvt.rw_sym_reference(zt, at, dvt, tvt._aug(at),
                                torch.tensor(blam, dtype=F32), tied)
    assert rw_t.shape == (b, e, n, d + 1)
    np.testing.assert_allclose(np_(rw_t), rw_j, rtol=5e-5,
                               atol=5e-5 * np.abs(rw_j).max())


@pytest.mark.parametrize('tied', [True, False])
def test_prep_sym_matches_jax(tied):
    u, m2, x, _, _ = _problem(tied, 3, 2, 20, 3, seed=12)
    axes = 1 if tied else 2
    want = jvt._prep_sym(jnp.asarray(u), jnp.asarray(m2), jnp.asarray(x), axes)
    got = tvt._prep_sym(t64(u), t64(m2), t64(x), axes)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-12,
                                   atol=1e-15)


def test_pair_indices_match_jax():
    for nt in (1, 2, 4, 7):
        for w, g in zip(jvt._pair_indices(nt), tvt._pair_indices(nt)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('tied', [True, False])
@pytest.mark.parametrize('shape', [(3, 2, 20, 3), (2, 3, 70, 5)])
def test_sym_opt_in_traces_and_grads_match_column_sweep(monkeypatch, tied,
                                                        shape):
    b, e, n, d = shape
    u, m2, x, blam, ct = _problem(tied, b, e, n, d, seed=13)
    fn = tvt.variance_trace_batched_tied if tied else tvt.variance_trace_batched

    def run():
        ut, mt = t64(u).requires_grad_(), t64(m2).requires_grad_()
        t = fn(ut, mt, t64(x), t64(blam))
        return (t, *torch.autograd.grad(torch.sum(t * t64(ct)), (ut, mt)))

    monkeypatch.delenv('GPMPC_SYM_KERNEL', raising=False)
    sweep = run()
    monkeypatch.setenv('GPMPC_SYM_KERNEL', '1')
    assert tvt._use_sym()
    pairs = run()
    for name, p, s in zip(('trace', 'du', 'dm2'), pairs, sweep):
        np.testing.assert_allclose(np_(p), np_(s), rtol=1e-10, atol=1e-14,
                                   err_msg=name)


def test_sym_opt_in_reads_only_the_jax_variable(monkeypatch):
    monkeypatch.setenv('GPMPC_SYM_KERNEL', '0')
    assert not tvt._use_sym()
    monkeypatch.setenv('GPMPC_SYM_KERNEL', '1')
    assert tvt._use_sym()


def test_sym_exponent_is_bit_symmetric():
    z = torch.tensor(np.random.default_rng(14).normal(size=(2, 33, 5)),
                     dtype=F32)
    p = tvt._sym_exponent(z)
    assert torch.equal(p, p.transpose(-1, -2))


@pytest.mark.parametrize('case', ['d9', 'e9', 'dtype', 'mixed', 'shape'])
def test_rw_sym_rejects_what_it_cannot_take(case):
    b, e, n, d = 2, 2, 8, 3
    z = lambda *s, dt=F32: torch.zeros(*s, dtype=dt)
    args = [z(b, n, d), z(b, n, d), z(b, n), z(b, n, d + 1), z(e, n, n)]
    err = ValueError
    if case == 'd9':
        args = [z(b, n, 9), z(b, n, 9), z(b, n), z(b, n, 10), z(e, n, n)]
    elif case == 'e9':
        args[4] = z(9, n, n)
    elif case == 'dtype':
        args, err = [t.half() for t in args], TypeError
    elif case == 'mixed':
        args[4], err = args[4].double(), TypeError
    elif case == 'shape':
        args[0] = z(b, n, d + 1)
    with pytest.raises(err):
        tvt.rw_sym(*args, shared_chain=True)


def test_cpu_path_counts_no_launch(monkeypatch):
    monkeypatch.setenv('GPMPC_SYM_KERNEL', '1')
    u, m2, x, blam, _ = _problem(True, 2, 2, 20, 3, seed=15)
    before = (tvt.LAUNCHES, tvt.LAUNCHES_SYM, tvt.LAUNCHES_BLOCK)
    tvt.variance_trace_batched_tied(t64(u), t64(m2), t64(x), t64(blam))
    tvt.variance_trace_tied_block(t64(u), t64(m2), t64(x), t64(x[:10]),
                                  t64(blam[:, :10].transpose(0, 2, 1)))
    assert (tvt.LAUNCHES, tvt.LAUNCHES_SYM, tvt.LAUNCHES_BLOCK) == before


# ------------------------------------------------------------------ K3 --
def test_block_op_matches_interpreted_tpu_k3():
    """The K3 op (plain rw on the CPU) against JAX's
    variance_trace_tied_block, which calls `_rw_call_tied_nm` (the Pallas
    K3, interpreted), value and per-block gradient, f32."""
    b, e, n, d, n_loc = 2, 2, 256, 3, 128
    u, m2, x, blam, ct = _problem(True, b, e, n, d, seed=16)
    for off in (0, n_loc):
        rows = slice(off, off + n_loc)
        blk = np.ascontiguousarray(np.swapaxes(blam[:, rows], 1, 2))
        j32 = lambda v: jnp.asarray(v, jnp.float32)

        def jloss(uu, mm):
            return jnp.sum(jvt.variance_trace_tied_block(
                uu, mm, j32(x), j32(x[rows]), j32(blk)) * j32(ct))

        tj = jvt.variance_trace_tied_block(j32(u), j32(m2), j32(x),
                                           j32(x[rows]), j32(blk))
        gj = jax.grad(jloss, argnums=(0, 1))(j32(u), j32(m2))
        f = lambda v: torch.tensor(v, dtype=F32)
        ut, mt = f(u).requires_grad_(), f(m2).requires_grad_()
        tt = tvt.variance_trace_tied_block(ut, mt, f(x), f(x[rows]), f(blk))
        gt = torch.autograd.grad(torch.sum(tt * f(ct)), (ut, mt))
        for want, got in ((tj, tt), *zip(gj, gt)):
            want = np.asarray(want)
            np.testing.assert_allclose(np_(got), want, rtol=5e-5,
                                       atol=5e-5 * np.abs(want).max())


@pytest.mark.parametrize('n_blocks', [2, 4])
def test_block_partials_sum_to_full_trace_and_gradient(n_blocks):
    b, e, n, d = 3, 2, 40, 3
    u, m2, x, blam, ct = _problem(True, b, e, n, d, seed=17)
    n_loc = n // n_blocks
    ut, mt = t64(u).requires_grad_(), t64(m2).requires_grad_()
    parts = [tvt.variance_trace_tied_block(
        ut, mt, t64(x), t64(x[k:k + n_loc]),
        t64(np.swapaxes(blam[:, k:k + n_loc], 1, 2)))
        for k in range(0, n, n_loc)]
    total = sum(parts)
    g_sum = torch.autograd.grad(torch.sum(total * t64(ct)), (ut, mt))
    u2, m22 = t64(u).requires_grad_(), t64(m2).requires_grad_()
    full = tvt.variance_trace_batched_tied(u2, m22, t64(x), t64(blam))
    g_full = torch.autograd.grad(torch.sum(full * t64(ct)), (u2, m22))
    np.testing.assert_allclose(np_(total), np_(full), rtol=1e-10, atol=1e-14)
    for gs_, gf in zip(g_sum, g_full):
        np.testing.assert_allclose(np_(gs_), np_(gf), rtol=1e-10, atol=1e-14)


def test_block_rejects_more_rows_than_contraction_rows():
    z = torch.zeros
    with pytest.raises(ValueError):
        tvt.rw_tied_block(z(2, 9, 3), z(2, 9), z(2, 8, 3), z(2, 8, 4),
                          z(2, 8, 9))
