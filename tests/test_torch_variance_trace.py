"""gpmpc_tpu_torch.ops.kernels.variance_trace against gpmpc_tpu's variance
trace: the autograd Functions (analytic backward over the plain rw) against
JAX's plain twins at f64 (rtol 1e-8, values and gradients), the plain rw
against the real TPU kernel run interpreted at f32 (rtol 5e-5), the wrapper's
checks. The CUDA kernel against its plain version on the card is in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu.ops.pallas import variance_trace as jvt
from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt
from torch_port_common import np_, spd, sym, t64

torch.set_num_threads(1)
RTOL = 1e-8


def _problem(tied, b=3, e=2, n=20, d=3, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, d))
    m2 = spd(rng, (b,) if tied else (b, e), d)
    x = rng.normal(size=(n, d))
    return u, m2, x, sym(rng, e, n), rng.normal(size=(b, e))


@pytest.mark.parametrize('tied', [True, False])
@pytest.mark.parametrize('shape', [(3, 2, 20, 3), (1, 1, 9, 1), (2, 3, 17, 5)])
def test_trace_value_and_grad_match_jax(tied, shape):
    b, e, n, d = shape
    u, m2, x, blam, ct = _problem(tied, b, e, n, d)
    jfn = (jvt.variance_trace_batched_tied_reference if tied
           else jvt.variance_trace_batched_reference)
    tfn = tvt.variance_trace_batched_tied if tied else tvt.variance_trace_batched

    def jloss(u_, m2_):
        return jnp.sum(jfn(u_, m2_, jnp.asarray(x), jnp.asarray(blam)) * ct)

    tj = jfn(jnp.asarray(u), jnp.asarray(m2), jnp.asarray(x), jnp.asarray(blam))
    gu_j, gm_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(m2))

    ut, m2t = t64(u).requires_grad_(), t64(m2).requires_grad_()
    tt = tfn(ut, m2t, t64(x), t64(blam))
    gu_t, gm_t = torch.autograd.grad(torch.sum(tt * t64(ct)), (ut, m2t))
    np.testing.assert_allclose(np_(tt), np.asarray(tj), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(np_(gu_t), np.asarray(gu_j), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(np_(gm_t), np.asarray(gm_j), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize('tied', [True, False])
def test_port_reference_twins_match_jax(tied):
    u, m2, x, blam, _ = _problem(tied, seed=1)
    jfn = (jvt.variance_trace_batched_tied_reference if tied
           else jvt.variance_trace_batched_reference)
    tfn = (tvt.variance_trace_batched_tied_reference if tied
           else tvt.variance_trace_batched_reference)
    np.testing.assert_allclose(
        np_(tfn(t64(u), t64(m2), t64(x), t64(blam))),
        np.asarray(jfn(jnp.asarray(u), jnp.asarray(m2), jnp.asarray(x),
                       jnp.asarray(blam))), rtol=RTOL)


def test_rw_reference_matches_interpreted_tpu_kernel():
    """The plain rw against `_rw_call_tied`, the Pallas kernel itself (run
    interpreted off the TPU), at f32: rtol 5e-5, the JAX kernel test's bar."""
    b, e, n, d = 2, 2, 128, 3
    u, m2, x, blam, _ = _problem(True, b, e, n, d, seed=2)
    f32 = jnp.float32
    a, g, dv = jvt._prep_tied(jnp.asarray(u, f32), jnp.asarray(m2, f32),
                              jnp.asarray(x, f32))
    rw_j = np.asarray(jvt._rw_call_tied(g, a, dv, jvt._aug(a),
                                        jnp.asarray(blam, f32)))
    ft = torch.float32
    at, gt, dvt = (torch.tensor(np.asarray(v), dtype=ft) for v in (a, g, dv))
    aod = tvt._aug(at) * dvt[..., None]
    rw_t = tvt.rw_tied_reference(gt, dvt, at, aod, torch.tensor(blam, dtype=ft))
    assert rw_t.shape == (b, e, n, d + 1)
    np.testing.assert_allclose(np_(rw_t), rw_j, rtol=5e-5,
                               atol=5e-5 * np.abs(rw_j).max())


def test_rw_row_blocks_sum_to_full():
    """The rectangle contract (n_out != n_c): row blocks of rw are the rows of
    the full rw, with blam's columns cut to the block."""
    u, m2, x, blam, _ = _problem(True, n=20, seed=3)
    ut, m2t, xt, bt = t64(u), t64(m2), t64(x), t64(blam)
    a, g, dv = tvt._prep_tied(ut, m2t, xt)
    aod = tvt._aug(a) * dv[..., None]
    full = tvt.rw_tied_reference(g, dv, a, aod, bt)
    blk = tvt.rw_tied_reference(g[:, 5:12], dv[:, 5:12], a, aod, bt[:, :, 5:12])
    np.testing.assert_allclose(np_(blk), np_(full[:, :, 5:12]), rtol=1e-12)


def test_cpu_path_takes_plain_version_and_counts_nothing():
    u, m2, x, blam, _ = _problem(True, seed=4)
    before = (tvt.LAUNCHES, tvt.LAUNCHES_UNTIED)
    tvt.variance_trace_batched_tied(t64(u), t64(m2), t64(x), t64(blam))
    u2, m22, x2, blam2, _ = _problem(False, seed=4)
    tvt.variance_trace_batched(t64(u2), t64(m22), t64(x2), t64(blam2))
    assert (tvt.LAUNCHES, tvt.LAUNCHES_UNTIED) == before


def _rw_args(b=2, e=2, n=8, d=3, dtype=torch.float32):
    z = torch.zeros
    return [z(b, n, d, dtype=dtype), z(b, n, dtype=dtype), z(b, n, d, dtype=dtype),
            z(b, n, d + 1, dtype=dtype), z(e, n, n, dtype=dtype)]


@pytest.mark.parametrize('case', ['cpu', 'd9', 'e9', 'dtype', 'mixed', 'shape',
                                  'noncontig'])
def test_kernel_launch_rejects_what_it_cannot_take(case):
    args = _rw_args()
    err = ValueError
    if case == 'd9':
        args = _rw_args(d=9)
    elif case == 'e9':
        args = _rw_args(e=9)
    elif case == 'dtype':
        args, err = _rw_args(dtype=torch.float16), TypeError
    elif case == 'mixed':
        args[4], err = args[4].double(), TypeError
    elif case == 'shape':
        args[3] = torch.zeros(2, 8, 3)
    elif case == 'noncontig':
        args[2] = torch.zeros(2, 3, 8).transpose(1, 2)
    with pytest.raises(err):
        tvt._launch(*args)


def _grouped(g=3, k=5, e=2, n=20, d=3, seed=5):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(g, k, d))
    m2 = spd(rng, (g, k), d)
    x = rng.normal(size=(g, n, d))
    blam = np.stack([sym(rng, e, n) for _ in range(g)])
    return u, m2, x, blam, rng.normal(size=(g, k, e))


def test_grouped_rw_reference_matches_per_group():
    """K1's grouped form's plain version, group by group, against the plain
    rw on that group's scenarios and blam."""
    u, m2, x, blam, _ = _grouped()
    g, k, d = u.shape
    ut, m2t = t64(u).reshape(g * k, d), t64(m2).reshape(g * k, d, d)
    a, gg, dv = tvt._prep_tied(ut, m2t, t64(x))
    aod = tvt._aug(a) * dv[..., None]
    rw = tvt.rw_tied_grouped_reference(gg, dv, a, aod, t64(blam))
    assert tvt.rw_tied(gg, dv, a, aod, t64(blam)).equal(rw)
    for i in range(g):
        sl = slice(i * k, (i + 1) * k)
        np.testing.assert_allclose(
            np_(rw[sl]), np_(tvt.rw_tied_reference(gg[sl], dv[sl], a[sl],
                                                   aod[sl], t64(blam[i]))),
            rtol=1e-12, atol=1e-16)


def test_grouped_trace_and_grad_match_jax_vmap():
    """The grouped trace (x and blam one a group of five scenarios) and its
    analytic gradient, called flat and through torch.func.vmap over the
    groups (the trace's vmap rule), against jax.vmap of JAX's tied trace at
    f64 (its plain twin, as test_trace_value_and_grad_match_jax runs it:
    the Pallas kernel interprets only f32): rtol 1e-8."""
    u, m2, x, blam, ct = _grouped()
    g, k, d = u.shape
    jfn = jax.vmap(jvt.variance_trace_batched_tied_reference)

    def jloss(u_, m2_):
        return jnp.sum(jfn(u_, m2_, jnp.asarray(x), jnp.asarray(blam)) * ct)

    tj = jfn(
        jnp.asarray(u), jnp.asarray(m2), jnp.asarray(x), jnp.asarray(blam))
    gu_j, gm_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(m2))
    for mapped in (False, True):
        ut, m2t = t64(u).requires_grad_(), t64(m2).requires_grad_()
        if mapped:
            tt = torch.func.vmap(tvt.variance_trace_batched_tied)(
                ut, m2t, t64(x), t64(blam))
        else:
            tt = tvt.variance_trace_batched_tied(
                ut.reshape(g * k, d), m2t.reshape(g * k, d, d), t64(x),
                t64(blam)).reshape(g, k, -1)
        gu_t, gm_t = torch.autograd.grad(torch.sum(tt * t64(ct)), (ut, m2t))
        for got, want in ((tt, tj), (gu_t, gu_j), (gm_t, gm_j)):
            np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                                       atol=1e-14)


def test_grouped_plan_keeps_blocks_within_a_group():
    """The grouped plans: a group's scenarios in ceil(K / S) blocks of its
    own (five a group at S = 4 in the tensor-core body: two blocks, the
    second one scenario), S = 1 below S_max, the route by the grid; a
    blam whose groups do not divide B is refused."""
    f64 = torch.float64
    p = tvt.rw_tied_mma_plan(1280, 512, 3, 2, group=5)
    assert (p.scenarios, p.gblocks, p.grid) == (4, 2, (8, 512))
    assert tvt.rw_tied_mma_plan(256, 512, 3, 2, group=1).grid == (8, 256)
    assert tvt.rw_tied_mma_plan(256, 512, 3, 2) == tvt.rw_tied_mma_plan(
        256, 512, 3, 2, group=256)._replace(gblocks=64)
    s = tvt.rw_tied_plan(1280, 512, 512, 3, 2, f64, group=5)
    assert (s.scenarios, s.gblocks, s.grid[1]) == (2, 3, 768)
    assert tvt.rw_tied_plan(64, 128, 128, 3, 2, f64, group=1).scenarios == 1
    assert tvt.rw_tied_body(1280, 512, 512, 3, 2, f64, group=5) == 'mma'
    assert tvt.rw_tied_body(5, 512, 512, 3, 2, f64, group=5) == 'scalar'
    args = _rw_args(b=6, dtype=f64)
    with pytest.raises(ValueError, match='dividing'):
        tvt.rw_tied(*args[:4], torch.zeros((4, 2, 8, 8), dtype=f64))
