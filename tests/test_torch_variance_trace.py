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
        return jnp.sum(jfn(u_, m2_, jnp.asarray(x),
                           jnp.asarray(blam, jnp.float64)) * ct)

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
    groups (the trace's vmap rule), the port fed the slab at its storage
    width (f32, as the fit stores it; values that f32 holds exactly, so
    JAX's f64 twin gets the same numbers), against jax.vmap of JAX's tied
    trace at f64 (its plain twin, as test_trace_value_and_grad_match_jax
    runs it: the Pallas kernel interprets only f32): rtol 1e-8."""
    u, m2, x, blam, ct = _grouped()
    blam = blam.astype(np.float32)
    g, k, d = u.shape
    jfn = jax.vmap(jvt.variance_trace_batched_tied_reference)

    def jloss(u_, m2_):
        return jnp.sum(jfn(u_, m2_, jnp.asarray(x),
                           jnp.asarray(blam, jnp.float64)) * ct)

    tj = jfn(jnp.asarray(u), jnp.asarray(m2), jnp.asarray(x),
             jnp.asarray(blam, jnp.float64))
    gu_j, gm_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u), jnp.asarray(m2))
    for mapped in (False, True):
        ut, m2t = t64(u).requires_grad_(), t64(m2).requires_grad_()
        slab = torch.from_numpy(blam)
        if mapped:
            tt = torch.func.vmap(tvt.variance_trace_batched_tied)(
                ut, m2t, t64(x), slab)
        else:
            tt = tvt.variance_trace_batched_tied(
                ut.reshape(g * k, d), m2t.reshape(g * k, d, d), t64(x),
                slab).reshape(g, k, -1)
        gu_t, gm_t = torch.autograd.grad(torch.sum(tt * t64(ct)), (ut, m2t))
        for got, want in ((tt, tj), (gu_t, gu_j), (gm_t, gm_j)):
            np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                                       atol=1e-14)


@pytest.mark.parametrize('mapped', [False, True])
def test_grouped_f32_slab_equals_widened_slab(mapped):
    """On the CPU the grouped trace and its gradient with the slab in f32
    (its storage width: no widened copy) equal those with the same slab
    widened to f64, to the bit, called flat and under torch.func.vmap;
    with f32 operands the trace comes back in f32."""
    u, m2, x, blam, ct = _grouped(seed=9)
    g, k, d = u.shape
    slab32 = torch.from_numpy(blam.astype(np.float32))
    out = []
    for slab in (slab32, slab32.double()):
        ut, m2t = t64(u).requires_grad_(), t64(m2).requires_grad_()
        if mapped:
            tt = torch.func.vmap(tvt.variance_trace_batched_tied)(
                ut, m2t, t64(x), slab)
        else:
            tt = tvt.variance_trace_batched_tied(
                ut.reshape(g * k, d), m2t.reshape(g * k, d, d), t64(x),
                slab).reshape(g, k, -1)
        out.append((tt, *torch.autograd.grad(torch.sum(tt * t64(ct)),
                                             (ut, m2t))))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    f32 = tvt.variance_trace_batched_tied(
        t64(u).reshape(g * k, d).float(), t64(m2).reshape(g * k, d, d).float(),
        t64(x).float(), slab32)
    assert f32.dtype == torch.float32 and torch.isfinite(f32).all()


def test_grouped_plan_keeps_blocks_within_a_group():
    """The grouped plans (rw_tied_grouped_plan): a group's scenarios in
    ceil(K / group_sets) blocks of its own, each of ceil(K / blocks)
    scenario sets of one scenario: five a group at d = 3, E = 2 fill one
    block's five slots in either body, nine take two blocks of five; the
    slab's bytes a launch at its storage width; the route by the grid at
    S_max; a blam whose groups do not divide B is refused."""
    f64, f32 = torch.float64, torch.float32
    p = tvt.rw_tied_grouped_plan(1280, 512, 512, 3, 2, 5)
    assert (p.body, p.sets, p.gblocks, p.grid, p.block) == (
        'mma', 5, 1, (8, 256), (32, 4, 5))
    assert (p.live, p.slots, p.blam_bytes) == (5, 5, 256 * 2 * 512 * 512 * 8)
    q = tvt.rw_tied_grouped_plan(256, 512, 512, 3, 2, 1, blam_dtype=f32)
    assert (q.sets, q.grid, q.blam_bytes) == (1, (8, 256),
                                              256 * 2 * 512 * 512 * 4)
    s = tvt.rw_tied_grouped_plan(1280, 512, 512, 3, 2, 5, body='scalar')
    assert (s.sets, s.gblocks, s.grid, s.block) == (5, 1, (16, 256),
                                                    (32, 4, 5))
    n = tvt.rw_tied_grouped_plan(18, 64, 64, 3, 2, 9)
    assert (n.sets, n.gblocks, n.live, n.slots) == (5, 2, 9, 10)
    assert tvt.group_sets(5, 4) == 2 and tvt.group_sets(8, 8) == 1
    assert tvt.rw_tied_body(1280, 512, 512, 3, 2, f64, group=5) == 'mma'
    assert tvt.rw_tied_body(5, 512, 512, 3, 2, f64, group=5) == 'scalar'
    with pytest.raises(TypeError):
        tvt.rw_tied_grouped_plan(10, 64, 64, 3, 2, 5, f32, blam_dtype=f64)
    args = _rw_args(b=6, dtype=f64)
    with pytest.raises(ValueError, match='dividing'):
        tvt.rw_tied(*args[:4], torch.zeros((4, 2, 8, 8), dtype=f64))


@pytest.mark.parametrize('body', ['mma', 'scalar'])
@pytest.mark.parametrize('group', [1, 2, 5, 9])
def test_grouped_plan_covers_each_scenario_once(group, body):
    """At each group of the load check (_PLAN_CHECK_GROUP), every scenario
    falls in exactly one (block, set) slot, as the kernels index it (set s
    of block y of group y // gblocks: scenario group * grp + (y - grp *
    gblocks) * sets + s), within its own group; the slots past a group's
    end are the plan's slots less its live ones; every output row in one
    row tile."""
    assert group in tvt._PLAN_CHECK_GROUP
    b, n = 3 * group, 100
    p = tvt.rw_tied_grouped_plan(b, n, n, 3, 2, group, body=body)
    seen = []
    for y in range(p.grid[1]):
        grp = y // p.gblocks
        for st in range(p.sets):
            sc = grp * group + ((y - grp * p.gblocks) * p.sets + st)
            if sc < (grp + 1) * group:
                seen.append((sc, grp))
    assert sorted(seen) == [(sc, sc // group) for sc in range(b)]
    assert len(seen) == b and p.grid[1] * p.sets - b == 3 * (p.slots - p.live)
    assert (p.slots - p.live) < p.gblocks
    rows = tvt.MMA_ROWS if body == 'mma' else tvt.GROUP_ROWS
    assert p.grid[0] * rows >= n > (p.grid[0] - 1) * rows
