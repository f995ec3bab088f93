"""K2 in one launch for all outputs, on the CPU: the untied trace of the port
(`variance_trace_batched`, whose kernel `rw_untied` now computes all E
outputs at once) against the JAX package's at the closed loop's shapes,
padded rows zeroed: values and gradients against JAX's plain reference at
f64 (rtol 1e-8, as tests/test_batched.py holds it). K2's split plain
version against the TPU kernel `_rw_call` (K1 at E = 1 per output, run
interpreted) at f32. And the wrapper: one call for all E, nothing counted
on the CPU, and what the launch refuses before it reaches the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpmpc_tpu.ops.pallas import variance_trace as jvt
from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt
from torch_port_common import np_, t64

torch.set_num_threads(2)
RTOL = 1e-8
# The closed loop's shapes (chip_smoke.py LOOP_*): (B, N, valid rows, d, E).
LOOP_SHAPES = [(b, n, v, d, e) for b in (1, 5) for n, v in ((128, 100),
                                                          (512, 320))
               for d, e in ((2, 1), (3, 2), (5, 4))]


def _problem(b, n, n_valid, d, e, seed):
    """The JAX kernel test's inputs (tests/test_batched.py) with untied M2,
    x and blam zero outside the n_valid valid rows, as a padded GP holds
    them; numpy f64."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, d))
    m = rng.normal(size=(b, e, d, d))
    m2 = m @ np.swapaxes(m, -1, -2) * 0.1 + np.eye(d)
    x = rng.normal(size=(n, d))
    br = rng.normal(size=(e, n, n)) * 0.003
    blam = br + np.swapaxes(br, -1, -2)
    x[n_valid:] = 0.0
    blam[:, n_valid:] = 0.0
    blam[:, :, n_valid:] = 0.0
    return u, m2, x, blam, rng.normal(size=(b, e))


@pytest.mark.parametrize('shape', LOOP_SHAPES)
def test_untied_trace_matches_jax_at_loop_shapes(shape):
    b, n, n_valid, d, e = shape
    u, m2, x, blam, ct = _problem(b, n, n_valid, d, e, seed=n + d + b)
    xj, bj = jnp.asarray(x), jnp.asarray(blam)

    def jloss(u_, m2_):
        return jnp.sum(jvt.variance_trace_batched_reference(u_, m2_, xj, bj)
                       * ct)

    tj = jvt.variance_trace_batched_reference(jnp.asarray(u), jnp.asarray(m2),
                                              xj, bj)
    gu_j, gm_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u),
                                                 jnp.asarray(m2))
    ut, m2t = t64(u).requires_grad_(), t64(m2).requires_grad_()
    tt = tvt.variance_trace_batched(ut, m2t, t64(x), t64(blam))
    gu_t, gm_t = torch.autograd.grad(torch.sum(tt * t64(ct)), (ut, m2t))
    assert tt.shape == (b, e)
    for got, want in ((tt, tj), (gu_t, gu_j), (gm_t, gm_j)):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                                   atol=1e-14)


@pytest.mark.parametrize('de', [(2, 1), (3, 2)])
def test_split_untied_matches_interpreted_tpu_kernel(de):
    """K2's split plain version, under the f32 plan of B = 1 at N = 128 (a
    cluster of 8 ranks of 16 rows), against `_rw_call`, the TPU kernel
    itself (run interpreted off the TPU), at f32: rtol 5e-5 of the largest
    entry, the JAX kernel test's bar."""
    d, e = de
    b, n = 1, 128
    u, m2, x, blam, _ = _problem(b, n, 100, d, e, seed=5 + d)
    f32 = jnp.float32
    a, g, dv = jvt._prep_batched(jnp.asarray(u, f32), jnp.asarray(m2, f32),
                                 jnp.asarray(x, f32))
    rw_j = np.asarray(jvt._rw_call(g, a, dv, jvt._aug(a),
                                   jnp.asarray(blam, f32)))
    ft = torch.float32
    at, gt, dvt = (torch.tensor(np.asarray(v), dtype=ft) for v in (a, g, dv))
    plan = tvt.rw_untied_plan(b, n, d, e, ft)
    assert plan.split == 8 and plan.grid == (16, 1, e)
    rw_t = tvt.rw_untied_split_reference(gt, dvt, at, tvt._aug(at),
                                         torch.tensor(blam, dtype=ft), plan)
    assert rw_t.shape == rw_j.shape == (b, e, n, d + 1)
    np.testing.assert_allclose(np_(rw_t), rw_j, rtol=5e-5,
                               atol=5e-5 * np.abs(rw_j).max())


def _rw_args(b=2, n=24, d=3, e=2, dtype=torch.float64):
    u, m2, x, blam, _ = _problem(b, n, n, d, e, seed=9)
    a, g, dv = tvt._prep_batched(t64(u), t64(m2), t64(x))
    return [t.to(dtype).contiguous() for t in (g, dv, a, tvt._aug(a),
                                               t64(blam))]


def test_cpu_untied_is_one_plain_call_for_all_outputs():
    """On the CPU `rw_untied` is its plain version, all E outputs at once,
    and counts no launch; the one-launch trace prepares no per-output
    tensor, so its operands reach the wrapper as the prep made them."""
    args = _rw_args()
    before = tvt.LAUNCHES_UNTIED
    got = tvt.rw_untied(*args)
    assert tvt.LAUNCHES_UNTIED == before
    assert torch.equal(got, tvt.rw_untied_reference(*args))
    assert got.shape == (2, 2, 24, 4)


@pytest.mark.parametrize('case', ['cpu_tensors', 'dv_shape', 'ao_shape',
                                  'mixed_dtype', 'not_contiguous', 'e9'])
def test_untied_launch_refuses_before_the_card(case):
    """K2's launch raises, launching nothing, on CPU tensors (no fallback to
    the plain version below the wrapper) and on operands it cannot take."""
    args = _rw_args()
    err = ValueError
    if case == 'dv_shape':
        args[1] = args[1][:, :1].contiguous()
    elif case == 'ao_shape':
        args[3] = args[3][..., :3].contiguous()
    elif case == 'mixed_dtype':
        args[3], err = args[3].float(), TypeError
    elif case == 'not_contiguous':
        args[2] = args[2].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == 'e9':
        args[0] = args[0][:, :1].expand(-1, 9, -1, -1).contiguous()
        args[1] = args[1][:, :1].expand(-1, 9, -1).contiguous()
        args[4] = args[4][:1].expand(9, -1, -1).contiguous()
    before = tvt.LAUNCHES_UNTIED
    with pytest.raises(err):
        tvt._launch_untied(*args)
    assert tvt.LAUNCHES_UNTIED == before
