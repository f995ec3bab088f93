"""K1's f64 tensor-core body on the CPU: its launch plan, its route and its
summation order, with the corrected f64 bound.

The plan (`rw_tied_mma_plan`, the mirror of `mma_plan` in
csrc/rw_tied_f64_body.cuh, checked against the library at load on the card)
at every shape a tied f64 launch takes: the headline, the recipe's lane
counts, suite configs 3b and 4, the closed loop's shapes, the uncertainty
experiment's, K3's rectangles, and ragged B and N. Every (scenario, output
row) falls in exactly one block, every contraction row in exactly one k step
(of 8 rows) of the warp's walk, S <= B, the shared memory within a block's
227 KB. The route (`rw_tied_body`) at each. The plain emulation of the
kernel's order (`rw_tied_mma_reference`: the k steps of the exponent, the
steps of 8 rows in order, the even then the odd rows of each) against the
plain version at f64, rtol 1e-12 of |rw| plus 1e-14 of the terms' magnitude
sum, on the headline GP's own b_lam and on random operands; its trace
against the JAX package's f64 twin (rtol 1e-12 of |t| plus the magnitude
term), and its rw against the Pallas K1 run interpreted in f32 (the
kernel's only dtype) at the JAX kernel test's bar. And
`chip_smoke.bound_ms`, importable without CUDA, reads the headline's
corrected f64 bound, ~0.0178 ms, and the table of the tensor-core body's
exp holds 2^(j/64) as Python's decimal gives it.
"""

import re
from decimal import Decimal, getcontext
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from gpmpc_tpu.ops.pallas import variance_trace as jvt
from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt
from gpmpc_tpu_torch.problems import headline_operands, make_headline_problem
from torch_port_common import np_

torch.set_num_threads(2)
F64 = torch.float64
SMS = tvt.H100_SMS
RECIPE_WIDTHS = chip_smoke.RECIPE_WIDTHS
# (B, n_out, n_c, d, E) of every tied f64 launch of the paths: the headline
# and the recipe's widths, config 3b and 4, the closed loop's (B = 1 and the
# multistart's 5; the integrator's, pendulum's and cartpole's (d, E)), the
# uncertainty experiment, K3's rectangles (Nl = N and N / 2 on the
# headline), and ragged B and N.
SHAPES = ([(b, 256, 256, 3, 2) for b in RECIPE_WIDTHS]
          + [(256, 128, 128, 5, 4), (64, 128, 128, 3, 2), (1, 512, 512, 4, 2)]
          + [(b, n, n, d, e) for b in (1, 5) for n in (128, 512)
             for d, e in ((2, 1), (3, 2), (5, 4))]
          + [(256, 128, 256, 3, 2), (256, 64, 256, 3, 2)]
          + [(7, 130, 130, 3, 2), (257, 200, 200, 3, 2), (3, 1, 1, 8, 8),
             (9, 33, 70, 8, 8), (5, 17, 100, 5, 3)])


def _coverage(plan, b, n_out):
    """How often each (scenario, output row) falls in a block: block
    (x, y) holds rows [x MMA_ROWS, (x+1) MMA_ROWS) of scenarios
    [y S, (y+1) S)."""
    hits = np.zeros((b, n_out), np.int8)
    gx, gy = plan.grid
    for x in range(gx):
        for y in range(gy):
            hits[y * plan.scenarios:(y + 1) * plan.scenarios,
                 x * tvt.MMA_ROWS:(x + 1) * tvt.MMA_ROWS] += 1
    return hits


def _steps(n_c):
    """How often each contraction row falls in a k step of a warp's walk:
    the steps of 8 rows of every chunk of MMA_CHUNK rows, the chunk's even
    then odd rows (the k indices t and t + 4 of its m16n8k8)."""
    hits = np.zeros(n_c, np.int8)
    for t in range(-(-n_c // tvt.MMA_CHUNK)):
        for st in range(tvt.MMA_CHUNK // 8):
            j0 = t * tvt.MMA_CHUNK + 8 * st
            for par in (0, 1):
                hits[j0 + par:min(j0 + 8, n_c):2] += 1
    return hits


@pytest.mark.parametrize('shape', SHAPES)
def test_mma_plan_covers_every_pair_once(shape):
    b, n_out, n_c, d, e = shape
    plan = tvt.rw_tied_mma_plan(b, n_out, d, e)
    assert 1 <= plan.scenarios <= b
    assert plan.scenarios in (1, tvt.rw_tied_mma_scenarios(d, e))
    assert plan.smem_bytes <= tvt.MAX_SMEM
    assert (plan.ks, plan.nt) == (1 + (d > 4), 1 + (d + 1 > 8))
    assert np.all(_coverage(plan, b, n_out) == 1)
    assert np.all(_steps(n_c) == 1)


@pytest.mark.parametrize('shape', SHAPES)
def test_route_takes_the_tensor_cores_where_the_grid_fills_the_card(shape):
    """f64 launches whose tensor-core grid at S_max scenarios a block holds
    a block for every SM take that body; the smaller grids keep the scalar
    body's plan, f32 always the scalar body."""
    b, n_out, n_c, d, e = shape
    body = tvt.rw_tied_body(b, n_out, n_c, d, e, F64, SMS)
    blocks = -(-n_out // tvt.MMA_ROWS) * -(-b // tvt.rw_tied_mma_scenarios(
        d, e))
    assert body == ('mma' if blocks >= SMS else 'scalar')
    assert tvt.rw_tied_body(b, n_out, n_c, d, e, torch.float32, SMS) \
        == 'scalar'


def test_design_examples():
    """The plans the design was sized for: the headline at 4 scenarios a
    block of 64 rows (128 threads), 4 x 64 blocks; B = 3,584 the same at 896
    groups; config 3b at S = 2 with the exponent in two k steps; d = 8 with
    two n tiles; B = 1 at S = 1 (where the route keeps the scalar body); the
    routes of the paths' shapes."""
    head = tvt.rw_tied_mma_plan(256, 256, 3, 2)
    assert (head.scenarios, head.grid, tvt.MMA_THREADS) == (4, (4, 64), 128)
    assert tvt.rw_tied_mma_plan(3584, 256, 3, 2).grid == (4, 896)
    p3b = tvt.rw_tied_mma_plan(256, 128, 5, 4)
    assert (p3b.scenarios, p3b.ks, p3b.nt) == (2, 2, 1)
    assert tvt.rw_tied_mma_plan(9, 130, 8, 8).nt == 2
    one = tvt.rw_tied_mma_plan(1, 512, 3, 2)
    assert (one.scenarios, one.grid) == (1, (8, 1))
    mma = [(256, 256), (1024, 256), (2048, 256), (3584, 256)]
    for b, n in mma:
        assert tvt.rw_tied_body(b, n, n, 3, 2, F64) == 'mma'
    assert tvt.rw_tied_body(256, 128, 128, 5, 4, F64) == 'mma'
    for b, n_out, n_c, d, e in [(64, 256, 256, 3, 2), (128, 256, 256, 3, 2),
                                (256, 128, 256, 3, 2), (64, 128, 128, 3, 2),
                                (1, 512, 512, 4, 2), (5, 512, 512, 3, 2)]:
        assert tvt.rw_tied_body(b, n_out, n_c, d, e, F64) == 'scalar'


@pytest.mark.parametrize('case', ['grid_y', 'd9', 'e0'])
def test_mma_plan_raises_instead_of_adjusting(case):
    args = dict(b=256, n_out=256, d=3, e=2)
    if case == 'grid_y':
        args['b'] = (tvt._MAX_GRID_Y + 1) * tvt.rw_tied_mma_scenarios(3, 2)
    elif case == 'd9':
        args['d'] = 9
    else:
        args['e'] = 0
    with pytest.raises(ValueError):
        tvt.rw_tied_mma_plan(**args)


def _random_args(rng, b, n_out, n_c, d, e):
    """K1's f64 arguments on the JAX kernel test's draw (u, x normal, M2 =
    0.1 m m^T + I, symmetric blam of scale 0.003), the output rows the
    first n_out of the n_c points."""
    u = rng.normal(size=(b, d))
    m = rng.normal(size=(b, d, d))
    m2 = m @ np.swapaxes(m, -1, -2) * 0.1 + np.eye(d)
    x = rng.normal(size=(n_c, d))
    br = rng.normal(size=(e, n_c, n_c)) * 0.003
    blam = br + np.swapaxes(br, 1, 2)
    t = lambda v: torch.tensor(v, dtype=F64)  # noqa: E731
    a, _, dv = tvt._prep_tied(t(u), t(m2), t(x))
    _, g, dv_o = tvt._prep_tied(t(u), t(m2), t(x[:n_out]))
    blk = t(np.ascontiguousarray(np.swapaxes(blam[:, :n_out], 1, 2)))
    return [g, dv_o, a, tvt._aug(a) * dv[..., None], blk]


def _assert_emulation(args, tag):
    """The emulation against the plain version: rtol 1e-12 of |rw| plus
    1e-14 of the terms' magnitude sum (rw cancels where blam changes
    sign)."""
    g, dv, a, aod, blam = args
    got = tvt.rw_tied_mma_reference(*args)
    want = tvt.rw_tied_reference(*args)
    mag = tvt.rw_tied_reference(g, dv.abs(), a, aod.abs(), blam.abs())
    err = (got - want).abs()
    bar = 1e-12 * want.abs() + 1e-14 * mag
    assert got.shape == want.shape
    assert bool((err <= bar).all()), (tag, float((err / bar).max()))
    return got


@pytest.mark.parametrize('shape', [s for s in SHAPES if s[0] <= 7
                                   or s[1] <= 130] + [(64, 256, 256, 3, 2)])
def test_emulated_order_matches_plain_version(shape):
    """On random operands."""
    b, n_out, n_c, d, e = shape
    args = _random_args(np.random.default_rng(b + n_out + d), b, n_out, n_c,
                        d, e)
    _assert_emulation(args, shape)


def test_emulated_steps_add_in_order():
    """The emulation is ((((S0e + S0o) + S1e) + S1o) + ...) dv, Sk the step
    [8 k, 8 k + 8), e its even and o its odd rows: the same bits, and not
    those of the rows taken in another order."""
    rng = np.random.default_rng(5)
    g, dv, a, aod, blam = _random_args(rng, 2, 16, 40, 3, 1)
    w = torch.exp(torch.einsum('bjk,bik->bji', a, -0.25 * g))

    def rows(js):
        return torch.einsum('eji,bji,bjc->beic', blam[:, js], w[:, js],
                            aod[:, js])

    acc = 0
    for j0 in range(0, 40, 8):
        for par in (0, 1):
            acc = acc + rows(slice(j0 + par, min(j0 + 8, 40), 2))
    got = tvt.rw_tied_mma_reference(g, dv, a, aod, blam)
    assert torch.equal(got, dv[:, None, :, None] * acc)
    other = 0
    for j0 in range(0, 40, 8):
        other = other + rows(slice(j0, min(j0 + 8, 40)))
    assert not torch.equal(got, dv[:, None, :, None] * other)


@pytest.fixture(scope='module')
def headline_cache():
    """The headline GP's x and b_lam (N = 256 capacity, 200 points)."""
    return build_rollout_cache(make_headline_problem(b=8, dtype=F64,
                                                     device='cpu').gp, 2, 1)


@pytest.mark.parametrize('b', [4, 9])
def test_emulated_order_on_the_headline_gp_matches_jax(headline_cache, b):
    """On the headline GP's own b_lam, whose trace cancels: the emulation's
    rw against the plain version, its trace against the JAX package's f64
    twin (variance_trace_batched_tied_reference) within 1e-12 |t| plus 16
    f64 ulps of the magnitude sum."""
    u, m2, x, blam = headline_operands(np.random.default_rng(b), b,
                                       headline_cache, True)
    u, m2, x, blam = (t.to(F64) for t in (u, m2, x, blam))
    a, g, dv = tvt._prep_tied(u, m2, x)
    args = [g, dv, a, tvt._aug(a) * dv[..., None], blam.contiguous()]
    t_jax = np.asarray(jvt.variance_trace_batched_tied_reference(
        *(jnp.asarray(np_(v)) for v in (u, m2, x, blam))))
    mag = tvt.variance_trace_batched_tied_reference(u, m2, x, blam.abs())
    rw = _assert_emulation(args, b)
    t = np_(rw[..., 0].sum(dim=-1))
    bar = 1e-12 * np.abs(t_jax) + 16 * np.finfo(np.float64).eps * np_(mag)
    assert np.all(np.abs(t - t_jax) <= bar)


def test_emulated_rw_matches_interpreted_tpu_kernel():
    """The emulation's rw against `_rw_call_tied`, the Pallas K1 run
    interpreted off the TPU. The Pallas kernel is f32 only (its output and
    scratch are f32), so it is held at the JAX kernel test's f32 bar, rtol
    5e-5, on operands prepared by JAX in f32."""
    rng = np.random.default_rng(6)
    b, e, n, d = 2, 2, 128, 3
    u = rng.normal(size=(b, d))
    m = rng.normal(size=(b, d, d))
    m2 = m @ np.swapaxes(m, -1, -2) * 0.1 + np.eye(d)
    x = rng.normal(size=(n, d))
    br = rng.normal(size=(e, n, n)) * 0.003
    blam = br + np.swapaxes(br, 1, 2)
    f32 = jnp.float32
    a, g, dv = jvt._prep_tied(jnp.asarray(u, f32), jnp.asarray(m2, f32),
                              jnp.asarray(x, f32))
    rw_j = np.asarray(jvt._rw_call_tied(g, a, dv, jvt._aug(a),
                                        jnp.asarray(blam, f32)))
    at, gt, dvt = (torch.tensor(np.asarray(v), dtype=F64) for v in (a, g, dv))
    rw_t = tvt.rw_tied_mma_reference(gt, dvt, at, tvt._aug(at) * dvt[..., None],
                                     torch.tensor(blam))
    np.testing.assert_allclose(np_(rw_t), rw_j, rtol=5e-5,
                               atol=5e-5 * np.abs(rw_j).max())


def test_corrected_f64_bound():
    """chip_smoke.bound_ms counts the f64 exponent and contraction
    multiply-adds at the FP64 tensor-core peak and the scale, the exp (the
    11 FP64 instructions of exp_fast, the cheapest accurate exp the kernels
    use) and the blam multiplies at the vector peak, the two times added
    (the tensor cores and the vector pipe share the FP64 datapath,
    benchmarks/dmma_rate.py): the headline's bound reads ~0.0178 ms (was
    0.0271), B = 3,584's ~0.250, bound by operations; the f32 bound is
    unchanged (0.00651)."""
    ms, by = chip_smoke.bound_ms(256, 256, 256, 3, 2, 1, f64=True)
    pairs = 256 ** 3
    assert by == 'operations' and ms == pytest.approx(0.0178, abs=5e-5)
    assert ms == pytest.approx((pairs * 25 / 34e12 + pairs * 22 / 67e12)
                               * 1e3, rel=1e-12)
    assert chip_smoke.bound_ms(3584, 256, 256, 3, 2, 1, f64=True)[0] == \
        pytest.approx(0.250, abs=5e-4)
    assert chip_smoke.bound_ms(256, 256, 256, 3, 2, 1)[0] == pytest.approx(
        0.00651, abs=1e-5)
    # K4 tied: the exps, scale and blam multiplies of the unordered pairs.
    sym = chip_smoke.sym_bound_ms(256, 256, 3, 2, 1, f64=True)[0]
    unordered = 256 * (256 * 257 // 2)
    assert sym == pytest.approx(
        (unordered * 25 / 34e12 + (unordered * 6 + pairs * 16) / 67e12) * 1e3,
        rel=1e-12)


def test_grouped_bound_counts_the_slab_at_its_width():
    """K1's grouped form reads each group's slab once, at the width the fit
    stored it: at the batched episode's (256, 512, 3, 2), groups of one,
    the bound is bytes, 0.1662 ms with f32 slabs (0.54 GB) against 0.3265
    ms counted at f64 (a widened copy's); at (1,280, 512), groups of five, it
    is operations either way (0.3569 ms)."""
    one = dict(f64=True, groups=256)
    f32 = chip_smoke.bound_ms(256, 512, 512, 3, 2, 1, blam_bytes=4, **one)
    f64 = chip_smoke.bound_ms(256, 512, 512, 3, 2, 1, **one)
    assert f32[1] == f64[1] == 'bytes'
    assert f32[0] == pytest.approx(0.1662, abs=5e-5)
    assert f64[0] == pytest.approx(0.3265, abs=5e-5)
    assert f64[0] - f32[0] == pytest.approx(
        256 * 2 * 512 * 512 * 4 / 3.35e12 * 1e3, rel=1e-9)
    five = [chip_smoke.bound_ms(1280, 512, 512, 3, 2, 1, f64=True, groups=256,
                                blam_bytes=w) for w in (4, 8)]
    assert five[0] == five[1] and five[0][1] == 'operations'


def test_exp_table_constants():
    """The table-driven exp's 2^(j / 64) (hi, lo) pairs in
    csrc/rw_tied_f64_body.cuh, recomputed with Python's decimal at 60
    digits: hi the nearest double, lo the nearest double to the rest."""
    src = (Path(tvt.__file__).parent / 'csrc'
           / 'rw_tied_f64_body.cuh').read_text()
    block = src[src.index('kExp2Table[64][2] = {'):]
    pairs = re.findall(r'\{([-0-9.e]+), ([-0-9.e]+)\}',
                       block[:block.index('};')])
    assert len(pairs) == 64
    getcontext().prec = 60
    ln2 = Decimal(2).ln()
    for j, (hi, lo) in enumerate(pairs):
        t = (ln2 * j / 64).exp()
        assert float(hi) == float(t)
        assert float(lo) == float(t - Decimal(float(hi)))
