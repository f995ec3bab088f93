"""The small-B launch plans of K1's body on the CPU: K1 (`rw_tied_plan`) and
K2 (`rw_untied_plan`, one launch for all E outputs) at every shape of the
closed loop and at suite config 4. Each (scenario, output, output row,
contraction row) falls in exactly one block of one split rank; a block
serves no more scenarios than there are; a split stays within the portable
cluster of 8 blocks along grid.x. The plans of the headline, the recipe's
lane counts, config 3b and the untied headline need no split and are the
ones the kernels ran before the small-B plan. And the split sum's plain
version (the ranks' partials added in rank order) against the unsplit
plain version at f64. The compiled plans are checked against these on the
card when a library loads (ops/kernels/variance_trace.py,
_check_launch_plans)."""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt

torch.set_num_threads(2)
DTYPES = [torch.float32, torch.float64]
# The closed loop's shapes (chip_smoke.py LOOP_*): B = 1 and the
# multistart's 5 candidates, capacities 128 and 512, the integrator's,
# pendulum's and cartpole's (d, E); and suite config 4's (B, N, d, E).
LOOP_B = (1, 5)
LOOP_N = (128, 512)
LOOP_DE = ((2, 1), (3, 2), (5, 4))
CONFIG_4 = (64, 128, 3, 2)
# The shapes whose plans must not change: the headline, every lane count of
# the recipe (RECIPE_WIDTHS, at N = 256), config 3b and the untied headline.
HEADLINE = (256, 256, 3, 2)
RECIPE_WIDTHS = (64, 128, 256, 1024, 2048, 14 * 256)
CONFIG_3B = (256, 128, 5, 4)
MAX_CLUSTER = 8


def _loop_shapes():
    return ([(b, n, d, e) for b in LOOP_B for n in LOOP_N
             for d, e in LOOP_DE] + [CONFIG_4])


def _coverage(plan, b, n, e, untied):
    """How often each (scenario, output, output row, contraction row) falls
    in a block of `plan`: block (x, y, z) is row tile x // split and rank
    x % split, scenarios [y S, (y+1) S), output z (untied) or all E, and
    contraction rows [rank chunk, (rank+1) chunk)."""
    hits = np.zeros((b, e, n, n), np.int8)
    gx, gy = plan.grid[:2]
    gz = plan.grid[2] if untied else 1
    for x in range(gx):
        tile, rank = divmod(x, plan.split)
        rows = slice(tile * plan.rows, (tile + 1) * plan.rows)
        cols = slice(rank * plan.chunk, (rank + 1) * plan.chunk)
        for y in range(gy):
            scen = slice(y * plan.scenarios, (y + 1) * plan.scenarios)
            for z in range(gz):
                outs = slice(z, z + 1) if untied else slice(None)
                hits[scen, outs, rows, cols] += 1
    return hits


@pytest.mark.parametrize('untied', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', _loop_shapes())
def test_small_b_plan_covers_every_pair_once(shape, dtype, untied):
    b, n, d, e = shape
    plan = (tvt.rw_untied_plan(b, n, d, e, dtype) if untied
            else tvt.rw_tied_plan(b, n, n, d, e, dtype))
    assert 1 <= plan.scenarios <= b
    assert plan.scenarios in (1, tvt.rw_scenarios(d, 1 if untied else e,
                                                  dtype))
    assert 1 <= plan.split <= MAX_CLUSTER
    assert plan.cluster == (plan.split, 1, 1)
    assert plan.grid[0] % plan.split == 0
    assert len(plan.grid) == (3 if untied else 2)
    if untied:
        assert plan.grid[2] == e
    if plan.split > 1:
        assert plan.chunk % plan.slices == 0
        assert plan.chunk >= tvt.SPLIT_ROWS
        assert (plan.split - 1) * plan.chunk < n <= plan.split * plan.chunk
        assert plan.sub == min(tvt.SUB_ROWS, plan.chunk // plan.slices)
    else:
        assert (plan.chunk, plan.sub) == (n, tvt.SUB_ROWS)
    assert plan.tile == plan.slices * plan.sub
    assert plan.smem_bytes <= tvt.MAX_SMEM
    assert np.all(_coverage(plan, b, n, e, untied) == 1)


@pytest.mark.parametrize('untied', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', _loop_shapes())
def test_small_b_plan_fills_the_card(shape, dtype, untied):
    """A split grid holds at most the card's SMs and, where it splits, at
    least SPLIT_FILL times its unsplit blocks' worth (the split ran into
    neither the cluster limit nor the rows); an unsplit one either fills a
    quarter of the SMs or has too few rows to split."""
    b, n, d, e = shape
    sms = tvt.H100_SMS
    plan = (tvt.rw_untied_plan(b, n, d, e, dtype, sms) if untied
            else tvt.rw_tied_plan(b, n, n, d, e, dtype, sms))
    blocks = int(np.prod(plan.grid))
    unsplit = blocks // plan.split
    assert blocks <= sms or plan.split == 1
    if plan.split == 1:
        assert unsplit * tvt.SPLIT_FILL > sms or n < 2 * tvt.SPLIT_ROWS
    else:
        assert unsplit * tvt.SPLIT_FILL <= sms


def test_design_examples():
    """The plans the design was sized for (f64, the precision policy): K2 at
    the swing-up's (1, 512, 3, 2) runs 8 row tiles x 2 outputs x 8 ranks of
    64 rows, 16 pair steps a thread; K1 at the integrator's (1, 128, 2, 1)
    one scenario a block over 8 ranks, and no split on a card of 7 SMs."""
    f64 = torch.float64
    k2 = tvt.rw_untied_plan(1, 512, 3, 2, f64)
    assert (k2.scenarios, k2.split, k2.grid, k2.chunk, k2.sub) == (
        1, 8, (64, 1, 2), 64, 16)
    assert int(np.prod(k2.grid)) == 128
    k1 = tvt.rw_tied_plan(1, 128, 128, 2, 1, f64)
    assert (k1.scenarios, k1.split, k1.grid) == (1, 8, (16, 1))
    assert tvt.rw_tied_plan(1, 128, 128, 2, 1, f64, sms=7).split == 1


def _before(b, n_out, n_c, d, e, dtype):
    """The plan of K1's body before the small-B plan: S_max scenarios a
    block at any B, no split, tiles of SLICES * SUB_ROWS rows, grid
    (ceil(n_out / ROWS), ceil(B / S_max))."""
    s = tvt.rw_scenarios(d, e, dtype)
    return dict(scenarios=s, split=1, tile=tvt.SLICES * tvt.SUB_ROWS,
                chunk=n_c, sub=tvt.SUB_ROWS,
                smem_bytes=tvt._rw_smem(d, e, dtype, s),
                grid=(-(-n_out // tvt.ROWS), -(-b // s)))


def _unchanged():
    shapes = [HEADLINE, CONFIG_3B] + [(b, 256, 3, 2) for b in RECIPE_WIDTHS]
    return [(s, dt) for s in shapes for dt in DTYPES]


@pytest.mark.parametrize('shape,dtype', _unchanged())
def test_large_b_plans_unchanged(shape, dtype):
    b, n, d, e = shape
    plan = tvt.rw_tied_plan(b, n, n, d, e, dtype)._asdict()
    want = _before(b, n, n, d, e, dtype)
    assert {k: plan[k] for k in want} == want


@pytest.mark.parametrize('dtype', DTYPES)
def test_untied_headline_plan_unchanged(dtype):
    """K2 at the untied headline: what one of its E launches at E = 1 was,
    now with the outputs on grid.z, and the contraction rows' dv staged
    beside ao (one more row of shared memory a staged tile)."""
    b, n, d, e = HEADLINE
    plan = tvt.rw_untied_plan(b, n, d, e, dtype)._asdict()
    want = _before(b, n, n, d, 1, dtype)
    want['grid'] = want['grid'] + (e,)
    want['smem_bytes'] = tvt._rw_smem(d, 1, dtype, want['scenarios'],
                                      untied=True)
    assert {k: plan[k] for k in want} == want
    assert want['smem_bytes'] - tvt._rw_smem(d, 1, dtype, want['scenarios']) \
        == 2 * want['scenarios'] * want['tile'] * (8 if dtype == torch.float64
                                                   else 4)


def _operands(rng, b, n, d, e, n_valid, untied):
    """The JAX kernel test's inputs at capacity n with n_valid valid rows
    (x and blam zero outside), prepped in f64 as the traces prep them."""
    u = rng.normal(size=(b, d))
    m = rng.normal(size=(b, d, d) if not untied else (b, e, d, d))
    m2 = m @ np.swapaxes(m, -1, -2) * 0.1 + np.eye(d)
    x = rng.normal(size=(n, d))
    br = rng.normal(size=(e, n, n)) * 0.003
    blam = br + np.swapaxes(br, -1, -2)
    x[n_valid:] = 0.0
    blam[:, n_valid:] = 0.0
    blam[:, :, n_valid:] = 0.0
    f = lambda v: torch.tensor(v, dtype=torch.float64)
    if untied:
        a, g, dv = tvt._prep_batched(f(u), f(m2), f(x))
        return g, dv, a, tvt._aug(a), f(blam)
    a, g, dv = tvt._prep_tied(f(u), f(m2), f(x))
    return g, dv, a, tvt._aug(a) * dv[..., None], f(blam)


@pytest.mark.parametrize('untied', [False, True])
@pytest.mark.parametrize('shape', _loop_shapes())
def test_split_sum_matches_unsplit_plain_version(shape, untied):
    """The split sum's plain version, under the f64 plan at the shape,
    against the unsplit plain version: rtol 1e-14 of |rw| plus 1e-14 of
    the terms' magnitude sum (rw cancels where blam changes sign)."""
    b, n, d, e = shape
    n_valid = {128: 100, 512: 320}[n]
    args = _operands(np.random.default_rng(n + 10 * d + b), b, n, d, e,
                     n_valid, untied)
    f64 = torch.float64
    if untied:
        plan = tvt.rw_untied_plan(b, n, d, e, f64)
        got = tvt.rw_untied_split_reference(*args, plan)
        want = tvt.rw_untied_reference(*args)
        mag = tvt.rw_untied_reference(args[0], args[1], args[2],
                                      args[3].abs(), args[4].abs())
    else:
        plan = tvt.rw_tied_plan(b, n, n, d, e, f64)
        got = tvt.rw_split_reference(*args, plan)
        want = tvt.rw_tied_reference(*args)
        mag = tvt.rw_tied_reference(args[0], args[1], args[2], args[3].abs(),
                                    args[4].abs())
    assert got.shape == want.shape == (b, e, n, d + 1)
    err = (got - want).abs()
    bar = 1e-14 * want.abs() + 1e-14 * mag
    assert bool((err <= bar).all()), float((err / bar).max())
    assert bool((got[:, :, n_valid:] == 0).all())


def test_split_sum_adds_ranks_in_order():
    """At a split of 3 the plain version is ((P0 + P1) + P2) dv, each Pr the
    unscaled sum over rank r's rows: not the sum in another order to the
    bit, on operands whose order shows in the last bit."""
    rng = np.random.default_rng(3)
    b, n, d, e = 1, 48, 2, 1
    g, dv, a, aod, blam = _operands(rng, b, n, d, e, n, False)
    plan = tvt.rw_tied_plan(b, n, n, d, e, torch.float64, sms=12)
    assert (plan.split, plan.chunk) == (3, 16)
    parts = [tvt.rw_tied_reference(g, torch.ones_like(dv), a[:, sl],
                                   aod[:, sl], blam[:, sl])
             for sl in (slice(0, 16), slice(16, 32), slice(32, 48))]
    want = dv[:, None, :, None] * ((parts[0] + parts[1]) + parts[2])
    got = tvt.rw_split_reference(g, dv, a, aod, blam, plan)
    assert torch.equal(got, want)
    other = dv[:, None, :, None] * (parts[0] + (parts[1] + parts[2]))
    assert not torch.equal(got, other)
