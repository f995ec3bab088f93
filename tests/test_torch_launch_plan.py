"""The launch plans of K1's body (K1, K2, K3) and of K4 on the CPU: every
(scenario, output row) and every contraction row falls in exactly one
block's share, within the card's limits (threads, 227 KB of shared memory,
grid.y); what the kernels cannot take raises. And K1's summation order (the
contraction slices' partials, then their fixed-order sum, then the split
ranks' sum in rank order) transcribed in numpy f32, held to the f64 oracle on the headline operands at chip_smoke's
bar. The compiled plan is checked against these on the card when a library
loads (ops/kernels/variance_trace.py, _check_plan)."""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.benchmarks.chain import kernel_args
from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.ops.kernels import variance_trace as tvt
from gpmpc_tpu_torch.problems import headline_operands, make_headline_problem

torch.set_num_threads(1)
DTYPES = [torch.float32, torch.float64]
BS = (1, 3, 7, 256, 257)
NS = (1, 130, 200, 256, 1000)
MAX_THREADS_CARD = 1024
SMEM_CARD = 232448
GRID_Y_CARD = 65535


def _cover(extent, block, blocks):
    """How often each index of [0, extent) falls in block j's
    [j block, (j + 1) block), j < blocks."""
    idx = np.arange(blocks)[:, None] * block + np.arange(block)[None]
    return np.bincount(idx[idx < extent], minlength=extent)


def _slices_cover(n_c, plan):
    """How often each contraction row falls in a slice's rows: rank r of
    the plan's split takes [r chunk, (r+1) chunk), in tiles of slices * sub
    rows, and tile j0 gives slice k its rows [j0 + k sub, j0 + (k+1) sub)
    within the tile."""
    tile = plan.slices * plan.sub
    hits = np.zeros(n_c, int)
    for r in range(plan.split):
        jend = min(n_c, (r + 1) * plan.chunk)
        for j0 in range(r * plan.chunk, jend, tile):
            jn = min(tile, jend - j0)
            for k in range(plan.slices):
                hits[j0 + k * plan.sub:j0 + min((k + 1) * plan.sub, jn)] += 1
    return hits


@pytest.mark.parametrize('d', range(1, tvt.MAX_D + 1))
@pytest.mark.parametrize('dtype', DTYPES)
def test_rw_tied_plan_covers_every_row_once(dtype, d):
    for e in range(1, tvt.MAX_E + 1):
        for b in BS:
            for n_out in NS:
                for n_c in NS:
                    p = tvt.rw_tied_plan(b, n_out, n_c, d, e, dtype)
                    assert p.threads == p.rows * p.slices <= MAX_THREADS_CARD
                    assert p.rows % 32 == 0
                    assert p.smem_bytes <= SMEM_CARD
                    assert p.grid[1] <= GRID_Y_CARD
                    assert 1 <= p.scenarios <= min(4, b)
                    assert np.all(_cover(b, p.scenarios, p.grid[1]) == 1)
                    assert p.grid[0] % p.split == 0
                    assert np.all(_cover(n_out, p.rows,
                                         p.grid[0] // p.split) == 1)
                    assert np.all(_slices_cover(n_c, p) == 1)
                    assert p.tile == p.slices * p.sub <= (p.slices
                                                          * tvt.SUB_ROWS)


@pytest.mark.parametrize('d', range(1, tvt.MAX_D + 1))
@pytest.mark.parametrize('dtype', DTYPES)
def test_rw_sym_plan_covers_every_pair_and_slot_once(dtype, d):
    for e in range(1, tvt.MAX_E + 1):
        for shared in (True, False):
            for b in BS:
                for n in NS:
                    p = tvt.rw_sym_plan(b, n, d, e, dtype, shared)
                    assert p.threads == tvt.SYM_THREADS <= MAX_THREADS_CARD
                    assert p.smem_bytes <= SMEM_CARD
                    assert max(p.grid[1], p.sum_grid[1]) <= GRID_Y_CARD
                    assert np.all(_cover(b, p.scenarios, p.grid[1]) == 1)
                    nt = p.n_tiles
                    assert nt * tvt.SYM_TILE >= n > (nt - 1) * tvt.SYM_TILE
                    ii, jj = tvt._pair_indices(nt)
                    assert p.grid[0] == len(ii)
                    # part[b, R, K] is written by the column sum of pair
                    # (R, K) when R <= K, by the row sum of (K, R) when R > K.
                    slots = np.zeros((nt, nt), int)
                    for i, j in zip(ii, jj):
                        assert i <= j
                        slots[i, j] += 1
                        if i != j:
                            slots[j, i] += 1
                    assert np.all(slots == 1)


@pytest.mark.parametrize('case', ['grid_y', 'd0', 'e0', 'd9', 'e9', 'dtype'])
def test_rw_tied_plan_raises_instead_of_adjusting(case):
    args = dict(b=4, n_out=64, n_c=64, d=3, e=2, dtype=torch.float32)
    err = ValueError
    if case == 'grid_y':
        args['b'] = GRID_Y_CARD * tvt.rw_scenarios(3, 2, torch.float32) + 1
    elif case in ('d0', 'e0', 'd9', 'e9'):
        args[case[0]] = int(case[1])
    else:
        args['dtype'], err = torch.float16, TypeError
    with pytest.raises(err):
        tvt.rw_tied_plan(**args)


def test_rw_sym_plan_raises_past_the_grid():
    with pytest.raises(ValueError):
        tvt.rw_sym_plan(GRID_Y_CARD + 1, 64, 3, 2, torch.float32, True)


def test_headline_plans():
    """The plans chip_smoke.py states: K1 at B = N = 256, d = 3, E = 2 in
    f32 serves 4 scenarios a block of 64 rows x 4 slices; K4 4 scenarios
    tied and 3 per output, in 128 threads and under 46 KB."""
    p = tvt.rw_tied_plan(256, 256, 256, 3, 2, torch.float32)
    assert (p.rows, p.slices, p.scenarios, p.threads, p.grid) == (
        64, 4, 4, 256, (4, 64))
    assert tvt.rw_tied_plan(256, 256, 256, 3, 2, torch.float64).scenarios == 2
    assert tvt.rw_tied_plan(1, 1, 1, 8, 8, torch.float64).scenarios == 1
    tied = tvt.rw_sym_plan(256, 256, 3, 2, torch.float32, True)
    per = tvt.rw_sym_plan(256, 256, 3, 2, torch.float32, False)
    assert (tied.scenarios, per.scenarios) == (4, 3)
    assert tied.grid == (10, 64) and per.grid == (10, 86)
    assert max(tied.smem_bytes, per.smem_bytes) < 46 * 1024


def _k1_order_np(g, dv, a, aod, blam, plan):
    """numpy f32 transcription of K1's sums under `plan`: rank r of the
    split takes the rows [r chunk, (r+1) chunk), staged in tiles of
    slices * sub rows; slice k of each tile takes the rows
    [j0 + k sub, j0 + (k+1) sub) and accumulates (blam w) aod[c] over them
    in row order (a multiply and an add where the card fuses them); the
    slices' partials are summed k = 0 .. slices-1, the ranks' sums
    r = 0 .. split-1, and the total scaled by dv. g (B, Nout, d),
    dv (B, Nout), a (B, Nc, d), aod (B, Nc, 1+d), blam (E, Nc, Nout) -> rw
    (B, E, Nout, 1+d)."""
    f32 = np.float32
    b, n_out, d = g.shape
    e, n_c, _ = blam.shape
    ranks = []
    for r in range(plan.split):
        jend = min(n_c, (r + 1) * plan.chunk)
        parts = np.zeros((plan.slices, b, e, n_out, d + 1), f32)
        for j0 in range(r * plan.chunk, jend, plan.tile):
            for k in range(plan.slices):
                for j in range(j0 + k * plan.sub,
                               min(j0 + (k + 1) * plan.sub, jend)):
                    p = np.zeros((b, n_out), f32)
                    for kk in range(d):
                        p = p + a[:, j, kk][:, None] * g[:, :, kk]
                    w = np.exp(f32(-0.25) * p)
                    for ee in range(e):
                        bw = blam[ee, j][None] * w
                        parts[k, :, ee] += bw[..., None] * aod[:, j][:, None, :]
        block = parts[0]
        for k in range(1, plan.slices):
            block = block + parts[k]
        ranks.append(block)
    total = ranks[0]
    for block in ranks[1:]:
        total = total + block
    return dv[:, None, :, None] * total


def test_k1_summation_order_meets_the_bar_on_headline_operands():
    """The order of the kernel's sums in f32 on the headline GP's x and b_lam
    (whose trace cancels) against the plain f64 trace, at chip_smoke.py's
    bar |t - t64| <= 5e-5 |t64| + 16 eps32 mag, mag the terms' magnitude
    sum; and the order matters: it is not the plain einsum's to the bit."""
    b = 3
    cache = build_rollout_cache(
        make_headline_problem(b=2, device='cpu').gp, 2, 1)
    u, m2, x, blam = headline_operands(np.random.default_rng(4), b, cache)
    args32 = kernel_args(*(t.float() for t in (u, m2, x, blam)))
    n, d = x.shape
    plan = tvt.rw_tied_plan(b, n, n, d, blam.shape[0], torch.float32)
    rw = _k1_order_np(*(t.numpy() for t in args32), plan)
    t32 = rw[..., 0].sum(axis=-1, dtype=np.float32).astype(np.float64)
    ref = tvt.variance_trace_batched_tied_reference
    t64 = ref(u, m2, x, blam).numpy()
    mag = ref(u, m2, x, blam.abs()).numpy()
    bar = 5e-5 * np.abs(t64) + 16 * np.finfo(np.float32).eps * mag
    assert np.all(np.abs(t32 - t64) <= bar), np.max(np.abs(t32 - t64) / bar)
    plain = tvt.rw_tied_reference(*args32).numpy()
    assert not np.array_equal(rw, plain)
