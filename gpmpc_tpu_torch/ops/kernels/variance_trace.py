"""The uncertain-input variance trace and its CUDA kernels (K1-K4).

Port of gpmpc_tpu/ops/pallas/variance_trace.py. The per-rollout-step hot tile
is, for each scenario b with a = u_b - x (N, d), g = a M2_b, q_i = g_i . a_i and
dv = exp(-q / 8),

    t[b, e] = sum_ij blam_e[i, j] dv_i dv_j exp(-1/4 g_i . a_j).

The kernel's only job is the O(N^2) chain reduced against the augmented matrix
AO = [1 | a] (the "rw" contract):

    rw[b, e, i, c] = dv_i sum_j blam[e, j, i] exp(-1/4 a_j . g_i) (dv o AO)[j, c]

so t = sum_i rw[..., 0], and the backward needs only rw and O(N d) tensor
work (derived for SYMMETRIC blam and M2, always true here):

    z0 = A^T r,  zs = A^T (W A + diag(r) A),  dt/du = -M2 z0,  dt/dM2 = -1/4 zs.

`rw_tied` launches the hand-written CUDA kernel
(csrc/variance_trace_tied.cu) for CUDA tensors and takes the plain PyTorch
version `rw_tied_reference` only for CPU tensors; there is no fallback from
one to the other. The untied form (K2, `rw_untied`) is the same body in its
untied mode: one launch a trace computes all E outputs, each block one
output's chain, where the JAX package launches K1 at E = 1 once per output.
The row block of the model-sharded path (K3, `rw_tied_block`) is the same
kernel again on a rectangle: this shard's rows against all N contraction
rows. Each launch follows `rw_tied_plan` (K1, K3) or `rw_untied_plan` (K2):
blocks of ROWS output rows for S scenarios (S_max, or 1 where B < S_max),
the contraction split over SLICES warp rows (csrc/rw_tied_body.cuh, where
the block shape is a constexpr) and, where the grid would fill at most a
quarter of the card's SMs, over a cluster of `split` blocks whose partials
are added in rank order (`rw_split_reference` is that sum's plain version).
The library's block shape, S, shared bytes and plans are checked against
the wrapper's when it is loaded. A tied f64 launch (K1, K3) takes the route
of `rw_tied_body`: where its grid at S_max scenarios a block holds a block
for every SM, the f64 tensor-core body (csrc/rw_tied_f64_body.cuh: the
exponent and the contraction as f64 mma.sync, plan `rw_tied_mma_plan`, the
order of its sums emulated by `rw_tied_mma_reference`), else the body
above.

K1's grouped form (blam (G, E, Nc, Nout), one slab a group of B / G
consecutive scenarios: the trace under torch.func.vmap over one GP a lane;
csrc/variance_trace_grouped.cu, f64 operands) takes the slab at the width
it is stored at, f32 or f64, and widens each element in a register
(`rw_tied_grouped_plan`): a block is up to `group_sets(d, E)` scenario sets
of one scenario each, so that the recipe's five a group fill one block,
the slab read once a launch; in the tensor-core body staged once a block
by 16-byte copies.

The symmetric-pair kernel (K4, csrc/variance_trace_sym.cu, `rw_sym`) is the
JAX package's opt-in GPMPC_SYM_KERNEL=1: the exponent in the whitened form
z = a chol(M2), so that W is bit-symmetric, and only the tile pairs I <= J
visited. With the opt-in on, tied traces take its shared-chain variant and
untied traces its per-output variant (one launch for all E); the backward is
unchanged, since it needs only rw. A shape K4 cannot take raises; it never
falls back to K1. Its launch follows `rw_sym_plan` (S scenarios a block of
SYM_THREADS threads), checked against the library's at load as K1's.

Precision policy: every trace is evaluated in f64 whatever the operands'
dtype. The trace cancels (on the headline GP its terms sum to 1e3-1e6 times
the result), so any f32 evaluation of it, the kernel's or the plain one's,
costs the solver its quality (PERF.md, fault F1). The f32 operands are
upcast, the prep, the kernel's f64 instance, the row sum and the analytic
backward run in f64, and only t and the cotangents (du, dm2) are rounded to
the operands' dtype; the row block's partial stays f64 until the caller has
summed it over the model ranks. `native=True` evaluates a trace in its
operands' own dtype instead (the f32 instances' checks and the diagnostics
that measure what f32 arithmetic costs); no solver path passes it.
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import NamedTuple

import numpy as np
import torch

from gpmpc_tpu_torch.ops.kernels import _build
from gpmpc_tpu_torch.utils import replay_counts
from gpmpc_tpu_torch.utils.smallchol import chol_small

# Kernel launches, counted where they happen (tied K1, untied K2, the row
# block K3, the symmetric pairs K4), so a run can show that it went through
# the kernel. LAUNCHES_F64 counts those of K1's launches that ran its f64
# instance (all of them on the solver's paths, by the precision policy).
LAUNCHES = 0
LAUNCHES_F64 = 0
LAUNCHES_UNTIED = 0
LAUNCHES_BLOCK = 0
LAUNCHES_SYM = 0
# Of K3's launches, those of K1's f64 instance (a graph's nodes count them
# as K1 f64's: `_as_nodes`).
LAUNCHES_BLOCK_F64 = 0
_COUNTERS = ('LAUNCHES', 'LAUNCHES_F64', 'LAUNCHES_UNTIED', 'LAUNCHES_BLOCK',
             'LAUNCHES_SYM', 'LAUNCHES_BLOCK_F64')
# Of K1's launches, those of its grouped form (one blam a group of
# scenarios). The grouped form is K1's own kernel, so a graph's nodes count
# its launches in LAUNCHES and LAUNCHES_F64; this count is a tally of the
# wrapper's calls (utils/replay_counts.register), which a replay repeats.
LAUNCHES_GROUPED = 0


_TIED_FN = re.compile(r'rw_tied_kernel(?:I([fd])|<(float|double),)')
_BOOL_ARG = re.compile(r'Lb([01])E|\b(true|false)\b')


def _add_launches(delta) -> None:
    for name, n in delta.items():
        globals()[name] += n


def graph_counters(name: str) -> tuple:
    """The counters that a launch of the kernel function `name` (as a CUDA
    graph's node names it, mangled or not) counts in: K1's tied body
    (rw_tied_kernel<T, ..., Untied = false, ...>) LAUNCHES, and
    LAUNCHES_F64 for T = double and for its tensor-core body
    (rw_tied_mma_kernel); K2, the same template with Untied = true (its
    first bool argument), LAUNCHES_UNTIED; K4's pair kernel LAUNCHES_SYM;
    any other kernel (). K1's grouped form is K1's kernel and counts as K1.
    K3 launches K1's kernel, so its nodes count as K1's too; `_as_nodes`
    counts its wrapper's launches so for the capture's check, and a replay
    adds to LAUNCHES_BLOCK what the wrapper counted."""
    if 'rw_tied_mma_kernel' in name:
        return ('LAUNCHES', 'LAUNCHES_F64')
    m = _TIED_FN.search(name)
    if m:
        untied = _BOOL_ARG.search(name, m.end())
        if untied is not None and (untied.group(1) or untied.group(2)) in (
                '1', 'true'):
            return ('LAUNCHES_UNTIED',)
        f64 = (m.group(1) or m.group(2)[0]) == 'd'
        return ('LAUNCHES', 'LAUNCHES_F64') if f64 else ('LAUNCHES',)
    if 'rw_sym_pair_kernel' in name:
        return ('LAUNCHES_SYM',)
    return ()


def _as_nodes(counts) -> dict:
    """The wrappers' launch counts as a graph's kernel nodes count them
    (graph_counters): K3's (LAUNCHES_BLOCK) as K1's, its f64 ones
    (LAUNCHES_BLOCK_F64) also as K1 f64's."""
    out = {k: n for k, n in counts.items()
           if k not in ('LAUNCHES_BLOCK', 'LAUNCHES_BLOCK_F64')}
    for k, n in (('LAUNCHES', counts.get('LAUNCHES_BLOCK', 0)),
                 ('LAUNCHES_F64', counts.get('LAUNCHES_BLOCK_F64', 0))):
        out[k] = out.get(k, 0) + n
    return out


# A launch captured in a CUDA graph counts once per replay, checked against
# the graph's own kernel nodes (utils/replay_counts.py).
replay_counts.register_kernels(
    lambda: {name: globals()[name] for name in _COUNTERS}, _add_launches,
    graph_counters, _as_nodes)
replay_counts.register(lambda: {'LAUNCHES_GROUPED': LAUNCHES_GROUPED},
                       _add_launches)

MAX_D = 8
MAX_E = 8
_MAX_GRID_Y = 65535     # grid.y of a launch: ceil(B / S)
# Each dtype's instances are a library of their own (csrc/<name>.cu), built
# side by side; its C functions end in the suffix.
_LIB = {torch.float32: 'variance_trace_tied',
        torch.float64: 'variance_trace_tied_f64'}
_FN = {torch.float32: 'f32', torch.float64: 'f64'}

# ------------------------------------------------------ K1's launch plan --
# The constexprs of csrc/rw_tied_body.cuh, checked against its exports.
ROWS = 64               # kRows: output rows a block (blockDim.x)
SLICES = 4              # kSlices: contraction slices a block (blockDim.y)
SUB_ROWS = 32           # kSubRows: contraction rows a slice takes from each
                        # staged tile
MAX_SPLIT = 8           # kMaxSplit: blocks of a cluster (the portable limit)
SPLIT_ROWS = 16         # kSplitRows: the fewest contraction rows a rank takes
SPLIT_FILL = 4          # kSplitFill: split only where blocks * 4 <= SMs
MAX_SMEM = 232448       # dynamic shared memory a block may have (227 KB)
H100_SMS = 132          # SMs of an H100 SXM, the plans' default card


class RwPlan(NamedTuple):
    rows: int           # output rows a block
    slices: int         # contraction slices a block
    scenarios: int      # S: scenarios a block, sharing each blam load
    threads: int        # rows * slices
    tile: int           # contraction rows staged a step: slices * sub
    smem_bytes: int     # dynamic shared memory of a block
    grid: tuple         # (ceil(n_out / rows) * split, ceil(B / S)); K2 adds
                        # E, the outputs' axis
    split: int          # blocks the contraction is split over (1: none)
    cluster: tuple      # the thread-block cluster: (split, 1, 1)
    chunk: int          # contraction rows a rank takes (n_c at split 1)
    sub: int            # contraction rows a slice takes from each tile


def _itemsize(dtype) -> int:
    return 8 if dtype == torch.float64 else 4


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _scenarios(words: int) -> int:
    """Scenarios a block whose accumulators take `words` 32-bit registers
    per scenario: as many as stay within ~48 registers, 1 to 4."""
    return max(1, min(4, 48 // words))


def rw_scenarios(d: int, e: int, dtype) -> int:
    """S_max of K1's body (`scenarios<T, D, E>()`): g (d) and the
    accumulators (E (1+d)) of one scenario, in 32-bit words. K2's is the
    one at E = 1 (one output's chain a block)."""
    return _scenarios(_itemsize(dtype) // 4 * (d + e * (d + 1)))


def _rw_smem(d, e, dtype, s, untied=False, rows=ROWS) -> int:
    """`smem_bytes` of csrc/rw_tied_body.cuh: two staging buffers of a tile
    of a and aod (rows padded to 4; untied also the rows' dv) or the
    slices' partials, whichever is larger."""
    stage = 2 * s * SLICES * SUB_ROWS * (_pad4(d) + _pad4(d + 1) + int(untied))
    red = SLICES * s * e * (d + 1) * (rows + 1)
    return _itemsize(dtype) * max(stage, red)


def _groups(b, group, s) -> int:
    """Blocks of grid.y of B scenarios at S a block in groups of `group`
    (None: one group of all B), no block spanning two groups
    (`scenario_blocks`: the route's count of a grouped launch)."""
    group = group or b
    return -(-b // group) * -(-group // s) if group else 0


def _plan(b, n_out, n_c, d, e, outs, dtype, sms, untied,
          max_split=MAX_SPLIT) -> RwPlan:
    """`plan_of` of csrc/rw_tied_body.cuh, for e outputs a block and `outs`
    on the grid: S = S_max where B >= S_max, else 1; where the (row tiles x
    scenario blocks x outs) blocks fill at most 1 / SPLIT_FILL of the `sms`
    SMs, the contraction split over up to max_split ranks of at least
    SPLIT_ROWS rows, each rank's rows a multiple of SLICES, staged in tiles
    of SLICES * sub rows."""
    s_max = rw_scenarios(d, e, dtype)
    s = s_max if b >= s_max else 1
    tiles = -(-n_out // ROWS)
    groups = _groups(b, None, s)
    blocks = tiles * groups * outs
    split = 1
    if 0 < blocks and blocks * SPLIT_FILL <= sms:
        split = max(1, min(sms // blocks, max_split, n_c // SPLIT_ROWS))
    chunk, sub = n_c, SUB_ROWS
    if split > 1:
        chunk = -(-(-(-n_c // split)) // SLICES) * SLICES
        split = -(-n_c // chunk)
        sub = min(SUB_ROWS, chunk // SLICES)
    grid = (tiles * split, groups) + ((outs,) if untied else ())
    return RwPlan(ROWS, SLICES, s, ROWS * SLICES, SLICES * sub,
                  _rw_smem(d, e, dtype, s, untied), grid, split, (split, 1, 1),
                  chunk, sub)


def _check_dims(d, e, dtype):
    if not (1 <= d <= MAX_D and 1 <= e <= MAX_E):
        raise ValueError(f'rw kernel supports d <= {MAX_D}, E <= {MAX_E}; '
                         f'got d={d}, E={e}')
    if dtype not in _FN:
        raise TypeError(f'rw kernel takes float32 or float64, got {dtype}')


def _check_grid(plan: RwPlan, b) -> RwPlan:
    if plan.smem_bytes > MAX_SMEM or plan.grid[1] > _MAX_GRID_Y:
        raise ValueError(f'rw kernel: B={b} at {plan.scenarios} scenarios a '
                         f'block needs grid.y {plan.grid[1]} (at most '
                         f'{_MAX_GRID_Y}) and {plan.smem_bytes} shared bytes '
                         f'(at most {MAX_SMEM})')
    return plan


def rw_tied_plan(b, n_out, n_c, d, e, dtype, sms=H100_SMS) -> RwPlan:
    """The launch of K1's body for K1 and K3: B scenarios, n_out output rows
    and n_c contraction rows on a card of `sms` SMs. Every (scenario, row)
    falls in exactly one block's (S scenarios) x (rows rows) for each of
    `split` ranks, and every contraction row in exactly one rank's chunk,
    the ragged edges masked. Raises on what the kernel cannot take, never
    adjusts."""
    _check_dims(d, e, dtype)
    return _check_grid(_plan(b, n_out, n_c, d, e, 1, dtype, sms, False), b)


def rw_untied_plan(b, n, d, e, dtype, sms=H100_SMS) -> RwPlan:
    """K2's launch: K1's body at one output a block (S_max of E = 1), the E
    outputs on grid.z, N rows against N. Raises as `rw_tied_plan`."""
    _check_dims(d, e, dtype)
    return _check_grid(_plan(b, n, n, d, 1, e, dtype, sms, True), b)


# ------------------------------------ K1's f64 tensor-core body and route --
# The constexprs of csrc/rw_tied_f64_body.cuh, checked against its exports.
MMA_STRIPS = 4          # kMmaStrips: row strips (warps of 16 rows) a block
MMA_ROWS = 64           # kMmaTileRows: output rows a block
MMA_CHUNK = 32          # kMmaChunk: contraction rows a staged chunk
MMA_THREADS = 32 * MMA_STRIPS


class MmaPlan(NamedTuple):
    scenarios: int      # S: scenarios a block, sharing each blam load
    grid: tuple         # (ceil(n_out / MMA_ROWS), ceil(B / S)), blocks of
                        # MMA_THREADS threads
    smem_bytes: int     # dynamic shared memory of a block
    ks: int             # k steps of the exponent: d padded to 4 or 8
    nt: int             # n tiles of the contraction: 1 + d padded to 8, 16


def _mma_ks(d: int) -> int:
    return 2 if d > 4 else 1


def _mma_nt(d: int) -> int:
    return 2 if d + 1 > 8 else 1


def rw_tied_mma_scenarios(d: int, e: int) -> int:
    """S_max of the tensor-core body (`mma_scenarios`): its accumulators,
    S E NT 4 doubles a thread, within 32; 1 to 8."""
    return max(1, 8 // (e * _mma_nt(d)))


def _mma_smem(s, d) -> int:
    """`mma_smem_bytes`: two staging buffers of a chunk of a (row stride 4
    or 12) and aod (8 NT + 2) for S scenarios."""
    return 8 * 2 * s * MMA_CHUNK * ((4 if _mma_ks(d) == 1 else 12)
                                    + 8 * _mma_nt(d) + 2)


def rw_tied_mma_plan(b, n_out, d, e) -> MmaPlan:
    """The launch of the f64 tensor-core body (csrc/rw_tied_f64_body.cuh,
    `mma_plan`) for B scenarios and n_out output rows (any n_c: each warp
    walks the whole contraction in chunks of MMA_CHUNK rows, steps of 8):
    S = S_max where B >= S_max, else 1. Every (scenario, row) falls in one
    block's S x MMA_ROWS. Raises on what the kernel cannot take."""
    _check_dims(d, e, torch.float64)
    s_max = rw_tied_mma_scenarios(d, e)
    s = s_max if b >= s_max else 1
    plan = MmaPlan(s, (-(-n_out // MMA_ROWS), -(-b // s)), _mma_smem(s, d),
                   _mma_ks(d), _mma_nt(d))
    if plan.smem_bytes > MAX_SMEM or plan.grid[1] > _MAX_GRID_Y:
        raise ValueError(f'rw kernel (f64 tensor cores): B={b} at '
                         f'{plan.scenarios} scenarios a block needs grid.y '
                         f'{plan.grid[1]} (at most {_MAX_GRID_Y}) and '
                         f'{plan.smem_bytes} shared bytes (at most '
                         f'{MAX_SMEM})')
    return plan


def rw_tied_body(b, n_out, n_c, d, e, dtype, sms=H100_SMS,
                 group=None) -> str:
    """The body a tied launch (K1, K3, K1 grouped in groups of `group`)
    runs (`tied_route` of csrc/rw_tied_f64_body.cuh): 'mma', the f64
    tensor-core body, where the operands are f64 and its grid at S_max
    scenarios a block holds at least one block for every SM; else
    'scalar', the body of csrc/rw_tied_body.cuh at `rw_tied_plan` (the f32
    instances, and f64 at the smaller grids, where the card measured it the
    faster)."""
    s_max = rw_tied_mma_scenarios(d, e)
    if dtype == torch.float64 and -(-n_out // MMA_ROWS) * _groups(
            b, group, s_max) >= sms:
        return 'mma'
    return 'scalar'


# ------------------------------------------------------ K1's grouped form --
# The constexprs of csrc/rw_tied_body.cuh's grouped form, checked against
# its exports.
GROUP_ROWS = 32         # kGroupRows: output rows a grouped block, scalar
MAX_SETS = 5            # kMaxSets: scenario sets a grouped block, at most


def group_sets(d: int, e: int) -> int:
    """Scenario sets a grouped block may hold at (d, E) (`group_sets`):
    one scenario a set, E NT 4 accumulator doubles a set within 40, 1 to
    MAX_SETS (5 at d = 3, E = 2)."""
    return max(1, min(MAX_SETS, 10 // (e * _mma_nt(d))))


class GroupPlan(NamedTuple):
    body: str           # 'mma' or 'scalar'
    sets: int           # scenario sets a block, one scenario each
    gblocks: int        # blocks a group takes on grid.y
    grid: tuple         # (row tiles, groups x gblocks)
    block: tuple        # (x, y, sets) threads
    smem_bytes: int     # dynamic shared memory of a block
    live: int           # scenarios of a group: live slots of its blocks
    slots: int          # gblocks x sets: slots of its blocks
    blam_bytes: int     # slab bytes read a launch (each element once)


def rw_tied_grouped_plan(b, n_out, n_c, d, e, group, dtype=torch.float64,
                         blam_dtype=None, body=None,
                         sms=H100_SMS) -> GroupPlan:
    """K1's grouped form (`mma_group_plan`, `group_plan_scalar`; f64
    operands, csrc/variance_trace_grouped.cu): B
    scenarios in groups of `group`, each group's in gblocks =
    ceil(group / group_sets(d, E)) blocks of sets = ceil(group / gblocks)
    scenario sets of one scenario, the group's slab (of blam_dtype, by
    default dtype) read once by each row tile of its blocks. In the body of
    `rw_tied_body` (body None) or the one named: the tensor-core body (f64
    operands) at MMA_ROWS rows and 4 warps a set, the slab staged in shared
    memory (two chunks, or one where two do not fit: an f64 slab at E >= 7;
    row stride 66 doubles or 68 floats), or the scalar
    body at GROUP_ROWS rows x SLICES a set, each set its S = 1 buffers.
    Raises on what the kernel cannot take."""
    _check_dims(d, e, dtype)
    if dtype != torch.float64:
        raise TypeError(f'rw kernel: the grouped form takes f64 operands '
                        f'(the precision policy), got {dtype}')
    if not (group >= 1 and b >= 1 and b % group == 0 and n_out >= 1):
        raise ValueError(f'rw kernel: B = {b} in groups of {group}')
    body = body or rw_tied_body(b, n_out, n_c, d, e, dtype, sms, group=group)
    gblocks = -(-group // group_sets(d, e))
    sets = -(-group // gblocks)
    bsz = _itemsize(blam_dtype or dtype)
    if body == 'mma':
        rows, block = MMA_ROWS, (32, MMA_STRIPS, sets)
        # Two staged chunks of the slab where they fit beside the most sets'
        # buffers and the exp table (1 KB), else one (`mma_blam_bufs`).
        chunk = e * MMA_CHUNK * (MMA_ROWS + (2 if bsz == 8 else 4)) * bsz
        bufs = 2 if (2 * chunk + group_sets(d, e) * _mma_smem(1, d) + 1024
                     <= MAX_SMEM) else 1
        smem = bufs * chunk + sets * _mma_smem(1, d)
    else:
        rows, block = GROUP_ROWS, (GROUP_ROWS, SLICES, sets)
        smem = sets * _rw_smem(d, e, dtype, 1, rows=GROUP_ROWS)
    plan = GroupPlan(body, sets, gblocks, (-(-n_out // rows),
                                           b // group * gblocks),
                     block, smem, group, gblocks * sets,
                     b // group * e * n_c * n_out * bsz)
    if plan.smem_bytes > MAX_SMEM or plan.grid[1] > _MAX_GRID_Y:
        raise ValueError(f'rw kernel (grouped): B={b} in groups of {group} '
                         f'needs grid.y {plan.grid[1]} (at most {_MAX_GRID_Y})'
                         f' and {plan.smem_bytes} shared bytes (at most '
                         f'{MAX_SMEM})')
    return plan


# The shapes whose plans are compared with the library's at load: the
# solve's lane counts, the closed loop's, suite config 3's capacity (1,024),
# ragged edges and split corners, on an H100's SM count and a small card's.
_PLAN_CHECK_B = (1, 2, 3, 5, 7, 64, 256, 257)
_PLAN_CHECK_N = (1, 17, 100, 128, 130, 256, 512, 1024)
_PLAN_CHECK_DE = ((1, 1), (2, 1), (3, 2), (4, 2), (5, 4), (8, 8))
_PLAN_CHECK_SMS = (H100_SMS, 16)
# K1's grouped form: groups of one scenario, of fewer than S_max, of the
# multistart recipe's five (four starts and the warm one) and of more.
_PLAN_CHECK_GROUP = (1, 2, 5, 9)


def _check_plan(lib, prefix, want):
    """Raise unless the library's compiled plan equals the wrapper's: `want`
    maps an exported function's name and arguments to the wrapper's
    value."""
    for (name, *args), value in want.items():
        fn = getattr(lib, f'{prefix}_{name}')
        fn.restype = ctypes.c_longlong
        got = fn(*args)
        if got != value:
            raise RuntimeError(f'{prefix}_{name}{tuple(args)} is {got} in the '
                               f'compiled kernel, {value} in the wrapper')


def _plan_values(plan: RwPlan) -> list:
    """A plan as `gpmpc_rw_tied_plan_*` writes it: S, split, chunk, sub,
    grid x, y, z and the shared bytes."""
    grid = tuple(plan.grid) + (1,) * (3 - len(plan.grid))
    return [plan.scenarios, plan.split, plan.chunk, plan.sub, *grid,
            plan.smem_bytes]


def _check_launch_plans(lib, sfx, dtype):
    """Raise unless the library's `plan_of` equals `_plan` at the
    _PLAN_CHECK_* shapes, for K1 and K2."""
    fn = getattr(lib, f'gpmpc_rw_tied_plan_{sfx}')
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 8)()
    for b in _PLAN_CHECK_B:
        for n in _PLAN_CHECK_N:
            for d, e in _PLAN_CHECK_DE:
                for sms in _PLAN_CHECK_SMS:
                    for untied in (False, True):
                        want = _plan_values(
                            _plan(b, n, n, d, 1, e, dtype, sms, True)
                            if untied else
                            _plan(b, n, n, d, e, 1, dtype, sms, False))
                        args = (b, n, n, d, e, int(untied), sms)
                        if fn(*args, out) != 0 or list(out) != want:
                            raise RuntimeError(
                                f'gpmpc_rw_tied_plan_{sfx}{args} is '
                                f'{list(out)} in the compiled kernel, {want} '
                                'in the wrapper')


def _group_plan_values(plan: GroupPlan) -> list:
    """A grouped plan as `gpmpc_rw_tied_grouped_plan_*` writes it: sets,
    blocks a group, grid x, y, block x, y, z and the shared bytes."""
    return [plan.sets, plan.gblocks, *plan.grid, *plan.block,
            plan.smem_bytes]


def _check_grouped_plans(lib):
    """Raise unless the grouped library's plans (each body, each slab
    width) equal `rw_tied_grouped_plan` at groups of _PLAN_CHECK_GROUP, 1,
    3 and 256 groups, the _PLAN_CHECK_N rows and every (d, E)."""
    fn = lib.gpmpc_rw_tied_grouped_plan_f64
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 8)()
    cases = [(body, bdt) for body in ('scalar', 'mma')
             for bdt in (torch.float32, torch.float64)]
    for k in _PLAN_CHECK_GROUP:
        for b in (k, 3 * k, 256 * k):
            for n in _PLAN_CHECK_N:
                for d in range(1, MAX_D + 1):
                    for e in range(1, MAX_E + 1):
                        for body, bdt in cases:
                            want = _group_plan_values(rw_tied_grouped_plan(
                                b, n, n, d, e, k, torch.float64, bdt, body))
                            args = (_BODY[body], b, n, d, e, k,
                                    _itemsize(bdt))
                            if fn(*args, out) != 0 or list(out) != want:
                                raise RuntimeError(
                                    'gpmpc_rw_tied_grouped_plan_f64'
                                    f'{args} is {list(out)} in the compiled '
                                    f'kernel, {want} in the wrapper')


def _check_mma_plans(lib):
    """Raise unless the f64 library's tensor-core plan and route equal
    `rw_tied_mma_plan` and `rw_tied_body` at the _PLAN_CHECK_* shapes (and,
    at N = 512 and 1,024, at every (d, E)), the route also grouped."""
    fn = lib.gpmpc_rw_tied_mma_plan_f64
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    route = lib.gpmpc_rw_tied_route_f64
    route.restype = ctypes.c_longlong
    out = (ctypes.c_longlong * 4)()
    des = [(d, e) for d in range(1, MAX_D + 1) for e in range(1, MAX_E + 1)]
    for b in _PLAN_CHECK_B:
        for n in _PLAN_CHECK_N:
            for d, e in (des if n >= 512 else _PLAN_CHECK_DE):
                p = rw_tied_mma_plan(b, n, d, e)
                want = [p.scenarios, *p.grid, p.smem_bytes]
                if fn(b, n, d, e, out) != 0 or list(out) != want:
                    raise RuntimeError(
                        f'gpmpc_rw_tied_mma_plan_f64{(b, n, d, e)} is '
                        f'{list(out)} in the compiled kernel, {want} in the '
                        'wrapper')
                for group in (0, *_PLAN_CHECK_GROUP):
                    for sms in _PLAN_CHECK_SMS:
                        got = route(b, n, n, d, e, sms, group)
                        body = rw_tied_body(b, n, n, d, e, torch.float64, sms,
                                            group=group or None)
                        if got != int(body == 'mma'):
                            raise RuntimeError(
                                'gpmpc_rw_tied_route_f64'
                                f'{(b, n, n, d, e, sms, group)} is {got} in '
                                f'the compiled kernel, {body} in the wrapper')


def _kernel_fn(dtype, untied=False):
    """(launch, error string) of `dtype`'s library: K1's launch, or K2's
    when untied. The compiled plans (and, in f64, the tensor-core body's
    plan and the route) are checked against this module's when the library
    is first loaded."""
    sfx = _FN[dtype]
    lib = _build.load(_LIB[dtype])
    fn = getattr(lib, f'gpmpc_rw_tied_{sfx}')
    fn_u = getattr(lib, f'gpmpc_rw_untied_{sfx}')
    if fn.argtypes is None:
        want = {(f'rows_{sfx}',): ROWS, (f'slices_{sfx}',): SLICES,
                (f'sub_rows_{sfx}',): SUB_ROWS,
                (f'max_split_{sfx}',): MAX_SPLIT,
                (f'split_rows_{sfx}',): SPLIT_ROWS,
                (f'split_fill_{sfx}',): SPLIT_FILL}
        for d in range(1, MAX_D + 1):
            for e in range(1, MAX_E + 1):
                s = rw_scenarios(d, e, dtype)
                want[(f'scenarios_{sfx}', d, e)] = s
                want[(f'smem_{sfx}', d, e)] = _rw_smem(d, e, dtype, s)
        if dtype == torch.float64:
            want.update({('mma_rows_f64',): MMA_ROWS,
                         ('mma_chunk_f64',): MMA_CHUNK})
            for d in range(1, MAX_D + 1):
                for e in range(1, MAX_E + 1):
                    want[('mma_scenarios_f64', d, e)] = \
                        rw_tied_mma_scenarios(d, e)
        _check_plan(lib, 'gpmpc_rw_tied', want)
        _check_launch_plans(lib, sfx, dtype)
        if dtype == torch.float64:
            _check_mma_plans(lib)
        err_fn = getattr(lib, f'gpmpc_rw_tied_error_string_{sfx}')
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        fn_u.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
        fn_u.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return (fn_u if untied else fn,
            getattr(lib, f'gpmpc_rw_tied_error_string_{sfx}'))


_GROUPED_LIB = 'variance_trace_grouped'


def _grouped_fn():
    """(launch, error string) of K1's grouped form (its own library,
    csrc/variance_trace_grouped.cu), its constants and plans checked
    against this module's when the library is first loaded."""
    lib = _build.load(_GROUPED_LIB)
    fn = lib.gpmpc_rw_tied_grouped_f64
    if fn.argtypes is None:
        want = {('group_rows_f64',): GROUP_ROWS, ('max_sets_f64',): MAX_SETS}
        for d in range(1, MAX_D + 1):
            for e in range(1, MAX_E + 1):
                want[('group_sets_f64', d, e)] = group_sets(d, e)
        _check_plan(lib, 'gpmpc_rw_tied', want)
        _check_grouped_plans(lib)
        err_fn = lib.gpmpc_rw_tied_grouped_error_string_f64
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn, lib.gpmpc_rw_tied_grouped_error_string_f64


_sms: dict = {}


def device_sms(device) -> int:
    """The SM count of a CUDA device, which the launch plans read."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _contract(blam, w, aod):
    """sum_j blam[e, j, i] w[b, j, i] aod[b, j, c] -> (B, E, Nout, 1+d);
    blam (G, E, Nc, Nout) grouped: scenario b reads blam[b // (B / G)]."""
    if blam.ndim == 3:
        return torch.einsum('eji,bji,bjc->beic', blam, w, aod)
    g = blam.shape[0]
    rw = torch.einsum('geji,gkji,gkjc->gkeic', blam,
                      w.reshape(g, -1, *w.shape[1:]),
                      aod.reshape(g, -1, *aod.shape[1:]))
    return rw.reshape(-1, *rw.shape[2:])


def rw_tied_reference(g_out, dv_out, a, aod, blam):
    """Plain PyTorch version of the kernel: materialises the (B, Nc, Nout)
    exp chain. g_out (B, Nout, d); dv_out (B, Nout); a (B, Nc, d);
    aod (B, Nc, 1+d); blam (E, Nc, Nout) -> rw (B, E, Nout, 1+d)."""
    w = torch.exp(-0.25 * torch.einsum('bjk,bik->bji', a, g_out))
    return dv_out[:, None, :, None] * _contract(blam, w, aod)


def rw_tied_grouped_reference(g_out, dv_out, a, aod, blam):
    """Plain version of K1's grouped form: `rw_tied_reference` with one
    blam a group of scenarios, scenario b reading blam[b // (B / G)].
    Shapes as rw_tied_reference but blam (G, E, Nc, Nout), G dividing B,
    at its storage width (f32 or the operands'), widened first (exact)."""
    if blam.ndim != 4:
        raise ValueError(f'grouped blam is (G, E, Nc, Nout), got '
                         f'{tuple(blam.shape)}')
    return rw_tied_reference(g_out, dv_out, a, aod, blam.to(g_out.dtype))


def _split_parts(plan: RwPlan, n_c: int) -> list:
    """The contraction rows of each rank of `plan`, in rank order."""
    return [slice(r * plan.chunk, min(n_c, (r + 1) * plan.chunk))
            for r in range(plan.split)]


def rw_split_reference(g_out, dv_out, a, aod, blam, plan: RwPlan):
    """Plain version of K1's split sum under `plan` (rw_tied_plan): each
    rank's partial over its contraction rows, the partials added in rank
    order 0 .. split-1 as the kernel adds them, then scaled by dv. Shapes
    as `rw_tied_reference`, whose function it computes."""
    parts = [rw_tied_reference(g_out, torch.ones_like(dv_out), a[:, sl],
                               aod[:, sl], blam[..., sl, :])
             for sl in _split_parts(plan, a.shape[1])]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return dv_out[:, None, :, None] * total


def rw_tied_mma_reference(g_out, dv_out, a, aod, blam):
    """Plain version of the f64 tensor-core body's order: the exponent
    -g/4 . a summed over k in steps of 4 (the k steps of its MMAs); the
    contraction in steps of 8 rows in order, each step as its even rows and
    then its odd rows (the k indices t and t + 4 of the MMA that takes the
    thread's columns 2t and 2t+1), then scaled by dv. Shapes as
    `rw_tied_reference`, whose function it computes; the MMA's own order
    within a step is the hardware's."""
    b, n_out, d = g_out.shape
    e, n_c, _ = blam.shape[-3:]
    blam = blam.to(g_out.dtype)        # a grouped slab at f32: exact
    gq = -0.25 * g_out
    p = 0
    for k0 in range(0, d, 4):
        p = p + torch.einsum('bjk,bik->bji', a[..., k0:k0 + 4],
                             gq[..., k0:k0 + 4])
    w = torch.exp(p)                                   # (B, Nc, Nout)
    acc = torch.zeros((b, e, n_out, d + 1), dtype=g_out.dtype,
                      device=g_out.device)
    for j0 in range(0, n_c, 8):
        for par in (0, 1):
            js = slice(j0 + par, min(j0 + 8, n_c), 2)
            acc = acc + _contract(blam[..., js, :], w[:, js], aod[:, js])
    return dv_out[:, None, :, None] * acc


def rw_untied_split_reference(g, dv, a, ao, blam, plan: RwPlan):
    """Plain version of K2's split sum under `plan` (rw_untied_plan):
    `rw_split_reference` on each output's chain. Shapes as
    `rw_untied_reference`."""
    return torch.cat([rw_split_reference(
        g[:, k], dv[:, k], a, ao * dv[:, k, :, None], blam[k:k + 1], plan)
        for k in range(blam.shape[0])], dim=1)


def _blocks_per_sm(lib_name, fn_name, *args) -> int:
    fn = getattr(_build.load(lib_name), fn_name)
    fn.restype = ctypes.c_longlong
    n = fn(*args)
    if n < 0:
        raise RuntimeError(f'{fn_name}{args}: the occupancy query failed')
    return n


def rw_tied_mma_blocks_per_sm(d, e, s) -> int:
    """Blocks of the f64 tensor-core body's instance at S scenarios a block
    that an SM holds at once (needs the card)."""
    return _blocks_per_sm(_LIB[torch.float64],
                          'gpmpc_rw_tied_mma_blocks_per_sm_f64', d, e, s)


def rw_tied_blocks_per_sm(d, e, dtype, untied=False, s=None, split=1) -> int:
    """Blocks that an SM holds at once of the K1 (K2 when untied) instance a
    plan of S scenarios a block (S_max by default) and `split` launches, as
    the CUDA runtime reports it (needs the card)."""
    if s is None:
        s = rw_scenarios(d, 1 if untied else e, dtype)
    return _blocks_per_sm(_LIB[dtype], f'gpmpc_rw_tied_blocks_per_sm_'
                          f'{_FN[dtype]}', d, e, int(untied), s, split)


def _check(g_out, dv_out, a, aod, blam):
    """K1's shapes: blam (E, Nc, Nout), or (G, E, Nc, Nout) grouped, G a
    divisor of B, its dtype the operands' or, grouped, f32 under f64
    operands (the slab at the width the fit stored it)."""
    b, n_out, d = g_out.shape
    e, n_c = blam.shape[-3:-1]
    lead = blam.shape[:-3]
    if lead and (blam.ndim != 4 or lead[0] < 1 or b % lead[0]):
        raise ValueError(f'rw kernel: grouped blam {tuple(blam.shape)} '
                         f'needs (G, E, Nc, Nout) with G dividing B = {b}')
    _check_tensors({'dv_out': (b, n_out), 'a': (b, n_c, d),
                    'aod': (b, n_c, d + 1), 'blam': (*lead, e, n_c, n_out)},
                   {'dv_out': dv_out, 'a': a, 'aod': aod, 'blam': blam},
                   d, e, g_out, narrow=('blam',) if lead else ())


def _check_untied(g, dv, a, ao, blam):
    b, e, n, d = g.shape
    _check_tensors({'dv': (b, e, n), 'a': (b, n, d), 'ao': (b, n, d + 1),
                    'blam': (e, n, n)},
                   {'dv': dv, 'a': a, 'ao': ao, 'blam': blam}, d, e, g)


def _check_tensors(want, got, d, e, g, narrow=()):
    """Shapes `want` of the tensors `got` beside g; d, E within the built
    instances; one float dtype (those named in `narrow` may be float32
    under float64), one device, contiguous."""
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f'rw kernel: {k} has shape '
                             f'{tuple(got[k].shape)}, expected {shape}')
    if not (1 <= d <= MAX_D and 1 <= e <= MAX_E):
        raise ValueError(f'rw kernel supports d <= {MAX_D} and E <= {MAX_E}; '
                         f'got d={d}, E={e}')
    ts = (g, *got.values())
    if g.dtype not in _FN or any(
            t.dtype != g.dtype
            and not (k in narrow and t.dtype == torch.float32)
            for k, t in (('g', g), *got.items())):
        raise TypeError('rw kernel takes float32 or float64 tensors of one '
                        f'dtype; got {[t.dtype for t in ts]}')
    if any(t.device != g.device for t in ts):
        raise ValueError('rw kernel: tensors lie on different devices')
    if any(not t.is_contiguous() for t in ts):
        raise ValueError('rw kernel takes contiguous tensors')


def _run(fn, err_str, device, *args):
    """Call a launch function on `device`'s current stream; raise on the
    cudaError it returns (a launch the card refused)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'rw kernel launch failed: cudaError {err} '
                           f'({err_str(err).decode()})')


_BODY = {None: -1, 'scalar': 0, 'mma': 1}


def _launch(g_out, dv_out, a, aod, blam, max_split=MAX_SPLIT, body=None):
    """Launch K1 on the current stream in the body of `rw_tied_body` for the
    device's SM count (body=None, every path), or in the body named
    ('scalar', 'mma': chip_smoke.py times the two side by side): the
    tensor-core body at `rw_tied_mma_plan`, or the scalar body at
    `rw_tied_plan`, its split capped at max_split (MAX_SPLIT on every path).
    A blam of rank 4 (G, E, Nc, Nout), f32 or the operands' dtype, launches
    the grouped form at `rw_tied_grouped_plan`, groups of B / G scenarios.
    Returns (rw, launched)."""
    _check(g_out, dv_out, a, aod, blam)
    b, n_out, d = g_out.shape
    e, n_c, _ = blam.shape[-3:]
    if body not in _BODY or (body == 'mma' and g_out.dtype != torch.float64):
        raise ValueError(f'rw kernel: no body {body!r} for {g_out.dtype}')
    if g_out.device.type != 'cuda':
        raise ValueError(f'rw kernel runs on CUDA tensors, got {g_out.device}')
    sms = device_sms(g_out.device)
    if blam.ndim == 4:
        group = b // blam.shape[0]
        rw_tied_grouped_plan(b, n_out, n_c, d, e, group, g_out.dtype,
                             blam.dtype, body, sms)    # raises past the grid
        args = (blam.data_ptr(), _itemsize(blam.dtype))
        tail = (group, sms, _BODY[body])
        fn, err_str = _grouped_fn()
    else:
        if (body or rw_tied_body(b, n_out, n_c, d, e, g_out.dtype,
                                 sms)) == 'mma':
            rw_tied_mma_plan(b, n_out, d, e)          # raises past the grid
        else:
            rw_tied_plan(b, n_out, n_c, d, e, g_out.dtype)
        args = (blam.data_ptr(),)
        tail = (sms, max_split, _BODY[body])
        fn, err_str = _kernel_fn(g_out.dtype)
    rw = torch.empty((b, e, n_out, d + 1), dtype=g_out.dtype,
                     device=g_out.device)
    if rw.numel() == 0:
        return rw, False
    _run(fn, err_str, g_out.device, g_out.data_ptr(), dv_out.data_ptr(),
         a.data_ptr(), aod.data_ptr(), *args, rw.data_ptr(), b, n_out, n_c,
         d, e, *tail)
    return rw, True


def _launch_untied(g, dv, a, ao, blam, max_split=MAX_SPLIT):
    """Launch K2 on the current stream at the plan of `rw_untied_plan`;
    returns (rw, launched)."""
    _check_untied(g, dv, a, ao, blam)
    b, e, n, d = g.shape
    rw_untied_plan(b, n, d, e, g.dtype)               # raises past the grid
    if g.device.type != 'cuda':
        raise ValueError(f'rw kernel runs on CUDA tensors, got {g.device}')
    rw = torch.empty((b, e, n, d + 1), dtype=g.dtype, device=g.device)
    if rw.numel() == 0:
        return rw, False
    fn, err_str = _kernel_fn(g.dtype, untied=True)
    _run(fn, err_str, g.device, g.data_ptr(), dv.data_ptr(), a.data_ptr(),
         ao.data_ptr(), blam.data_ptr(), rw.data_ptr(), b, n, d, e,
         device_sms(g.device), max_split)
    return rw, True


def rw_tied(g_out, dv_out, a, aod, blam):
    """K1: rw (B, E, Nout, 1+d) with one exp chain shared by all E outputs.
    blam (E, Nc, Nout), or (G, E, Nc, Nout): K1's grouped form, one blam a
    group of B / G consecutive scenarios (counted in LAUNCHES_GROUPED too).
    CUDA tensors launch the kernel; CPU tensors take `rw_tied_reference`
    (`rw_tied_grouped_reference`)."""
    global LAUNCHES, LAUNCHES_F64, LAUNCHES_GROUPED
    grouped = blam.ndim == 4
    if g_out.device.type == 'cpu':
        _check(g_out, dv_out, a, aod, blam)
        return (rw_tied_grouped_reference if grouped else rw_tied_reference)(
            g_out, dv_out, a, aod, blam)
    rw, launched = _launch(g_out, dv_out, a, aod, blam)
    LAUNCHES += launched
    LAUNCHES_F64 += int(launched and g_out.dtype == torch.float64)
    LAUNCHES_GROUPED += int(launched and grouped)
    return rw


def rw_untied_reference(g, dv, a, ao, blam):
    """Plain version of K2: g (B, E, N, d); dv (B, E, N); a (B, N, d);
    ao (B, N, 1+d); blam (E, N, N) -> rw (B, E, N, 1+d)."""
    return torch.cat([rw_tied_reference(g[:, k], dv[:, k], a,
                                        ao * dv[:, k, :, None], blam[k:k + 1])
                      for k in range(blam.shape[0])], dim=1)


def rw_untied(g, dv, a, ao, blam):
    """K2: one exp chain per output (untied M2_e), all E outputs in one
    launch; the kernel applies dv_e to ao itself, so the wrapper makes no
    per-output tensor. Shapes as `rw_untied_reference`, contiguous. CPU
    tensors take `rw_untied_reference`."""
    global LAUNCHES_UNTIED
    if g.device.type == 'cpu':
        return rw_untied_reference(g, dv, a, ao, blam)
    rw, launched = _launch_untied(g, dv, a, ao, blam)
    LAUNCHES_UNTIED += launched
    return rw


# ------------------------------------------------------- K3: the row block --
def rw_tied_block_reference(g_blk, dv_blk, a, aod, blam_t_blk):
    """Plain version of K3: g_blk (B, Nl, d); dv_blk (B, Nl) on this shard's
    rows; a (B, N, d); aod (B, N, 1+d) on all rows; blam_t_blk (E, N, Nl),
    the shard's blam row block transposed -> rw (B, E, Nl, 1+d)."""
    return rw_tied_reference(g_blk, dv_blk, a, aod, blam_t_blk)


def rw_tied_block(g_blk, dv_blk, a, aod, blam_t_blk):
    """K3: K1 on a rectangle, this shard's Nl output rows contracted over all
    N rows (Nl <= N). CUDA tensors launch the kernel; CPU tensors take
    `rw_tied_block_reference`."""
    global LAUNCHES_BLOCK, LAUNCHES_BLOCK_F64
    if g_blk.shape[1] > a.shape[1]:
        raise ValueError(f'row block of {g_blk.shape[1]} rows exceeds the '
                         f'{a.shape[1]} contraction rows')
    if g_blk.device.type == 'cpu':
        return rw_tied_block_reference(g_blk, dv_blk, a, aod, blam_t_blk)
    rw, launched = _launch(g_blk, dv_blk, a, aod, blam_t_blk)
    LAUNCHES_BLOCK += launched
    if g_blk.dtype == torch.float64:
        LAUNCHES_BLOCK_F64 += launched
    return rw


# ------------------------------------------------ K4: the symmetric pairs --
SYM_TILE = 64           # kT of csrc/rw_sym_body.cuh
SYM_THREADS = 128       # kThreads: a pair block's 64 columns x 2 parities
SYM_CHUNK = 16          # kChunk: rows of tile J a phase-2 round
_SYM_LIB = {torch.float32: 'variance_trace_sym',
            torch.float64: 'variance_trace_sym_f64'}
_pair_cache: dict = {}


def _use_sym() -> bool:
    """The JAX package's opt-in (GPMPC_SYM_KERNEL=1), read at every call."""
    return os.environ.get('GPMPC_SYM_KERNEL') == '1'


def _pair_indices(nt: int):
    """Upper-triangle tile pairs (I <= J), diagonal first: numpy int32."""
    pairs = [(i, i) for i in range(nt)]
    pairs += [(i, j) for i in range(nt) for j in range(i + 1, nt)]
    idx = np.asarray(pairs, np.int32)
    return idx[:, 0], idx[:, 1]


def _device_pairs(nt: int, device):
    key = (nt, str(device))
    if key not in _pair_cache:
        _pair_cache[key] = tuple(torch.tensor(v, device=device)
                                 for v in _pair_indices(nt))
    return _pair_cache[key]


def _small_mm(a, m):
    """a (..., N, d) @ m (..., d, k) for tiny d, k, unrolled in a fixed order.
    m carries a singleton where a has its N axis, so m[..., j, kk] broadcasts
    against a[..., j]."""
    d, k = m.shape[-2], m.shape[-1]
    cols = []
    for kk in range(k):
        acc = a[..., 0] * m[..., 0, kk]
        for j in range(1, d):
            acc = acc + a[..., j] * m[..., j, kk]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def _prep_sym(u, m2, x, batched_m2_axes: int):
    """K4's prep: z = a L with M2 = L L^T (the unrolled small Cholesky, which
    never syncs with the host), so that p_ij = z_i . z_j is bit-symmetric.
    m2 (B, d, d) tied (batched_m2_axes 1) or (B, E, d, d) untied (2).
    Returns (a (B, N, d), z (B, N, d) | (B, E, N, d), dv (B, N) | (B, E, N))."""
    a = u[:, None, :] - x[None]                        # (B, N, d)
    low = chol_small(m2)
    if batched_m2_axes == 1:
        z = _small_mm(a, low[:, None])                 # (B, N, d)
    else:
        z = _small_mm(a[:, None], low[:, :, None])     # (B, E, N, d)
    return a, z, torch.exp(-0.125 * torch.sum(z * z, dim=-1))


def _sym_exponent(z):
    """p[..., j, i] = sum_k z_j,k z_i,k in the kernel's k order."""
    p = z[..., :, None, 0] * z[..., None, :, 0]
    for k in range(1, z.shape[-1]):
        p = p + z[..., :, None, k] * z[..., None, :, k]
    return p


def rw_sym_reference(z, a, dv, ao, blam, shared_chain: bool):
    """Plain version of K4: materialises W from z as the kernel defines it.
    shared_chain: z (B, N, d), dv (B, N); per-output: z (B, E, N, d),
    dv (B, E, N). a (B, N, d); ao (B, N, 1+d); blam (E, N, N)
    -> rw (B, E, N, 1+d)."""
    w = torch.exp(-0.25 * _sym_exponent(z))
    if shared_chain:
        aod = ao * dv[..., None]
        rw = torch.einsum('eji,bji,bjc->beic', blam, w, aod)
        return dv[:, None, :, None] * rw
    aod = ao[:, None] * dv[..., None]                   # (B, E, N, 1+d)
    rw = torch.einsum('eji,beji,bejc->beic', blam, w, aod)
    return dv[..., None] * rw


def _check_sym(z, a, dv, ao, blam, shared_chain):
    b, n, d = a.shape
    e = blam.shape[0]
    lead = (b, n) if shared_chain else (b, e, n)
    want = {'z': lead + (d,), 'dv': lead, 'ao': (b, n, d + 1),
            'blam': (e, n, n)}
    got = {'z': z.shape, 'dv': dv.shape, 'ao': ao.shape, 'blam': blam.shape}
    for k, shape in want.items():
        if tuple(got[k]) != shape:
            raise ValueError(f'rw_sym: {k} has shape {tuple(got[k])}, '
                             f'expected {shape}')
    if not (1 <= d <= MAX_D and 1 <= e <= MAX_E and b >= 1 and n >= 1):
        raise ValueError(f'rw_sym supports d <= {MAX_D} and E <= {MAX_E}; '
                         f'got d={d}, E={e}, B={b}, N={n}')
    ts = (z, a, dv, ao, blam)
    if z.dtype not in _FN or any(t.dtype != z.dtype for t in ts):
        raise TypeError('rw_sym takes float32 or float64 tensors of one '
                        f'dtype; got {[t.dtype for t in ts]}')
    if any(t.device != z.device for t in ts):
        raise ValueError('rw_sym: tensors lie on different devices')


class SymPlan(NamedTuple):
    scenarios: int      # S: scenarios a pair block, sharing each blam load
    threads: int        # SYM_THREADS
    n_tiles: int        # nt = ceil(N / SYM_TILE)
    smem_bytes: int     # dynamic shared memory of a pair block
    grid: tuple         # (tile pairs I <= J, ceil(B / S)) of the pair kernel
    sum_grid: tuple     # (ceil(N / 128), B) of the fixed-order sum


def rw_sym_scenarios(d: int, e: int, dtype, shared_chain: bool) -> int:
    """S of K4's pair kernel (`sym_scenarios<T, D, E, SHARED>()`): the
    column sums (E (1+d)) and the column's z (d a chain) of one scenario."""
    chains = 1 if shared_chain else e
    return _scenarios(_itemsize(dtype) // 4 * (e * (d + 1) + chains * d))


def _sym_smem(d, e, dtype, shared_chain) -> int:
    """`sym_smem_bytes` of csrc/rw_sym_body.cuh: blam o W of a chunk
    per (scenario, output), and per chain aod of tiles J and I and z of
    tile J, rows padded to 4."""
    s = rw_sym_scenarios(d, e, dtype, shared_chain)
    chains = s if shared_chain else s * e
    elems = (s * e * SYM_CHUNK * (SYM_TILE + 1)
             + chains * SYM_TILE * (2 * _pad4(d + 1) + _pad4(d)))
    return _itemsize(dtype) * elems


def rw_sym_plan(b, n, d, e, dtype, shared_chain: bool) -> SymPlan:
    """K4's launches for B scenarios of N rows: every (scenario, tile pair)
    falls in exactly one pair block, the ragged edges masked. Raises on what
    the kernel cannot take."""
    if not (1 <= d <= MAX_D and 1 <= e <= MAX_E):
        raise ValueError(f'rw_sym supports d <= {MAX_D}, E <= {MAX_E}; got '
                         f'd={d}, E={e}')
    if dtype not in _FN:
        raise TypeError(f'rw_sym takes float32 or float64, got {dtype}')
    s = rw_sym_scenarios(d, e, dtype, shared_chain)
    nt = -(-n // SYM_TILE)
    smem = _sym_smem(d, e, dtype, shared_chain)
    plan = SymPlan(s, SYM_THREADS, nt, smem, (nt * (nt + 1) // 2, -(-b // s)),
                   (-(-n // 128), b))
    if not (b >= 1 and n >= 1 and smem <= MAX_SMEM
            and max(plan.grid[1], plan.sum_grid[1]) <= _MAX_GRID_Y):
        raise ValueError(f'rw_sym: B={b}, N={n} needs grid.y '
                         f'{plan.sum_grid[1]} (at most {_MAX_GRID_Y}) and '
                         f'{smem} shared bytes (at most {MAX_SMEM})')
    return plan


def _sym_kernel_fn(dtype):
    """(launch, error string) of `dtype`'s K4 library, checked against this
    module's plan when it is first loaded."""
    sfx = _FN[dtype]
    lib = _build.load(_SYM_LIB[dtype])
    fn = getattr(lib, f'gpmpc_rw_sym_{sfx}')
    if fn.argtypes is None:
        want = {(f'tile_{sfx}',): SYM_TILE, (f'threads_{sfx}',): SYM_THREADS,
                (f'chunk_{sfx}',): SYM_CHUNK}
        for d in range(1, MAX_D + 1):
            for e in range(1, MAX_E + 1):
                for shared in (0, 1):
                    want[(f'scenarios_{sfx}', d, e, shared)] = \
                        rw_sym_scenarios(d, e, dtype, bool(shared))
                    want[(f'smem_{sfx}', d, e, shared)] = _sym_smem(
                        d, e, dtype, bool(shared))
        _check_plan(lib, 'gpmpc_rw_sym', want)
        err_fn = getattr(lib, f'gpmpc_rw_sym_error_string_{sfx}')
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn, getattr(lib, f'gpmpc_rw_sym_error_string_{sfx}')


def rw_sym_blocks_per_sm(d, e, dtype, shared_chain: bool) -> int:
    """K4's pair blocks an SM holds at once, as the CUDA runtime reports it
    (needs the card)."""
    return _blocks_per_sm(_SYM_LIB[dtype], 'gpmpc_rw_sym_blocks_per_sm_'
                          f'{_FN[dtype]}', d, e, int(shared_chain))


def _launch_sym(z, a, dv, ao, blam, shared_chain):
    """Launch K4 (pair kernel, then the fixed-order sum) on the current
    stream; returns (rw, launched)."""
    _check_sym(z, a, dv, ao, blam, shared_chain)
    b, n, d = a.shape
    e = blam.shape[0]
    nt = rw_sym_plan(b, n, d, e, z.dtype, shared_chain).n_tiles
    if z.device.type != 'cuda':
        raise ValueError(f'rw_sym runs on CUDA tensors, got {z.device}')
    iidx, jidx = _device_pairs(nt, z.device)
    aod = (ao * dv[..., None] if shared_chain
           else ao[:, None] * dv[..., None]).contiguous()
    z, dv, blam = z.contiguous(), dv.contiguous(), blam.contiguous()
    part = torch.empty((b, nt, nt, e, SYM_TILE, d + 1), dtype=z.dtype,
                       device=z.device)
    rw = torch.empty((b, e, n, d + 1), dtype=z.dtype, device=z.device)
    fn, err_str = _sym_kernel_fn(z.dtype)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(z.data_ptr(), aod.data_ptr(), dv.data_ptr(), blam.data_ptr(),
                 part.data_ptr(), rw.data_ptr(), iidx.data_ptr(),
                 jidx.data_ptr(), b, n, d, e, nt, iidx.numel(),
                 int(shared_chain), stream)
    if err != 0:
        raise RuntimeError(f'rw_sym launch failed: cudaError {err} '
                           f'({err_str(err).decode()})')
    return rw, True


def rw_sym(z, a, dv, ao, blam, shared_chain: bool):
    """K4: rw (B, E, N, 1+d) over the tile pairs I <= J, one exp tile per
    pair (per output when not shared_chain), shapes as `rw_sym_reference`.
    CUDA tensors launch the kernel; CPU tensors take `rw_sym_reference`."""
    global LAUNCHES_SYM
    if z.device.type == 'cpu':
        _check_sym(z, a, dv, ao, blam, shared_chain)
        return rw_sym_reference(z, a, dv, ao, blam, shared_chain)
    rw, launched = _launch_sym(z, a, dv, ao, blam, shared_chain)
    LAUNCHES_SYM += launched
    return rw


# ------------------------------------------------------------- public entry --
def _aug(a):
    """AO = [1 | A]: the augmented reduction matrix (a: (B, N, d))."""
    return torch.cat([torch.ones_like(a[..., :1]), a], dim=-1)


def _prep_tied(u, m2, x):
    a = _diff(u, x)                                    # (B, N, d)
    g = torch.einsum('bnd,bdk->bnk', a, m2)            # (B, N, d)
    q = torch.sum(g * a, dim=-1)                       # (B, N)
    return a, g, torch.exp(-0.125 * q)


def _prep_batched(u, m2, x):
    a = u[:, None, :] - x[None]                        # (B, N, d)
    g = torch.einsum('bnd,bedk->benk', a, m2)          # (B, E, N, d)
    q = torch.sum(g * a[:, None], dim=-1)              # (B, E, N)
    return a, g, torch.exp(-0.125 * q)


def _diff(u, x):
    """a = u_b - x (B, N, d): x (N, d) shared by the scenarios, or (G, N, d)
    one set a group of B / G consecutive scenarios (K1's grouped form)."""
    if x.ndim == 2:
        return u[:, None, :] - x[None]
    g, n, d = x.shape
    return (u.reshape(g, -1, 1, d) - x[:, None]).reshape(-1, n, d)


def _rw_dispatch(u, m2, x, blam, tied: bool):
    """Prep and kernel, shared by the tied and untied forwards: K4 when the
    opt-in is on, else the column sweep (K1 tied, K2 untied); grouped x and
    blam (one a group of scenarios) K1's grouped form."""
    if blam.ndim == 4 and (_use_sym() or not tied):
        raise ValueError('the grouped trace (one blam a group of scenarios) '
                         'runs K1 only: tied lengthscales, GPMPC_SYM_KERNEL '
                         'off')
    if _use_sym():
        a, z, dv = _prep_sym(u, m2, x, 1 if tied else 2)
        return rw_sym(z.contiguous(), a, dv.contiguous(), _aug(a),
                      blam.contiguous(), shared_chain=tied)
    if tied:
        a, g, dv = _prep_tied(u, m2, x)
        return rw_tied(g.contiguous(), dv.contiguous(), a.contiguous(),
                       (_aug(a) * dv[..., None]).contiguous(),
                       blam.contiguous())
    a, g, dv = _prep_batched(u, m2, x)
    return rw_untied(g.contiguous(), dv.contiguous(), a.contiguous(),
                     _aug(a).contiguous(), blam.contiguous())


def _tied_backward(u, m2, x_rows, rw, ct):
    """(du, dm2) of the tied trace from rw on the rows x_rows: all rows for
    the full trace (one set a group of scenarios where grouped), the
    shard's rows for the row block (whose value is exact only after the sum
    over the model ranks)."""
    a = _diff(u, x_rows)                               # (B, Nr, d)
    r = rw[..., 0]                                     # (B, E, Nr)
    wa = rw[..., 1:]                                   # (B, E, Nr, d)
    # The untied cotangents summed over e, because m2 is shared.
    z0c = torch.einsum('bnd,ben,be->bd', a, r, ct)
    du = -torch.einsum('bdk,bk->bd', m2, z0c)
    warc = torch.einsum('be,benk->bnk', ct, wa + a[:, None] * r[..., None])
    dm2 = -0.25 * torch.einsum('bnd,bnk->bdk', a, warc)
    return du, dm2


# The dtype every trace is evaluated in (the precision policy above).
TRACE_DTYPE = torch.float64


def _upcast(native: bool, *ts):
    """The trace's operands in TRACE_DTYPE, or as they are when native."""
    return ts if native else tuple(t.to(TRACE_DTYPE) for t in ts)


class _VarianceTraceTied(torch.autograd.Function):
    """The tied trace and its analytic backward; rw, which the backward
    reads, is a second output (not differentiable). Under torch.func.vmap
    over groups of scenarios (dynamics.rollout_batched over one GP a lane)
    its rule is K1's grouped form, as JAX's vmap of pallas_call batches
    the kernel: the groups' scenarios flattened, x and blam one a group."""

    @staticmethod
    def forward(u, m2, x, blam, native):
        dtype = u.dtype
        u, m2, x = _upcast(native, u, m2, x)
        if blam.ndim == 3:
            blam, = _upcast(native, blam)
        # A grouped slab stays at the width it is stored at (f32 or f64):
        # K1's grouped form widens each element where it multiplies it.
        rw = _rw_dispatch(u, m2, x, blam, tied=True)
        return rw[..., 0].sum(dim=-1).to(dtype), rw

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, m2, x, _, native = inputs
        rw = output[1]
        ctx.mark_non_differentiable(rw)
        ctx.save_for_backward(*_upcast(native, u, m2, x), rw)

    @staticmethod
    def backward(ctx, ct, _):
        u, m2, x, rw = ctx.saved_tensors
        du, dm2 = _tied_backward(u, m2, x, rw, ct.to(rw.dtype))
        return du.to(ct.dtype), dm2.to(ct.dtype), None, None, None

    @staticmethod
    def vmap(info, in_dims, u, m2, x, blam, native):
        n = info.batch_size

        def lead(v, dim):
            return v.movedim(dim, 0) if dim is not None else v.expand(
                n, *v.shape)

        u, m2 = lead(u, in_dims[0]), lead(m2, in_dims[1])
        k = u.shape[1]
        if in_dims[3] is None:          # one blam for all: one group
            if in_dims[2] is not None:
                raise ValueError('the trace under vmap takes x mapped only '
                                 'with blam mapped')
            x_g, blam_g = x, blam
        else:
            x_g, blam_g = lead(x, in_dims[2]), lead(blam, in_dims[3])
        t, rw = _VarianceTraceTied.apply(
            u.reshape(n * k, *u.shape[2:]), m2.reshape(n * k, *m2.shape[2:]),
            x_g.contiguous(), blam_g.contiguous(), native)
        return ((t.reshape(n, k, *t.shape[1:]),
                 rw.reshape(n, k, *rw.shape[1:])), (0, 0))


class _VarianceTraceTiedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, m2, x, x_blk, blam_t_blk, native):
        ctx.dtype = u.dtype
        u, m2, x, x_blk, blam_t_blk = _upcast(native, u, m2, x, x_blk,
                                              blam_t_blk)
        a, _, dv = _prep_tied(u, m2, x)
        _, g_blk, dv_blk = _prep_tied(u, m2, x_blk)
        rw = rw_tied_block(g_blk.contiguous(), dv_blk.contiguous(),
                           a.contiguous(),
                           (_aug(a) * dv[..., None]).contiguous(),
                           blam_t_blk.contiguous())
        ctx.save_for_backward(u, m2, x_blk, rw)
        return rw[..., 0].sum(dim=-1)

    @staticmethod
    def backward(ctx, ct):
        u, m2, x_blk, rw = ctx.saved_tensors
        du, dm2 = _tied_backward(u, m2, x_blk, rw, ct.to(rw.dtype))
        return du.to(ctx.dtype), dm2.to(ctx.dtype), None, None, None, None


class _VarianceTraceUntied(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, m2, x, blam, native):
        dtype = u.dtype
        u, m2, x, blam = _upcast(native, u, m2, x, blam)
        rw = _rw_dispatch(u, m2, x, blam, tied=False)
        ctx.save_for_backward(u, m2, x, rw)
        return rw[..., 0].sum(dim=-1).to(dtype)

    @staticmethod
    def backward(ctx, ct):
        u, m2, x, rw = ctx.saved_tensors
        ct64 = ct.to(rw.dtype)
        a = u[:, None, :] - x[None]                    # (B, N, d)
        r = rw[..., 0]                                 # (B, E, N)
        wa = rw[..., 1:]                               # (B, E, N, d)
        z0 = torch.einsum('bnd,ben->bed', a, r)
        du = -torch.einsum('be,bedk,bek->bd', ct64, m2, z0)
        war = wa + a[:, None] * r[..., None]           # W A + diag(r) A
        dm2 = -0.25 * torch.einsum('bnd,benk->bedk', a,
                                   ct64[..., None, None] * war)
        return du.to(ct.dtype), dm2.to(ct.dtype), None, None, None


def variance_trace_batched_tied(u, m2, x, blam, *, native: bool = False):
    """Tied-lengthscale batched trace: u (B, d); m2 (B, d, d) shared across
    outputs; x (N, d); blam (E, N, N) -> (B, E) in u's dtype, evaluated in
    f64 (the precision policy; native=True: in u's dtype). Analytic
    gradients in (u, m2); x and blam are constants (the rollout cache is
    detached). x (G, N, d) and blam (G, E, N, N) give K1's grouped form:
    scenario b reads group b // (B / G)'s; this is the rule of the trace
    under torch.func.vmap over groups."""
    return _VarianceTraceTied.apply(u, m2, x, blam, native)[0]


def variance_trace_batched(u, m2, x, blam, *, native: bool = False):
    """Untied batched trace: u (B, d); m2 (B, E, d, d); x (N, d);
    blam (E, N, N) -> (B, E). Precision and gradients as
    variance_trace_batched_tied."""
    return _VarianceTraceUntied.apply(u, m2, x, blam, native)


def variance_trace_tied_block(u, m2, x, x_blk, blam_t_blk, *,
                              native: bool = False):
    """Per-shard partial of the tied trace: u (B, d); m2 (B, d, d); x (N, d)
    all training inputs; x_blk (Nl, d) this shard's rows; blam_t_blk
    (E, N, Nl) the shard's blam row block transposed -> (B, E) partial
    traces, whose sum over the shards is the full trace. The partial is
    returned in f64 whatever the operands' dtype (native=True: in u's), since
    the partials cancel across shards as the terms do within one: the caller
    rounds only their sum. The cotangents come back in u's dtype.

    The backward returns the symmetry-collapsed cotangents restricted to the
    block: a shard's (du, dm2) is not the gradient of its partial alone, but
    the sum over the shards is the exact full gradient. Use it only where the
    caller sums the cotangents of u and m2 over the model ranks
    (parallel/model_sharded.py)."""
    return _VarianceTraceTiedBlock.apply(u, m2, x, x_blk, blam_t_blk, native)


def variance_trace_batched_reference(u, m2, x, blam):
    """Plain PyTorch twin of variance_trace_batched, differentiated by autograd
    (the test oracle); x (G, N, d) and blam (G, E, N, N) one a group of
    B / G consecutive scenarios, as K1's grouped form."""
    a = _diff(u, x)                                    # (B, N, d)
    g = torch.einsum('bnd,bedk->benk', a, m2)          # (B, E, N, d)
    p = torch.einsum('bend,bmd->benm', g, a)           # (B, E, N, N)
    q = torch.sum(g * a[:, None], dim=-1)              # (B, E, N)
    dvec = torch.exp(-0.125 * q)
    blam_b = (blam[None] if blam.ndim == 3 else
              blam.repeat_interleave(u.shape[0] // blam.shape[0], dim=0))
    w = blam_b * torch.exp(-0.25 * p)
    return torch.einsum('ben,benm,bem->be', dvec, w, dvec)


def variance_trace_batched_tied_reference(u, m2, x, blam):
    """Plain PyTorch twin of variance_trace_batched_tied (the test oracle)."""
    e = blam.shape[-3]
    m2b = m2[:, None].expand(m2.shape[0], e, *m2.shape[1:])
    return variance_trace_batched_reference(u, m2b, x, blam)
