// K4: the symmetric-pair variance-trace kernel, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_make_rw_sym_kernel`, dispatched by `_rw_call_sym`
// in gpmpc_tpu/ops/pallas/variance_trace.py. It computes the same rw as K1,
//
//   rw[b,e,i,c] = dv[b,i] * sum_j blam[e,j,i] * W[b,j,i] * aod[b,j,c],
//   W[b,j,i]    = exp(-1/4 sum_k z[b,j,k] z[b,i,k]),
//
// with the exponent in the whitened form z = a chol(M2), so that W is
// bit-symmetric: W[j,i] and W[i,j] are the same products summed in the same
// k order (explicit fma, which is commutative in its two factors, starting
// from 0). W and blam are symmetric, so the kernel visits only the tile pairs
// (I, J) with I <= J, computes each pair's exp tile once, and reduces it both
// ways: along columns into row tile I's partial and, off the diagonal, along
// rows into row tile J's partial. The per-output variant (untied M2_e) gives
// every output its own z_e, dv_e and exp tile.
//
// Two launches, no atomics, so the bits do not depend on scheduling:
//   1. rw_sym_pair_kernel, one block per (tile pair, S scenarios): writes the
//      partial of row tile R from contraction tile K to part[b, R, K] (each
//      slot is written by exactly one pair: R <= K by the column reduction of
//      pair (R, K), R > K by the row reduction of pair (K, R)).
//   2. rw_sym_sum_kernel, one thread per (scenario, row): sums part[b, R, K]
//      over K = 0 .. nt-1 in that order and applies the final dv scale.
// Tiles are kT = 64 rows; a ragged last tile and a ragged last scenario group
// are masked, so any n and B work.
//
// Bound on an H100: operations, as K1, with the exp count cut to
// (nt + 1) / (2 nt) of K1's (5/8 at the headline's nt = 4); the reductions
// are unchanged in number: 0.0053 ms tied and 0.0063 ms per-output at the
// headline shape (B = N = 256, d = 3, E = 2, f32; chip_smoke.py's
// sym_bound_ms).
//
// What held the first design back (one NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md): one 64-thread block a (tile pair, scenario), 2,560 blocks at the
// headline. The tied variant wrote the exp tile to shared memory and read it
// back once per output, and loaded the blam tile from global memory once per
// output and scenario (84 MB a call); its two 64 x 65 tiles (36 KB at d = 3)
// let 6 blocks, 12 warps, onto an SM. It took 0.0855 ms, slower than the
// per-output variant's 0.0635 although it computes half the exps.
//
// This design, as K1's:
//   - A block of 128 threads serves S scenarios of one tile pair (S a
//     constexpr of (T, D, E, chain): the accumulators S E (1+d) and the
//     column's z, within ~48 registers; 4 tied and 3 per-output at the
//     headline in f32). Thread (column i, parity h) takes the rows j of tile
//     J with j = h mod 2: it loads blam[e, j, i] once per (j, e) into a
//     register and applies it to its S scenarios, so each blam tile is read
//     once a block, not once a scenario.
//   - The exp stays in a register: the thread that computes W[j, i] uses it
//     at once for all E outputs (the tied chain) and keeps the column sums
//     in registers; shared memory holds only blam o W of a chunk of kChunk
//     rows of tile J, per scenario and output, for phase 2's transposed read
//     (row stride kLd = 65: conflict-free both ways). The two parities'
//     column sums meet in shared memory, even + odd, in that order.
//   - z and aod rows are staged by cp.async (all copies in flight at once),
//     padded to a multiple of 4, and read as 16-byte broadcasts (float4 at
//     d = 3).
//   - 45.6 KB of shared memory tied at d = 3 in f32, 43.4 KB per-output:
//     5 blocks (20 warps) an SM by the CUDA occupancy query.
// The scratch part (B, nt, nt, E, kT, 1+d) and its fixed-order sum stay.
// Measured (CUDA-graph slopes, one H100 80GB HBM3 at 700 W, PERF.md):
// 0.035 ms tied and 0.052 ms per-output at the headline, against 0.0854 and
// 0.0630 for the first design in the same run.
//
// Precision: the accurate expf (never __expf or --use_fast_math) and exact
// f32 FMAs for the (1+d)-wide reductions, as in K1. The double instances,
// which let the card evaluate the f64 reference objective on this path, are
// built from variance_trace_sym_f64.cu into a library of their own.
//
// The kernels are in rw_sym_body.cuh; this file builds the float instances.

#include "rw_sym_body.cuh"

GPMPC_RW_SYM_EXPORTS(float, f32)
