// K1's body: the variance-trace column sweep, templated on its variants.
//
// One source for the kernels the solve launches (variance_trace_tied.cu: K1,
// K2 in its untied mode, and K3, which launches K1 on a rectangle) and for
// the probe that times it with one stage removed at a time
// (variance_trace_probe.cu). The probe therefore times the code the solve
// runs, never a copy of it. It replaces the TPU kernels
// `_make_rw_tied_streamed_kernel` (gpmpc_tpu/ops/pallas/variance_trace.py,
// dispatched by `_rw_call_tied`) and, in its untied mode, `_rw_call`.
//
// For scenario b, output e, output row i and column c in [0, 1 + d):
//
//   rw[b,e,i,c] = dv[b,i] * sum_j blam[e,j,i] * exp(-1/4 sum_k a[b,j,k] g[b,i,k])
//                                             * aod[b,j,c]
//
// Untied (K2): g, dv and aod are per output, g[b,e,i], dv[b,e,i] and
// aod[b,e,j] = dv[b,e,j] [1 | a[b,j]]; the kernel reads ao = [1 | a] once
// for all outputs and applies the factor dv[b,e,j] to the exp itself.
//
// Bound on an H100: operations, 0.0065 ms at the headline shape (B = N =
// 256, d = 3, E = 2, f32: 2d + 2 + E (1 + 2 (1+d)) flops a pair over
// 67 TFLOP/s; chip_smoke.py's bound_ms, which counts the f64 exp by its
// FP64 instructions).
//
// What held the first design back (one NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md): one thread an output row and one scenario a block, so every
// thread walked all n_c contraction rows in one serial chain, each step
// waiting on E scalar L2 loads of blam and 7 scalar shared loads, with ~4
// warps a scheduler to hide it: 0.063 ms. Dropping the blam reads saved 44
// of those 63 us, yet half the rows (K3 at Nl = N/2) or half the blam loads
// (K2 at E = 1) took the same time: the chain's latency, not the bytes, set
// the pace.
//
// This design:
//   - A block serves S scenarios of one tile of kRows output rows (S_max a
//     constexpr of (T, D, E): the accumulators S (d + E (1+d)) stay within
//     ~48 registers; 4 at the headline in f32, 1 at d = E = 8). blam is the
//     same for every scenario, so a thread loads blam[e, j, i] once per
//     (j, e) and applies it to its S scenarios' weights: 1/S of the loads,
//     and S independent exp chains to overlap with each load.
//   - The contraction is split across the kSlices warp rows of the block:
//     each staged tile of kSlices * sub rows gives slice k its rows
//     [k sub, (k+1) sub), so each thread's chain is S n_c / kSlices steps.
//     The slices' (S, E, 1+d) partials meet in shared memory and are summed
//     in the fixed order k = 0 .. kSlices-1 (no atomics: the bits do not
//     depend on scheduling).
//   - a and aod are staged per scenario with rows padded to a multiple of 4,
//     so a pair reads them as two 16-byte broadcasts (float4 at d = 3) in
//     place of 2d + 1 scalar loads. The staging is by cp.async into two
//     buffers: every copy of a tile is in flight at once, and tile t + 1
//     lands while tile t is summed.
//   - The block is kRows = 64 output rows by kSlices = 4 slices (256
//     threads), a compile-time shape: the fastest of the plans the probe
//     times (its plan_* variants, PERF.md).
//
// The plan for a small B (the closed loop's B = 1 and 5). At B = 1 the grid
// above is ceil(N / 64) blocks on 132 SMs, S_max - 1 of a block's scenario
// slots are empty (their FP64 work thrown away) and each thread's chain is
// S n_c / 4 steps. So:
//   - S = S_max where B >= S_max, else 1: no FP64 work on empty slots.
//     Three instances serve every plan: S_max unsplit (the design above,
//     its tiles and rows compile-time constants), S_max split, and S = 1
//     (split or not; one instance where S_max = 1 is S = 1).
//   - Untied, the outputs are a grid axis (blockIdx.z): one launch a trace
//     for all E, each block one output's chain, a and ao staged per block.
//   - Where the grid (row tiles x scenario groups x outputs) fills at most a
//     quarter of the SMs, the contraction is split over `split` blocks
//     (2 .. 8, at least kSplitRows rows each) that form a thread-block
//     cluster along x. Rank r sums the rows [r chunk, (r+1) chunk) in tiles
//     of kSlices * sub rows (sub <= kSubRows, so every slice has rows), then
//     the ranks' partials meet through distributed shared memory: each rank
//     writes its slices' sum to its own shared memory, and after a cluster
//     barrier every rank adds a share of the outputs over the ranks in the
//     order 0 .. split-1 (fixed, so the bits do not depend on scheduling;
//     PTX barrier.cluster and ld.shared::cluster). The launch goes through
//     cudaLaunchKernelEx with a cluster attribute.
//
// K1's grouped form (`group` scenarios a blam slab): blam (G, E, n_c, n_out), one
// slab a group of B / G consecutive scenarios (one GP a lane: the
// multistart recipe under JAX's vmap, each lane's starts against its own
// GP), in f32 or f64 whatever T: the width the fit stored it at, each
// element widened to T in a register before its one multiply (exact, so
// the values are those of a widened copy). The slab comes from device
// memory (one a lane, unlike the ungrouped blam, which stays in L2 for all
// B), and a group of five (the recipe's four starts and the warm one) fills
// neither S = 2 nor 4 slots. So a grouped block is P scenario sets
// (blockDim.z) of one scenario each, P = ceil(group / gblocks) with
// gblocks = ceil(group / group_sets(d, E)) blocks a group (five at d = 3,
// E = 2: one block, every slot live), each set a block of the design above
// at S = 1 on kGroupRows = 32 rows (128 threads, so that 5 sets stay within
// 640): its own staging buffers and partials, the sets' blam loads of one
// (j, i) falling on one L1 line, so the slab leaves device memory once a
// launch. A set's sums are those of S = 1 unsplit: the bits of the
// ungrouped body's S = 1 launch on that scenario and slab. No split.
//   The plans are worked out on the host (plan_of, group_plan_scalar
//   below); `rw_tied_plan`, `rw_untied_plan` and `rw_tied_grouped_plan` in
//   ops/kernels/variance_trace.py mirror them and check them against this
//   header's exports at load. Where split = 1 a launch is the one of the
//   design above, to the bit.
// Tensor cores are not used: the reduction is 1 + d = 4 columns wide, and
// the probe measured TF32 reductions at 1.6-1.7x the first design's
// FMA-reduction time, with TF32 alone 5-20x off the accuracy bar on the
// headline GP.
//
// Measured (CUDA-graph slopes, one H100 80GB HBM3 at 700 W, PERF.md):
// ~0.026 ms at the headline (64 rows x 4 slices, S = 4), against ~0.063
// for the first design; ~0.04 ms at S = 1 (`full_s1`); 3-25 % more at the
// other block shapes the probe times.
//
// Precision: the accurate expf / exp (never __expf or --use_fast_math),
// exact FMAs in the reduction, and a double instance.
//
// The variants (each a defined function; Variant::kFull is K1 exactly):
//   kFull    K1.
//   kHwExp   __expf (the SFU approximation) in place of expf.
//   kNoExp   w = -p / 4: the exponent's FMAs without the exp.
//   kNoP     w = g_i[0]: no exponent FMAs and no exp.
//   kNoDots  acc[e][0] += blam * w; columns 1..d stay 0.
//   kNoMul   bw = w: no blam read and no blam multiply.
//   kEmpty   the staging of a and aod as K1 does it, and acc[e][0] +=
//            blam[e, j0, i] once per staged tile (by slice 0): no pair loop.
//            The floor of launch, staging, the slices' sum and the stores.
// Every variant stages both arrays as K1 does (cp.async is never dropped),
// so a variant's time differs from K1's by its own stage alone; and three
// template knobs: S (full_s1 sets S = 1, scenario sharing off), kSub
// (full_tile256 doubles the rows a slice takes from each tile) and the
// block shape Rows x Slices (the probe's plan_* variants). The probe
// launches every variant but kFull at S_max with no split (`launch`); kFull
// takes K1's plan (`launch_planned`), so that it is K1 to the bit.
//
// Included by .cu files that are each built into their own shared library;
// the anonymous namespace keeps every symbol local to its library.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // output rows a block (blockDim.x)
constexpr int kSlices = 4;     // contraction slices a block (blockDim.y)
constexpr int kSubRows = 32;   // contraction rows a slice takes a tile
constexpr int kMaxSplit = 8;   // blocks of a cluster: the portable limit
constexpr int kSplitRows = 16; // the fewest contraction rows a rank takes
constexpr int kSplitFill = 4;  // split only where blocks * 4 <= SMs
constexpr int kMaxGridY = 65535;
constexpr int kGroupRows = 32; // output rows a grouped block (the scalar body)
constexpr int kMaxSets = 5;    // scenario sets a grouped block, at most

// Scenario sets a grouped block may hold at (d, E): one scenario each, the
// sets' accumulators (E NT 4 doubles a set in the tensor-core body, NT its
// n tiles) within ~40 doubles, 1 to kMaxSets (5 at d = 3, E = 2); the
// blocks' threads, 128 a set, within 640, so that a thread keeps ~100
// registers.
__host__ __device__ constexpr int group_nt(int d) { return d + 1 > 8 ? 2 : 1; }
__host__ __device__ constexpr int group_sets_nt(int e, int nt) {
  const int p = 10 / (e * nt);
  return p < 1 ? 1 : (p > kMaxSets ? kMaxSets : p);
}
__host__ __device__ constexpr int group_sets(int d, int e) {
  return group_sets_nt(e, group_nt(d));
}

enum class Variant : int { kFull, kHwExp, kNoExp, kNoP, kNoDots, kNoMul, kEmpty };

// The cluster's barrier: every thread of every block of the cluster arrives
// (release) and waits (acquire), so the shared-memory writes before it are
// seen by the cluster's other blocks after it. Called by all threads.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;\n" ::
          : "memory");
}

// *p in the shared memory of the cluster's block `rank` (distributed shared
// memory): p is an address in this block's shared memory.
template <typename T>
__device__ __forceinline__ T ld_cluster(const T* p, int rank) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "float or double");
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  T v;
  if constexpr (sizeof(T) == 8)
    asm volatile("ld.shared::cluster.f64 %0, [%1];"
                 : "=d"(v)
                 : "r"(remote)
                 : "memory");
  else
    asm volatile("ld.shared::cluster.f32 %0, [%1];"
                 : "=f"(v)
                 : "r"(remote)
                 : "memory");
  return v;
}

// Scenarios a block serves at most: its accumulators and g, S (d + E (1+d))
// values of T, kept within ~48 registers; 1 to 4.
template <typename T, int D, int E>
__host__ __device__ constexpr int scenarios() {
  constexpr int words = static_cast<int>(sizeof(T) / 4) * (D + E * (D + 1));
  constexpr int s = 48 / words;
  return s < 1 ? 1 : (s > 4 ? 4 : s);
}

// Dynamic shared memory of a launch: two staging buffers of a tile of a and
// aod (untied: ao and the contraction rows' dv) for S scenarios (rows padded
// to a multiple of 4), and, reusing the same bytes, the slices' partials
// (row stride Rows + 1) for their fixed-order sum.
template <typename T, int D, int E, int S, int Sub = kSubRows,
          int Rows = kRows, int Slices = kSlices, bool Untied = false>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr size_t stage = 2 * static_cast<size_t>(S) * Slices * Sub *
                           (pad4(D) + pad4(D + 1) + (Untied ? 1 : 0));
  constexpr size_t red =
      static_cast<size_t>(Slices) * S * E * (D + 1) * (Rows + 1);
  return sizeof(T) * (stage > red ? stage : red);
}

template <typename T>
struct RwArgs {
  const T* g;     // (B, n_out, d); untied (B, E, n_out, d): g = a M2
  const T* dv;    // (B, n_out); untied (B, E, n_out): exp(-q / 8)
  const T* a;     // (B, n_c, d)     u - x on the contraction rows
  const T* aod;   // (B, n_c, 1+d)   dv o [1 | a]; untied [1 | a]
  const T* blam;  // (E, n_c, n_out)
  T* rw;          // (B, E, n_out, 1+d)
  int b;
  int n_out;
  int n_c;
  cudaStream_t stream;
};

// K1's grouped form: RwArgs with blam (B / group, E, n_c, n_out) of
// float or double (blam_bytes 4 or 8), scenario b reading slab b / group.
template <typename T>
struct GroupArgs {
  const T* g;
  const T* dv;
  const T* a;
  const T* aod;
  const void* blam;
  T* rw;
  int b;
  int n_out;
  int n_c;
  int group;
  cudaStream_t stream;
};

// A launch: S scenarios a block, the contraction in `split` ranks of
// `chunk` rows, each staged in tiles of Slices * sub rows.
struct Plan {
  int s;
  int split;
  int chunk;
  int sub;
  dim3 grid;
  size_t smem;
};

// A grouped launch (either body): `sets` scenario sets a block, gblocks
// blocks a group on grid.y.
struct GroupPlan {
  int sets;
  int gblocks;
  dim3 grid;
  dim3 block;
  size_t smem;
};

// A group of `group` scenarios in gblocks = ceil(group / most) blocks of
// sets = ceil(group / gblocks) scenario sets (so the blocks of a group
// differ by at most one live set).
inline void group_blocks(int group, int most, int* sets, int* gblocks) {
  *gblocks = (group + most - 1) / most;
  *sets = (group + *gblocks - 1) / *gblocks;
}

// Blocks of grid.y of B scenarios at s a block, in groups of `group` (0:
// one group of all B), no block spanning two groups (the route's count of
// a grouped launch at S_max, tied_route).
inline long long scenario_blocks(int b, int group, int s) {
  const int grp = group > 0 ? group : b;
  return grp > 0 ? static_cast<long long>((b + grp - 1) / grp) *
                       ((grp + s - 1) / s)
                 : 0;
}

// The plan of a launch for B scenarios, n_out output rows, n_c contraction
// rows and `outs` outputs on the grid (1 tied, E untied) on a card of `sms`
// SMs: S = S_max where B >= S_max, else 1; split where the grid fills at
// most 1 / kSplitFill of the SMs. A plan the card cannot take (grid.y past
// kMaxGridY) is returned as is: the launch refuses it.
template <typename T, int D, int E, int SMax, int kSub, int Rows, int Slices,
          bool Untied>
Plan plan_of(int b, int n_out, int n_c, int outs, int sms, int max_split) {
  Plan p{};
  p.s = b >= SMax ? SMax : 1;
  const long long tiles = (n_out + Rows - 1) / Rows;
  const long long groups = scenario_blocks(b, 0, p.s);
  const long long blocks = tiles * groups * outs;
  int split = 1;
  if (blocks > 0 && blocks * kSplitFill <= sms) {
    const long long most = sms / blocks;
    split = static_cast<int>(most < max_split ? most : max_split);
    split = n_c / kSplitRows < split ? n_c / kSplitRows : split;
    split = split < 1 ? 1 : split;
  }
  p.chunk = n_c;
  p.sub = kSub;
  if (split > 1) {
    const int per = (n_c + split - 1) / split;
    p.chunk = (per + Slices - 1) / Slices * Slices;
    split = (n_c + p.chunk - 1) / p.chunk;
    const int sub = p.chunk / Slices;
    p.sub = sub < kSub ? sub : kSub;
  }
  p.split = split;
  p.grid = dim3(static_cast<unsigned>(tiles * split),
                static_cast<unsigned>(groups), static_cast<unsigned>(outs));
  p.smem = p.s == SMax ? smem_bytes<T, D, E, SMax, kSub, Rows, Slices, Untied>()
                       : smem_bytes<T, D, E, 1, kSub, Rows, Slices, Untied>();
  return p;
}

// K1, K2, K3 and K1's grouped form (Sets: blockDim.z scenario sets of S
// each, every set a block of its own but for the barriers; blam a group's
// slab of BT, float or double, widened to T where it is read). A block's
// scenarios are those of block y of its group: group blockIdx.y / gblocks,
// whose `group` scenarios read that group's blam slab (an ungrouped
// launch: one group of all B, gblocks = grid.y).
template <typename T, int D, int E, Variant V, int S, int kSub, int Rows,
          int Slices, bool Untied, bool Split, typename BT = T,
          bool Sets = false>
__global__ void __launch_bounds__(Rows * Slices *
                                  (Sets ? group_sets(D, E) : 1))
rw_tied_kernel(const T* __restrict__ g, const T* __restrict__ dv,
               const T* __restrict__ a, const T* __restrict__ aod,
               const BT* __restrict__ blam, T* __restrict__ rw, int b_total,
               int n_out, int n_c, int e_total, int split, int chunk,
               int sub, int group, int gblocks) {
  static_assert(V != Variant::kHwExp || std::is_same_v<T, float>,
                "__expf exists for float only");
  static_assert(!Untied || (E == 1 && V == Variant::kFull),
                "the untied mode is K1 at one output a block");
  constexpr int W1 = D + 1;
  constexpr int DP = pad4(D);
  constexpr int WP = pad4(W1);
  static_assert(!Sets || (!Untied && !Split && V == Variant::kFull),
                "the grouped form is K1 unsplit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // A scenario set's own staging buffers and partials.
  const int set = Sets ? static_cast<int>(threadIdx.z) : 0;
  T* smem = reinterpret_cast<T*>(smem_raw) +
            set * (smem_bytes<T, D, E, S, kSub, Rows, Slices, Untied>() /
                   sizeof(T));

  constexpr int kTile = Slices * kSub;   // the staging buffers' rows
  constexpr int nthreads = Rows * Slices;
  const int r = threadIdx.x;
  const int k = threadIdx.y;
  const int tid = k * Rows + r;
  // The split instances read split, chunk and sub; the others sum the whole
  // contraction in tiles of kTile rows, all compile-time constants.
  const int n_split = Split ? split : 1;
  const int bx = static_cast<int>(blockIdx.x);
  const int rank = Split ? bx % split : 0;   // the block's rank in its cluster
  const int row0 = (Split ? bx / split : bx) * Rows;  // the block's first row
  const int i = row0 + r;
  const int grp = static_cast<int>(blockIdx.y) / gblocks;
  const int sets = Sets ? static_cast<int>(blockDim.z) : 1;
  const int b0 = grp * group +
                 ((static_cast<int>(blockIdx.y) - grp * gblocks) * sets + set) * S;
  // The block's scenarios end with its group's.
  const int b_end = min(b_total, (grp + 1) * group);
  // Untied: this block's output; g, dv and rw are laid out (B, E, ...).
  const int eo = Untied ? static_cast<int>(blockIdx.z) : 0;
  const int e_out = Untied ? e_total : E;
  const bool row_ok = i < n_out;
  // Two staging buffers, each a (S, kTile, DP) block of a, a (S, kTile, WP)
  // block of aod and, untied, a (S, kTile) block of dv: tile t + 1 is copied
  // in (cp.async) while tile t is used.
  constexpr int buf_elems = S * kTile * (DP + WP + (Untied ? 1 : 0));
  const int sub_rows = Split ? sub : kSub;
  const int tile = Slices * sub_rows;
  const int jbeg = Split ? rank * chunk : 0;
  const int jend = Split ? min(n_c, jbeg + chunk) : n_c;

  // Stage the contraction rows [j0, j0 + tile) of a and aod (and dv) for the
  // block's scenarios into buf, asynchronously; a scenario past B is filled
  // with 0. Every variant stages as K1 does: cp.async is never dropped by
  // nvcc, so each variant's time differs from K1's by its own stage alone.
  auto stage = [&](int j0, T* buf) {
    const int jn = min(tile, jend - j0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool b_ok = b0 + s < b_end;
      const size_t base = b_ok ? static_cast<size_t>(b0 + s) * n_c + j0 : 0;
      for (int q = tid; q < jn * D; q += nthreads) {
        const int jj = q / D;
        cp_async(buf + (s * kTile + jj) * DP + q - jj * D, a + base * D + q,
                 b_ok);
      }
      T* buf_aod = buf + S * kTile * DP;
      for (int q = tid; q < jn * W1; q += nthreads) {
        const int jj = q / W1;
        cp_async(buf_aod + (s * kTile + jj) * WP + q - jj * W1,
                 aod + base * W1 + q, b_ok);
      }
      if constexpr (Untied) {
        const size_t dbase =
            b_ok ? (static_cast<size_t>(b0 + s) * e_total + eo) * n_c + j0 : 0;
        for (int q = tid; q < jn; q += nthreads)
          cp_async(buf + S * kTile * (DP + WP) + s * kTile + q, dv + dbase + q,
                   b_ok);
      }
    }
  };

  T gi[S][D];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int kk = 0; kk < D; ++kk)
      gi[s][kk] = (row_ok && b0 + s < b_end)
                      ? g[((static_cast<size_t>(b0 + s) * (Untied ? e_total : 1)
                            + eo) * n_out + i) * D + kk]
                      : T(0);

  T acc[S][E][W1];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int c = 0; c < W1; ++c) acc[s][e][c] = T(0);

  // blam[e, j, i] of the block's slab (and, untied, output) as T.
  const BT* blam_e = blam + (static_cast<size_t>(grp) * E + eo) * n_c * n_out;
  auto blam_at = [&](int e, int j) {
    return T(blam_e[(static_cast<size_t>(e) * n_c + j) * n_out + i]);
  };
  const int n_tiles = jend > jbeg ? (jend - jbeg + tile - 1) / tile : 0;
  if (n_tiles > 0) stage(jbeg, smem);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = jbeg + t * tile;
    const int jn = min(tile, jend - j0);
    const T* s_a = smem + (t & 1) * buf_elems;        // (S, kTile, DP)
    const T* s_aod = s_a + S * kTile * DP;            // (S, kTile, WP)
    const T* s_dv = s_aod + S * kTile * WP;           // untied: (S, kTile)
    // The other buffer was last read in tile t - 1, before its barrier.
    if (t + 1 < n_tiles) stage(j0 + tile, smem + ((t + 1) & 1) * buf_elems);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    if (row_ok) {
      if constexpr (V == Variant::kEmpty) {
        if (k == 0) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const T bl = blam_at(e, j0);
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s][e][0] += bl;
          }
        }
      } else {
        const int jhi = min((k + 1) * sub_rows, jn);
#pragma unroll 2
        for (int jj = k * sub_rows; jj < jhi; ++jj) {
          T bl[E];
          if constexpr (V != Variant::kNoMul) {
#pragma unroll
            for (int e = 0; e < E; ++e)
              bl[e] = blam_at(e, j0 + jj);
          }
#pragma unroll
          for (int s = 0; s < S; ++s) {
            T w;
            if constexpr (V == Variant::kNoP) {
              w = gi[s][0];
            } else {
              T av[DP];
              load_row(s_a + (s * kTile + jj) * DP, av);
              T p = T(0);
#pragma unroll
              for (int kk = 0; kk < D; ++kk) p = fma(av[kk], gi[s][kk], p);
              if constexpr (V == Variant::kNoExp)
                w = T(-0.25) * p;
              else if constexpr (V == Variant::kHwExp)
                w = __expf(T(-0.25) * p);
              else
                w = accurate_exp(T(-0.25) * p);
            }
            if constexpr (Untied) w *= s_dv[s * kTile + jj];
            T od[WP];
            if constexpr (V != Variant::kNoDots)
              load_row(s_aod + (s * kTile + jj) * WP, od);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              T bw;
              if constexpr (V == Variant::kNoMul)
                bw = w;
              else
                bw = bl[e] * w;
              if constexpr (V == Variant::kNoDots) {
                acc[s][e][0] += bw;
              } else {
#pragma unroll
                for (int c = 0; c < W1; ++c)
                  acc[s][e][c] = fma(bw, od[c], acc[s][e][c]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // tile t is consumed: its buffer may be refilled
  }

  // The slices' partials, (slice, scenario, output, column, row) with row
  // stride Rows + 1, then each (scenario, output, row, column) summed over
  // the slices in the order 0 .. Slices-1 by one thread: into rw where the
  // block is the whole contraction (split = 1), else into slice 0's place
  // for the ranks' sum. Every copy has landed: the last group committed
  // was empty.
  constexpr int rp = Rows + 1;
  constexpr int kSec = S * E * W1;  // one slice's (s, e, c) planes
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int c = 0; c < W1; ++c)
        smem[((k * S + s) * E + e) * W1 * rp + c * rp + r] = acc[s][e][c];
  __syncthreads();
  constexpr int per_se = Rows * W1;
  constexpr int n_sums = S * E * per_se;
  // (b, e, row, column) of sum q, and its offset in the partials.
  auto where = [&](int q, int& b, int& e, int& ii, int& c) {
    const int se = q / per_se;
    const int rc = q - se * per_se;
    const int rr = rc / W1;
    c = rc - rr * W1;
    b = b0 + se / E;
    e = eo + se % E;
    ii = row0 + rr;
    return (se * W1 + c) * rp + rr;
  };
  auto store = [&](int b, int e, int ii, int c, T sum) {
    rw[((static_cast<size_t>(b) * e_out + e) * n_out + ii) * W1 + c] =
        dv[(static_cast<size_t>(b) * (Untied ? e_total : 1) + eo) * n_out +
           ii] * sum;
  };
  for (int q = tid; q < n_sums; q += nthreads) {
    int b, e, ii, c;
    const int off = where(q, b, e, ii, c);
    if (n_split == 1 && (b >= b_end || ii >= n_out)) continue;
    T sum = smem[off];
#pragma unroll
    for (int kk = 1; kk < Slices; ++kk) sum += smem[kk * kSec * rp + off];
    if (n_split == 1)
      store(b, e, ii, c, sum);
    else
      smem[off] = sum;
  }
  if (Split && n_split > 1) {
    // Every rank's partial is in its own shared memory; each rank then adds
    // a share of the sums over the ranks in the order 0 .. split-1.
    cluster_sync();
    for (int q = rank * nthreads + tid; q < n_sums; q += split * nthreads) {
      int b, e, ii, c;
      const int off = where(q, b, e, ii, c);
      if (b >= b_end || ii >= n_out) continue;
      T sum = ld_cluster(smem + off, 0);
      for (int kk = 1; kk < split; ++kk) sum += ld_cluster(smem + off, kk);
      store(b, e, ii, c, sum);
    }
    cluster_sync();  // no block leaves while another reads its partial
  }
}

// Launch instance (S, Split) of the kernel at plan p (split = 1: a plain
// launch; else a cluster of p.split blocks along x by cudaLaunchKernelEx).
template <typename T, int D, int E, Variant V, int S, int kSub, int Rows,
          int Slices, bool Untied, bool Split>
cudaError_t launch_at(const RwArgs<T>& a, int e_total, const Plan& p) {
  static_assert(Rows % 32 == 0 && Rows * Slices <= 1024,
                "a block of whole warps");
  if (!Split && p.split != 1) return cudaErrorInvalidValue;
  if (p.grid.y > static_cast<unsigned>(kMaxGridY)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = dim3(Rows, Slices);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  // An ungrouped launch is one group of all B over all of grid.y.
  const auto kernel =
      rw_tied_kernel<T, D, E, V, S, kSub, Rows, Slices, Untied, Split>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, kernel, a.g, a.dv, a.a, a.aod, a.blam,
                             a.rw, a.b, a.n_out, a.n_c, e_total, p.split,
                             p.chunk, p.sub, a.b,
                             static_cast<int>(p.grid.y));
  // A refused launch leaves its error as the thread's last error too: read
  // it here, so that the next launch (PyTorch's own among them) starts clean.
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The probe's launch of a variant: S scenarios a block, no split, the
// staged tile Slices * kSub rows (K1's launch before the small-B plan).
template <typename T, int D, int E, Variant V = Variant::kFull,
          int S = scenarios<T, D, E>(), int kSub = kSubRows, int Rows = kRows,
          int Slices = kSlices>
cudaError_t launch(const RwArgs<T>& a) {
  Plan p{};
  p.s = S;
  p.split = 1;
  p.chunk = a.n_c;
  p.sub = kSub;
  p.grid = dim3((a.n_out + Rows - 1) / Rows, (a.b + S - 1) / S, 1);
  p.smem = smem_bytes<T, D, E, S, kSub, Rows, Slices>();
  return launch_at<T, D, E, V, S, kSub, Rows, Slices, false, false>(a, E, p);
}

// Whether the plan (S, split) launches the split instance: every split
// plan, and S = 1 below S_max unsplit (a split instance at split 1 sums as
// the unsplit one), so that three instances serve every plan.
template <int SMax>
constexpr bool split_instance(int s, int split) {
  return split > 1 || (SMax > 1 && s == 1);
}

// K1 (tied, E outputs from one chain) or K2 (untied, e_total outputs on the
// grid) at the plan of plan_of for a card of `sms` SMs: S_max unsplit,
// S_max split, or S = 1 (split or not).
template <typename T, int D, int E, Variant V, bool Untied>
cudaError_t launch_planned(const RwArgs<T>& a, int e_total, int sms,
                           int max_split) {
  constexpr int SMax = scenarios<T, D, E>();
  const Plan p = plan_of<T, D, E, SMax, kSubRows, kRows, kSlices, Untied>(
      a.b, a.n_out, a.n_c, Untied ? e_total : 1, sms, max_split);
  if (!split_instance<SMax>(p.s, p.split))
    return launch_at<T, D, E, V, SMax, kSubRows, kRows, kSlices, Untied,
                     false>(a, e_total, p);
  if (p.s == SMax)
    return launch_at<T, D, E, V, SMax, kSubRows, kRows, kSlices, Untied,
                     true>(a, e_total, p);
  if constexpr (SMax > 1)
    return launch_at<T, D, E, V, 1, kSubRows, kRows, kSlices, Untied, true>(
        a, e_total, p);
  return cudaErrorInvalidValue;
}

// f(Int<D>{}) for runtime d in 1 .. 8, else `bad`.
template <typename R, typename F>
R with_d(int d, R bad, F f) {
  switch (d) {
    case 1: return f(Int<1>{});
    case 2: return f(Int<2>{});
    case 3: return f(Int<3>{});
    case 4: return f(Int<4>{});
    case 5: return f(Int<5>{});
    case 6: return f(Int<6>{});
    case 7: return f(Int<7>{});
    case 8: return f(Int<8>{});
    default: return bad;
  }
}

// K1 at its plan.
template <typename T>
cudaError_t dispatch(int d, int e, const RwArgs<T>& p, int sms, int max_split) {
  if (p.b <= 0 || p.n_out <= 0 || p.n_c < 0 || sms <= 0 || max_split < 1)
    return cudaErrorInvalidValue;
  return with_de(d, e, cudaErrorInvalidValue, [&](auto dd, auto ee) {
    return launch_planned<T, decltype(dd)::value, decltype(ee)::value,
                          Variant::kFull, false>(p, decltype(ee)::value, sms,
                                                 max_split);
  });
}

// A tied launch of this body alone, float's only one: body -1 (the route)
// or 0 (the f64 library routes by dispatch_routed, rw_tied_f64_body.cuh).
template <typename T>
cudaError_t dispatch_scalar_tied(int d, int e, const RwArgs<T>& p, int sms,
                                 int max_split, int body) {
  if (body < -1 || body > 0) return cudaErrorInvalidValue;
  return dispatch<T>(d, e, p, sms, max_split);
}

// ----------------------------------------------- K1's grouped form here --
// The grouped launch of this body at (D, E): group_blocks over
// group_sets(D, E) sets of one scenario, kGroupRows x kSlices threads a
// set, each set's shared memory that of an S = 1 block of kGroupRows rows.
template <typename T, int D, int E>
GroupPlan group_plan_scalar(int b, int n_out, int group) {
  GroupPlan p{};
  group_blocks(group, group_sets(D, E), &p.sets, &p.gblocks);
  p.grid = dim3(static_cast<unsigned>((n_out + kGroupRows - 1) / kGroupRows),
                static_cast<unsigned>((b / group) * p.gblocks));
  p.block = dim3(kGroupRows, kSlices, static_cast<unsigned>(p.sets));
  p.smem = static_cast<size_t>(p.sets) *
           smem_bytes<T, D, E, 1, kSubRows, kGroupRows, kSlices>();
  return p;
}

// Whether a grouped launch's sizes are ones a plan exists for.
inline bool group_ok(int b, int n_out, int n_c, int group) {
  return b > 0 && n_out > 0 && n_c >= 0 && group > 0 && b % group == 0;
}

template <typename T, typename BT, int D, int E>
cudaError_t launch_grouped_scalar(const GroupArgs<T>& a, const GroupPlan& p) {
  const auto kernel = rw_tied_kernel<T, D, E, Variant::kFull, 1, kSubRows,
                                     kGroupRows, kSlices, false, false, BT,
                                     true>;
  if (p.sets < 1 || p.sets > group_sets(D, E) ||
      p.grid.y > static_cast<unsigned>(kMaxGridY))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err == cudaSuccess)
    kernel<<<p.grid, p.block, p.smem, a.stream>>>(
        a.g, a.dv, a.a, a.aod, static_cast<const BT*>(a.blam), a.rw, a.b,
        a.n_out, a.n_c, E, 1, a.n_c, kSubRows, a.group, p.gblocks);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// K1's grouped form in this body, its slab of BT.
template <typename T, typename BT>
cudaError_t dispatch_grouped_scalar(int d, int e, const GroupArgs<T>& a) {
  if (!group_ok(a.b, a.n_out, a.n_c, a.group)) return cudaErrorInvalidValue;
  return with_de(d, e, cudaErrorInvalidValue, [&](auto dd, auto ee) {
    constexpr int D = decltype(dd)::value;
    constexpr int E = decltype(ee)::value;
    return launch_grouped_scalar<T, BT, D, E>(
        a, group_plan_scalar<T, D, E>(a.b, a.n_out, a.group));
  });
}

// A grouped plan as the wrapper's check reads it: out = sets, blocks a
// group, grid x, y, block x, y, z, shared bytes.
inline int put_group_plan(const GroupPlan& p, long long* out) {
  const long long v[8] = {p.sets, p.gblocks, p.grid.x, p.grid.y, p.block.x,
                          p.block.y, p.block.z, static_cast<long long>(p.smem)};
  for (int q = 0; q < 8; ++q) out[q] = v[q];
  return 0;
}

template <typename T>
int group_plan_export_scalar(int b, int n_out, int d, int e, int group,
                             long long* out) {
  if (!group_ok(b, n_out, 0, group)) return -1;
  return with_de(d, e, -1, [&](auto dd, auto ee) {
    return put_group_plan(
        group_plan_scalar<T, decltype(dd)::value, decltype(ee)::value>(
            b, n_out, group), out);
  });
}

template <typename T>
cudaError_t dispatch_untied(int d, int e, const RwArgs<T>& p, int sms,
                            int max_split) {
  if (p.b <= 0 || p.n_out <= 0 || p.n_c != p.n_out || e < 1 || e > 8 ||
      sms <= 0 || max_split < 1)
    return cudaErrorInvalidValue;
  return with_d(d, cudaErrorInvalidValue, [&](auto dd) {
    return launch_planned<T, decltype(dd)::value, 1, Variant::kFull, true>(
        p, e, sms, max_split);
  });
}

// The plan of a K1 (untied 0) or K2 (untied 1) launch, for the wrapper's
// check: out = S, split, chunk, sub, grid x, y, z, shared bytes.
template <typename T>
int plan_export(int b, int n_out, int n_c, int d, int e, int untied, int sms,
                long long* out) {
  auto put = [&](const Plan& p) {
    const long long v[8] = {p.s, p.split, p.chunk, p.sub, p.grid.x, p.grid.y,
                            p.grid.z, static_cast<long long>(p.smem)};
    for (int q = 0; q < 8; ++q) out[q] = v[q];
    return 0;
  };
  if (untied)
    return with_d(d, -1, [&](auto dd) {
      constexpr int D = decltype(dd)::value;
      return put(plan_of<T, D, 1, scenarios<T, D, 1>(), kSubRows, kRows,
                         kSlices, true>(b, n_out, n_c, e, sms, kMaxSplit));
    });
  return with_de(d, e, -1, [&](auto dd, auto ee) {
    constexpr int D = decltype(dd)::value;
    constexpr int E = decltype(ee)::value;
    return put(plan_of<T, D, E, scenarios<T, D, E>(), kSubRows, kRows, kSlices,
                       false>(b, n_out, n_c, 1, sms, kMaxSplit));
  });
}

template <typename T>
long long scenarios_of(int d, int e) {
  return with_de(d, e, 0LL, [](auto dd, auto ee) {
    return static_cast<long long>(
        scenarios<T, decltype(dd)::value, decltype(ee)::value>());
  });
}

template <typename T>
long long smem_of(int d, int e) {
  return with_de(d, e, -1LL, [](auto dd, auto ee) {
    constexpr int D = decltype(dd)::value;
    constexpr int E = decltype(ee)::value;
    return static_cast<long long>(
        smem_bytes<T, D, E, scenarios<T, D, E>()>());
  });
}

// Blocks of K1 (kFull; untied: K2's) of the instance a plan (S, split)
// launches that an SM holds at once; -1 on an error or an S that is not
// built.
template <typename T, int D, int E, int S, bool Untied, bool Split>
long long blocks_per_sm_at() {
  const auto kernel = rw_tied_kernel<T, D, E, Variant::kFull, S, kSubRows,
                                     kRows, kSlices, Untied, Split>;
  constexpr size_t smem =
      smem_bytes<T, D, E, S, kSubRows, kRows, kSlices, Untied>();
  int n = 0;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, kRows * kSlices, smem) != cudaSuccess)
    return -1LL;
  return static_cast<long long>(n);
}

template <typename T, int D, int E, bool Untied>
long long blocks_per_sm_s(int s, int split) {
  constexpr int SMax = scenarios<T, D, E>();
  const bool sp = split_instance<SMax>(s, split);
  if (s == SMax)
    return sp ? blocks_per_sm_at<T, D, E, SMax, Untied, true>()
              : blocks_per_sm_at<T, D, E, SMax, Untied, false>();
  if constexpr (SMax > 1)
    if (s == 1) return blocks_per_sm_at<T, D, E, 1, Untied, true>();
  return -1LL;
}

template <typename T>
long long blocks_per_sm_of(int d, int e, int untied, int s, int split) {
  if (untied)
    return with_d(d, -1LL, [&](auto dd) {
      return blocks_per_sm_s<T, decltype(dd)::value, 1, true>(s, split);
    });
  return with_de(d, e, -1LL, [&](auto dd, auto ee) {
    return blocks_per_sm_s<T, decltype(dd)::value, decltype(ee)::value,
                           false>(s, split);
  });
}

}  // namespace

// The plain C interface of one dtype's K1 and K2 instances, for ctypes: the
// launches (return their cudaError_t, 0 on success; asynchronous on
// `stream`; `sms` is the card's SM count and `max_split` the largest
// cluster the plan may take, kMaxSplit on every path; K1's `body` is -1 for
// the route of TIED_DISPATCH, 0 for this body, 1 for the f64 library's
// tensor-core body, rw_tied_f64_body.cuh), the compiled plans for the
// wrapper's check at load (long long, as ctypes reads it: S_max and the
// dynamic shared bytes of an S_max launch per (d, E), 0 / -1 outside d, E
// in 1 .. 8; kRows, kSlices, kSubRows, kMaxSplit, kSplitRows, kSplitFill;
// a launch's whole plan), the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the error string.
// K1's grouped form has a library of its own (variance_trace_grouped.cu).
#define GPMPC_RW_TIED_EXPORTS(T, SUFFIX, TIED_DISPATCH)                        \
  extern "C" int gpmpc_rw_tied_##SUFFIX(                                      \
      const T* g, const T* dv, const T* a, const T* aod, const T* blam,       \
      T* rw, int b, int n_out, int n_c, int d, int e, int sms, int max_split, \
      int body, void* stream) {                                               \
    const RwArgs<T> p{g, dv, a, aod, blam, rw, b, n_out, n_c,                 \
                      static_cast<cudaStream_t>(stream)};                     \
    return static_cast<int>(TIED_DISPATCH(d, e, p, sms, max_split, body));    \
  }                                                                           \
  extern "C" int gpmpc_rw_untied_##SUFFIX(                                    \
      const T* g, const T* dv, const T* a, const T* ao, const T* blam, T* rw, \
      int b, int n, int d, int e, int sms, int max_split, void* stream) {     \
    const RwArgs<T> p{g, dv, a, ao, blam, rw, b, n, n,                        \
                      static_cast<cudaStream_t>(stream)};                     \
    return static_cast<int>(dispatch_untied<T>(d, e, p, sms, max_split));     \
  }                                                                           \
  extern "C" int gpmpc_rw_tied_plan_##SUFFIX(int b, int n_out, int n_c, int d, \
                                             int e, int untied, int sms,      \
                                             long long* out) {                \
    return plan_export<T>(b, n_out, n_c, d, e, untied, sms, out);             \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_scenarios_##SUFFIX(int d, int e) {       \
    return scenarios_of<T>(d, e);                                             \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_smem_##SUFFIX(int d, int e) {            \
    return smem_of<T>(d, e);                                                  \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_blocks_per_sm_##SUFFIX(                  \
      int d, int e, int untied, int s, int split) {                           \
    return blocks_per_sm_of<T>(d, e, untied, s, split);                       \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_rows_##SUFFIX() { return kRows; }        \
  extern "C" long long gpmpc_rw_tied_slices_##SUFFIX() { return kSlices; }    \
  extern "C" long long gpmpc_rw_tied_sub_rows_##SUFFIX() { return kSubRows; } \
  extern "C" long long gpmpc_rw_tied_max_split_##SUFFIX() {                   \
    return kMaxSplit;                                                         \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_split_rows_##SUFFIX() {                  \
    return kSplitRows;                                                        \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_split_fill_##SUFFIX() {                  \
    return kSplitFill;                                                        \
  }                                                                           \
  extern "C" const char* gpmpc_rw_tied_error_string_##SUFFIX(int err) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                 \
  }
