// K1's body: the tied variance-trace column sweep, templated on its variants.
//
// One source for the kernel the solve launches (variance_trace_tied.cu: K1,
// and K2 and K3, which launch K1 at E = 1 and on a rectangle) and for the
// probe that times it with one stage removed at a time
// (variance_trace_probe.cu). The probe therefore times the code the solve
// runs, never a copy of it. It replaces the TPU kernel
// `_make_rw_tied_streamed_kernel` (gpmpc_tpu/ops/pallas/variance_trace.py,
// dispatched by `_rw_call_tied`).
//
// For scenario b, output e, output row i and column c in [0, 1 + d):
//
//   rw[b,e,i,c] = dv[b,i] * sum_j blam[e,j,i] * exp(-1/4 sum_k a[b,j,k] g[b,i,k])
//                                             * aod[b,j,c]
//
// Bound on an H100: operations, 0.0065 ms at the headline shape (B = N =
// 256, d = 3, E = 2, f32: 2d + 2 + E (1 + 2 (1+d)) flops a pair over
// 67 TFLOP/s; chip_smoke.py's bound_ms).
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
//   - A block serves S scenarios of one tile of kRows output rows (S a
//     constexpr of (T, D, E): the accumulators S (d + E (1+d)) stay within
//     ~48 registers; 4 at the headline in f32, 1 at d = E = 8). blam is the
//     same for every scenario, so a thread loads blam[e, j, i] once per
//     (j, e) and applies it to its S scenarios' weights: 1/S of the loads,
//     and S independent exp chains to overlap with each load.
//   - The contraction is split across the kSlices warp rows of the block:
//     each staged tile of kSlices * kSub rows gives slice k its rows
//     [k kSub, (k+1) kSub), so each thread's chain is S n_c / kSlices steps.
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
//     times (its plan_* variants, PERF.md). `rw_tied_plan` in
//     ops/kernels/variance_trace.py mirrors it and checks its rows, slices,
//     S and shared bytes against this header's exports at load.
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
// Precision: the accurate expf (never __expf or --use_fast_math), exact
// FMAs in the reduction, and a double instance.
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
// so a variant's time differs from K1's by its own stage alone.
// and three template knobs: S (full_s1 sets S = 1, scenario sharing off),
// kSub (full_tile256 doubles the rows a slice takes from each tile) and the
// block shape Rows x Slices (the probe's plan_* variants).
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

enum class Variant : int { kFull, kHwExp, kNoExp, kNoP, kNoDots, kNoMul, kEmpty };

// Scenarios a block serves: its accumulators and g, S (d + E (1+d)) values
// of T, kept within ~48 registers; 1 to 4.
template <typename T, int D, int E>
__host__ __device__ constexpr int scenarios() {
  constexpr int words = static_cast<int>(sizeof(T) / 4) * (D + E * (D + 1));
  constexpr int s = 48 / words;
  return s < 1 ? 1 : (s > 4 ? 4 : s);
}

// Dynamic shared memory of a launch: two staging buffers of a tile of a and
// aod for S scenarios (rows padded to a multiple of 4), and, reusing the
// same bytes, the slices' partials (row stride Rows + 1) for their
// fixed-order sum.
template <typename T, int D, int E, int S, int Sub = kSubRows,
          int Rows = kRows, int Slices = kSlices>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr size_t stage = 2 * static_cast<size_t>(S) * Slices * Sub *
                           (pad4(D) + pad4(D + 1));
  constexpr size_t red =
      static_cast<size_t>(Slices) * S * E * (D + 1) * (Rows + 1);
  return sizeof(T) * (stage > red ? stage : red);
}

template <typename T>
struct RwArgs {
  const T* g;     // (B, n_out, d)   g = a M2 on the output rows
  const T* dv;    // (B, n_out)      exp(-q / 8) on the output rows
  const T* a;     // (B, n_c, d)     u - x on the contraction rows
  const T* aod;   // (B, n_c, 1+d)   dv o [1 | a] on the contraction rows
  const T* blam;  // (E, n_c, n_out)
  T* rw;          // (B, E, n_out, 1+d)
  int b;
  int n_out;
  int n_c;
  cudaStream_t stream;
};

template <typename T, int D, int E, Variant V, int S, int kSub, int Rows,
          int Slices>
__global__ void __launch_bounds__(Rows * Slices)
rw_tied_kernel(const T* __restrict__ g, const T* __restrict__ dv,
               const T* __restrict__ a, const T* __restrict__ aod,
               const T* __restrict__ blam, T* __restrict__ rw, int b_total,
               int n_out, int n_c) {
  static_assert(V != Variant::kHwExp || std::is_same_v<T, float>,
                "__expf exists for float only");
  constexpr int W1 = D + 1;
  constexpr int DP = pad4(D);
  constexpr int WP = pad4(W1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  constexpr int tile = Slices * kSub;
  constexpr int nthreads = Rows * Slices;
  const int r = threadIdx.x;
  const int k = threadIdx.y;
  const int tid = k * Rows + r;
  const int i = blockIdx.x * Rows + r;
  const int b0 = blockIdx.y * S;
  const bool row_ok = i < n_out;
  // Two staging buffers, each a (S, tile, DP) block of a then a (S, tile, WP)
  // block of aod: tile t + 1 is copied in (cp.async) while tile t is used.
  constexpr int buf_elems = S * tile * (DP + WP);

  // Stage the contraction rows [j0, j0 + tile) of a and aod for the block's
  // scenarios into buf, asynchronously; a scenario past B is filled with 0.
  // Every variant stages as K1 does: cp.async is never dropped by nvcc, so
  // each variant's time differs from K1's by its own stage alone.
  auto stage = [&](int j0, T* buf) {
    const int jn = min(tile, n_c - j0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool b_ok = b0 + s < b_total;
      const size_t base = b_ok ? static_cast<size_t>(b0 + s) * n_c + j0 : 0;
      for (int q = tid; q < jn * D; q += nthreads) {
        const int jj = q / D;
        cp_async(buf + (s * tile + jj) * DP + q - jj * D, a + base * D + q,
                 b_ok);
      }
      T* buf_aod = buf + S * tile * DP;
      for (int q = tid; q < jn * W1; q += nthreads) {
        const int jj = q / W1;
        cp_async(buf_aod + (s * tile + jj) * WP + q - jj * W1,
                 aod + base * W1 + q, b_ok);
      }
    }
  };

  T gi[S][D];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int kk = 0; kk < D; ++kk)
      gi[s][kk] = (row_ok && b0 + s < b_total)
                      ? g[(static_cast<size_t>(b0 + s) * n_out + i) * D + kk]
                      : T(0);

  T acc[S][E][W1];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int c = 0; c < W1; ++c) acc[s][e][c] = T(0);

  const int n_tiles = (n_c + tile - 1) / tile;
  if (n_tiles > 0) stage(0, smem);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * tile;
    const int jn = min(tile, n_c - j0);
    const T* s_a = smem + (t & 1) * buf_elems;        // (S, tile, DP)
    const T* s_aod = s_a + S * tile * DP;             // (S, tile, WP)
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
            const T bl = blam[(static_cast<size_t>(e) * n_c + j0) * n_out + i];
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s][e][0] += bl;
          }
        }
      } else {
        const int jhi = min((k + 1) * kSub, jn);
#pragma unroll 2
        for (int jj = k * kSub; jj < jhi; ++jj) {
          T bl[E];
          if constexpr (V != Variant::kNoMul) {
#pragma unroll
            for (int e = 0; e < E; ++e)
              bl[e] = blam[(static_cast<size_t>(e) * n_c + j0 + jj) * n_out + i];
          }
#pragma unroll
          for (int s = 0; s < S; ++s) {
            T w;
            if constexpr (V == Variant::kNoP) {
              w = gi[s][0];
            } else {
              T av[DP];
              load_row(s_a + (s * tile + jj) * DP, av);
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
            T od[WP];
            if constexpr (V != Variant::kNoDots)
              load_row(s_aod + (s * tile + jj) * WP, od);
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
  // the slices in the order 0 .. Slices-1 by one thread, in rw's layout.
  // Every copy has landed: the last group committed was empty.
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
  for (int q = tid; q < S * E * per_se; q += nthreads) {
    const int se = q / per_se;
    const int rc = q - se * per_se;
    const int rr = rc / W1;
    const int c = rc - rr * W1;
    const int b = b0 + se / E;
    const int ii = blockIdx.x * Rows + rr;
    if (b >= b_total || ii >= n_out) continue;
    const int off = (se * W1 + c) * rp + rr;
    T sum = smem[off];
#pragma unroll
    for (int kk = 1; kk < Slices; ++kk) sum += smem[kk * kSec * rp + off];
    rw[((static_cast<size_t>(b) * E + se % E) * n_out + ii) * W1 + c] =
        dv[static_cast<size_t>(b) * n_out + ii] * sum;
  }
}

template <typename T, int D, int E, Variant V = Variant::kFull,
          int S = scenarios<T, D, E>(), int kSub = kSubRows, int Rows = kRows,
          int Slices = kSlices>
cudaError_t launch(const RwArgs<T>& p) {
  static_assert(Rows % 32 == 0 && Rows * Slices <= 1024,
                "a block of whole warps");
  constexpr size_t smem = smem_bytes<T, D, E, S, kSub, Rows, Slices>();
  const auto kernel = rw_tied_kernel<T, D, E, V, S, kSub, Rows, Slices>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_out + Rows - 1) / Rows, (p.b + S - 1) / S);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, dim3(Rows, Slices), smem, p.stream>>>(
      p.g, p.dv, p.a, p.aod, p.blam, p.rw, p.b, p.n_out, p.n_c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, int e, const RwArgs<T>& p) {
  if (p.b <= 0 || p.n_out <= 0 || p.n_c < 0) return cudaErrorInvalidValue;
  return with_de(d, e, cudaErrorInvalidValue, [&](auto dd, auto ee) {
    return launch<T, decltype(dd)::value, decltype(ee)::value>(p);
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

// Blocks of K1 (kFull) an SM holds at once; -1 on an error.
template <typename T>
long long blocks_per_sm_of(int d, int e) {
  return with_de(d, e, -1LL, [](auto dd, auto ee) {
    constexpr int D = decltype(dd)::value;
    constexpr int E = decltype(ee)::value;
    constexpr int S = scenarios<T, D, E>();
    const auto kernel = rw_tied_kernel<T, D, E, Variant::kFull, S, kSubRows,
                                       kRows, kSlices>;
    constexpr size_t smem = smem_bytes<T, D, E, S>();
    int n = 0;
    if (allow_smem(kernel, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, kRows * kSlices, smem) != cudaSuccess)
      return -1LL;
    return static_cast<long long>(n);
  });
}

}  // namespace

// The plain C interface of one dtype's K1 instances, for ctypes: the launch
// (returns its cudaError_t, 0 on success; asynchronous on `stream`), the
// compiled plan for the wrapper's check at load (long long, as ctypes reads
// it: S and the dynamic shared bytes of a launch per (d, E), 0 / -1 outside
// d, E in 1 .. 8; kRows, kSlices, kSubRows), the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the error string.
#define GPMPC_RW_TIED_EXPORTS(T, SUFFIX)                                       \
  extern "C" int gpmpc_rw_tied_##SUFFIX(                                      \
      const T* g, const T* dv, const T* a, const T* aod, const T* blam,       \
      T* rw, int b, int n_out, int n_c, int d, int e, void* stream) {         \
    const RwArgs<T> p{g, dv, a, aod, blam, rw, b, n_out, n_c,                 \
                      static_cast<cudaStream_t>(stream)};                     \
    return static_cast<int>(dispatch<T>(d, e, p));                            \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_scenarios_##SUFFIX(int d, int e) {       \
    return scenarios_of<T>(d, e);                                             \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_smem_##SUFFIX(int d, int e) {            \
    return smem_of<T>(d, e);                                                  \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_blocks_per_sm_##SUFFIX(int d, int e) {   \
    return blocks_per_sm_of<T>(d, e);                                         \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_rows_##SUFFIX() { return kRows; }        \
  extern "C" long long gpmpc_rw_tied_slices_##SUFFIX() { return kSlices; }    \
  extern "C" long long gpmpc_rw_tied_sub_rows_##SUFFIX() { return kSubRows; } \
  extern "C" const char* gpmpc_rw_tied_error_string_##SUFFIX(int err) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                 \
  }
