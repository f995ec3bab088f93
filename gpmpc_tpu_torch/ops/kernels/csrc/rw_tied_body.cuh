// K1's body: the tied variance-trace column sweep, templated on its variants.
//
// One source for the kernel the solve launches (variance_trace_tied.cu, which
// instantiates Variant::kFull at kTile = 128 only) and for the probe that
// times it with one stage removed at a time (variance_trace_probe.cu). The
// probe therefore times the code the solve runs, never a copy of it.
//
// For scenario b, output e, output row i and column c in [0, 1 + d):
//
//   rw[b,e,i,c] = dv[b,i] * sum_j blam[e,j,i] * exp(-1/4 sum_k a[b,j,k] g[b,i,k])
//                                             * aod[b,j,c]
//
// One thread owns one output row i and keeps g_i and its E * (1+d)
// accumulators in registers; the block stages kTile contraction rows a_j and
// aod_j in shared memory, where every thread reads the same word (a
// broadcast); blam[e, j, i] is read with i contiguous across the warp.
//
// The variants (each a defined function; Variant::kFull is K1 exactly):
//   kFull    K1.
//   kHwExp   __expf (the SFU approximation) in place of expf.
//   kNoExp   w = -p / 4: the exponent's FMAs without the exp.
//   kNoP     w = g_i[0]: no exponent FMAs and no exp.
//   kNoDots  acc[e][0] += blam * w; columns 1..d stay 0.
//   kNoMul   bw = w: no blam read and no blam multiply.
//   kEmpty   the staging of a and aod as K1 does it, and acc[e][0] +=
//            blam[e, j0, i] once per tile: no pair loop. The floor of launch,
//            staging and stores.
//
// Included by .cu files that are each built into their own shared library;
// the anonymous namespace keeps every symbol local to its library.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kRows = 128;  // threads per block = output rows per block

enum class Variant : int { kFull, kHwExp, kNoExp, kNoP, kNoDots, kNoMul, kEmpty };

__device__ __forceinline__ float accurate_exp(float x) { return expf(x); }
__device__ __forceinline__ double accurate_exp(double x) { return exp(x); }

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

template <typename T, int D, int E, Variant V = Variant::kFull,
          int kTile = 128>
__global__ void __launch_bounds__(kRows)
rw_tied_kernel(const T* __restrict__ g, const T* __restrict__ dv,
               const T* __restrict__ a, const T* __restrict__ aod,
               const T* __restrict__ blam, T* __restrict__ rw, int n_out,
               int n_c) {
  static_assert(V != Variant::kHwExp || std::is_same_v<T, float>,
                "__expf exists for float only");
  constexpr int W1 = D + 1;
  // Every variant stages a and aod as K1 does. An array a variant never reads
  // (kEmpty: both, kNoP: a, kNoDots: aod) is staged through volatile, which
  // keeps nvcc from dropping its staging, so each variant's time differs from
  // K1's by its own stage and not by the staging of its operands.
  using StagedA = std::conditional_t<
      V == Variant::kEmpty || V == Variant::kNoP, volatile T, T>;
  using StagedAod = std::conditional_t<
      V == Variant::kEmpty || V == Variant::kNoDots, volatile T, T>;
  __shared__ StagedA s_a[kTile * D];
  __shared__ StagedAod s_aod[kTile * W1];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const bool row_ok = i < n_out;

  T gi[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    gi[k] = row_ok ? g[(static_cast<size_t>(b) * n_out + i) * D + k] : T(0);

  T acc[E][W1];
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int c = 0; c < W1; ++c) acc[e][c] = T(0);

  const T* a_b = a + static_cast<size_t>(b) * n_c * D;
  const T* aod_b = aod + static_cast<size_t>(b) * n_c * W1;

  for (int j0 = 0; j0 < n_c; j0 += kTile) {
    const int jn = min(kTile, n_c - j0);
    __syncthreads();  // the previous tile is consumed
    for (int t = threadIdx.x; t < jn * D; t += kRows)
      s_a[t] = a_b[static_cast<size_t>(j0) * D + t];
    for (int t = threadIdx.x; t < jn * W1; t += kRows)
      s_aod[t] = aod_b[static_cast<size_t>(j0) * W1 + t];
    __syncthreads();
    if (row_ok) {
      const T* blam_j = blam + static_cast<size_t>(j0) * n_out + i;
      if constexpr (V == Variant::kEmpty) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[e][0] += blam_j[static_cast<size_t>(e) * n_c * n_out];
      } else {
#pragma unroll 2
        for (int jj = 0; jj < jn; ++jj) {
          T w;
          if constexpr (V == Variant::kNoP) {
            w = gi[0];
          } else {
            T p = T(0);
#pragma unroll
            for (int k = 0; k < D; ++k) p = fma(s_a[jj * D + k], gi[k], p);
            if constexpr (V == Variant::kNoExp)
              w = T(-0.25) * p;
            else if constexpr (V == Variant::kHwExp)
              w = __expf(T(-0.25) * p);
            else
              w = accurate_exp(T(-0.25) * p);
          }
#pragma unroll
          for (int e = 0; e < E; ++e) {
            T bw;
            if constexpr (V == Variant::kNoMul)
              bw = w;
            else
              bw = blam_j[(static_cast<size_t>(e) * n_c + jj) * n_out] * w;
            if constexpr (V == Variant::kNoDots) {
              acc[e][0] += bw;
            } else {
#pragma unroll
              for (int c = 0; c < W1; ++c)
                acc[e][c] = fma(bw, s_aod[jj * W1 + c], acc[e][c]);
            }
          }
        }
      }
    }
  }

  if (!row_ok) return;
  const T dvi = dv[static_cast<size_t>(b) * n_out + i];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    T* out = rw + ((static_cast<size_t>(b) * E + e) * n_out + i) * W1;
#pragma unroll
    for (int c = 0; c < W1; ++c) out[c] = dvi * acc[e][c];
  }
}

template <typename T, int D, int E, Variant V = Variant::kFull,
          int kTile = 128>
cudaError_t launch(const RwArgs<T>& p) {
  const dim3 grid((p.n_out + kRows - 1) / kRows, p.b);
  rw_tied_kernel<T, D, E, V, kTile><<<grid, kRows, 0, p.stream>>>(
      p.g, p.dv, p.a, p.aod, p.blam, p.rw, p.n_out, p.n_c);
  return cudaGetLastError();
}

}  // namespace
