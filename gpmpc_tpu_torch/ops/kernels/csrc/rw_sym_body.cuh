// K4's body: the symmetric-pair kernels and their dispatch. The note on
// what they compute, their bound and their design is at the head of
// variance_trace_sym.cu; the float instances are built from that file and
// the double ones from variance_trace_sym_f64.cu, each into its own library.
//
// Included by .cu files that are each built into their own shared library;
// the anonymous namespace keeps every symbol local to its library.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;          // tile rows
constexpr int kLd = kT + 1;     // padded row of the blam o W chunk
constexpr int kThreads = 128;   // a pair block: 64 columns x 2 row parities
constexpr int kChunk = 16;      // rows of tile J per phase-2 round
constexpr int kSumThreads = 128;

// Scenarios a pair block serves: the column sums (E (1+d)) and the column's
// z (d a chain; one chain a scenario tied, E per-output) of one scenario, in
// 32-bit words, within ~48 registers; 1 to 4.
template <typename T, int D, int E, bool SHARED>
__host__ __device__ constexpr int sym_scenarios() {
  constexpr int words = static_cast<int>(sizeof(T) / 4) *
                        (E * (D + 1) + (SHARED ? 1 : E) * D);
  constexpr int s = 48 / words;
  return s < 1 ? 1 : (s > 4 ? 4 : s);
}

// A pair block's dynamic shared memory: blam o W (S, E, kChunk, kLd); then
// per chain aod of tiles J and I (kT, pad4(1+d)) and z of tile J
// (kT, pad4(d)).
template <typename T, int D, int E, bool SHARED>
__host__ __device__ constexpr size_t sym_smem_bytes() {
  constexpr int S = sym_scenarios<T, D, E, SHARED>();
  constexpr int C = SHARED ? S : S * E;
  return sizeof(T) * (static_cast<size_t>(S) * E * kChunk * kLd +
                      static_cast<size_t>(C) * kT *
                          (2 * pad4(D + 1) + pad4(D)));
}

template <typename T>
struct SymArgs {
  const T* z;      // (B, n, D) shared chain | (B, E, n, D) per output
  const T* aod;    // (B, n, W1)             | (B, E, n, W1)   dv o [1 | a]
  const T* dv;     // (B, n)                 | (B, E, n)
  const T* blam;   // (E, n, n)
  T* part;         // (B, nt, nt, E, kT, W1) scratch
  T* rw;           // (B, E, n, W1)
  const int* iidx; // (n_pairs,) tile pairs I <= J
  const int* jidx;
  int b;
  int n;
  int nt;
  int n_pairs;
  cudaStream_t stream;
};

template <typename T, int D, int E, bool SHARED>
__global__ void __launch_bounds__(kThreads)
rw_sym_pair_kernel(const T* __restrict__ z, const T* __restrict__ aod,
                   const T* __restrict__ blam, T* __restrict__ part,
                   const int* __restrict__ iidx, const int* __restrict__ jidx,
                   int b_total, int n, int nt) {
  constexpr int S = sym_scenarios<T, D, E, SHARED>();
  constexpr int C = SHARED ? S : S * E;   // exp chains a block
  constexpr int W1 = D + 1;
  constexpr int DP = pad4(D);
  constexpr int WP = pad4(W1);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_s = reinterpret_cast<T*>(smem_raw);       // (S, E, kChunk, kLd)
  T* s_aodj = s_s + S * E * kChunk * kLd;         // (C, kT, WP) tile J
  T* s_aodi = s_aodj + C * kT * WP;               // (C, kT, WP) tile I
  T* s_zj = s_aodi + C * kT * WP;                 // (C, kT, DP) tile J

  const int pair = blockIdx.x;
  const int b0 = blockIdx.y * S;
  const int ti = iidx[pair];
  const int tj = jidx[pair];
  const bool diag = ti == tj;
  const int i0 = ti * kT;
  const int j0 = tj * kT;
  const int ni = min(kT, n - i0);
  const int nj = min(kT, n - j0);
  const int t = threadIdx.x;
  const int col = t % kT;
  const int h = t / kT;

  // Stage each chain's z rows of tile J and aod rows of tiles J and I (by
  // cp.async, all in flight at once); keep the column's z in registers. Chain ch is scenario ch (tied) or
  // (scenario ch / E, output ch % E) (per output).
  T zi[C][D];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const int b = b0 + (SHARED ? ch : ch / E);
    const bool ok = b < b_total;
    const size_t chain = SHARED ? static_cast<size_t>(b)
                                : static_cast<size_t>(b) * E + ch % E;
    const T* z_c = z + chain * n * D;
    const T* aod_c = aod + chain * n * W1;
    for (int q = t; q < kT * D; q += kThreads) {
      const int jj = q / D;
      const bool in = ok && jj < nj;
      cp_async(s_zj + (ch * kT + jj) * DP + q - jj * D,
               in ? z_c + static_cast<size_t>(j0) * D + q : z, in);
    }
    for (int q = t; q < kT * W1; q += kThreads) {
      const int jj = q / W1;
      const int at = (ch * kT + jj) * WP + q - jj * W1;
      const bool in_j = ok && jj < nj;
      const bool in_i = ok && jj < ni;
      cp_async(s_aodj + at,
               in_j ? aod_c + static_cast<size_t>(j0) * W1 + q : aod, in_j);
      cp_async(s_aodi + at,
               in_i ? aod_c + static_cast<size_t>(i0) * W1 + q : aod, in_i);
    }
#pragma unroll
    for (int k = 0; k < D; ++k)
      zi[ch][k] = (ok && col < ni)
                      ? z_c[static_cast<size_t>(i0 + col) * D + k] : T(0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  T acc[S][E][W1];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int c = 0; c < W1; ++c) acc[s][e][c] = T(0);

  for (int jc0 = 0; jc0 < nj; jc0 += kChunk) {
    const int jce = min(jc0 + kChunk, nj);
    // Phase 1: column i = i0 + col over the rows j of the chunk with
    // j = h mod 2, into row tile I's partial; blam o W kept for phase 2.
    if (col < ni) {
#pragma unroll 2
      for (int jj = jc0 + h; jj < jce; jj += 2) {
        T bl[E];
#pragma unroll
        for (int e = 0; e < E; ++e)
          bl[e] = blam[(static_cast<size_t>(e) * n + j0 + jj) * n + i0 + col];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          T w;
          T od[WP];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            // The tied chain's exp serves every output; per output, each
            // output has a chain of its own.
            if (!SHARED || e == 0) {
              const int ch = SHARED ? s : s * E + e;
              T zv[DP];
              load_row(s_zj + (ch * kT + jj) * DP, zv);
              T p = T(0);
#pragma unroll
              for (int k = 0; k < D; ++k) p = fma(zv[k], zi[ch][k], p);
              w = accurate_exp(T(-0.25) * p);
              load_row(s_aodj + (ch * kT + jj) * WP, od);
            }
            const T v = bl[e] * w;
#pragma unroll
            for (int c = 0; c < W1; ++c) acc[s][e][c] = fma(v, od[c], acc[s][e][c]);
            if (!diag) s_s[((s * E + e) * kChunk + jj - jc0) * kLd + col] = v;
          }
        }
      }
    }
    if (diag) continue;
    __syncthreads();
    // Phase 2: one thread a (scenario, output, row j of the chunk) sums its
    // row of blam o W over the columns i of tile I into row tile J's partial.
    for (int q = t; q < S * E * kChunk; q += kThreads) {
      const int se = q / kChunk;
      const int rr = q - se * kChunk;
      const int b = b0 + se / E;
      if (jc0 + rr >= jce || b >= b_total) continue;
      const int ch = SHARED ? se / E : se;
      T acc2[W1];
#pragma unroll
      for (int c = 0; c < W1; ++c) acc2[c] = T(0);
      const T* row = s_s + (se * kChunk + rr) * kLd;
#pragma unroll 2
      for (int ii = 0; ii < ni; ++ii) {
        T od[WP];
        load_row(s_aodi + (ch * kT + ii) * WP, od);
        const T v = row[ii];
#pragma unroll
        for (int c = 0; c < W1; ++c) acc2[c] = fma(v, od[c], acc2[c]);
      }
      T* out = part + ((((static_cast<size_t>(b) * nt + tj) * nt + ti) * E +
                        se % E) * kT + jc0 + rr) * W1;
#pragma unroll
      for (int c = 0; c < W1; ++c) out[c] = acc2[c];
    }
    __syncthreads();  // s_s is free for the next chunk
  }

  // The two parities' column sums, even + odd, through s_s laid out
  // (S, E, W1, kT).
  if (h == 1) {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int c = 0; c < W1; ++c)
          s_s[((s * E + e) * W1 + c) * kT + col] = acc[s][e][c];
  }
  __syncthreads();
  if (h != 0) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int b = b0 + s;
    if (b >= b_total) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      T* out = part + ((((static_cast<size_t>(b) * nt + ti) * nt + tj) * E + e)
                       * kT + col) * W1;
#pragma unroll
      for (int c = 0; c < W1; ++c)
        out[c] = acc[s][e][c] + s_s[((s * E + e) * W1 + c) * kT + col];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kSumThreads)
rw_sym_sum_kernel(const T* __restrict__ part, const T* __restrict__ dv,
                  T* __restrict__ rw, int n, int nt, int E, bool shared) {
  constexpr int W1 = D + 1;
  const int b = blockIdx.y;
  const int r = blockIdx.x * kSumThreads + threadIdx.x;
  if (r >= n) return;
  const int tr = r / kT;
  const int lr = r % kT;
  for (int e = 0; e < E; ++e) {
    T acc[W1];
#pragma unroll
    for (int c = 0; c < W1; ++c) acc[c] = T(0);
    for (int k = 0; k < nt; ++k) {
      const T* p = part + ((((static_cast<size_t>(b) * nt + tr) * nt + k) * E + e) * kT + lr) * W1;
#pragma unroll
      for (int c = 0; c < W1; ++c) acc[c] += p[c];
    }
    const T d = shared ? dv[static_cast<size_t>(b) * n + r]
                       : dv[(static_cast<size_t>(b) * E + e) * n + r];
    T* out = rw + ((static_cast<size_t>(b) * E + e) * n + r) * W1;
#pragma unroll
    for (int c = 0; c < W1; ++c) out[c] = d * acc[c];
  }
}

template <typename T, int D, int E, bool SHARED>
cudaError_t launch(const SymArgs<T>& p) {
  constexpr int S = sym_scenarios<T, D, E, SHARED>();
  const auto pair_kernel = rw_sym_pair_kernel<T, D, E, SHARED>;
  const size_t smem = sym_smem_bytes<T, D, E, SHARED>();
  cudaError_t err = allow_smem(pair_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_pairs, (p.b + S - 1) / S);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  pair_kernel<<<grid, kThreads, smem, p.stream>>>(
      p.z, p.aod, p.blam, p.part, p.iidx, p.jidx, p.b, p.n, p.nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rw_sym_sum_kernel<T, D>
      <<<dim3((p.n + kSumThreads - 1) / kSumThreads, p.b), kSumThreads, 0,
         p.stream>>>(p.part, p.dv, p.rw, p.n, p.nt, E, SHARED);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, int e, int shared_chain, const SymArgs<T>& p) {
  if (p.b <= 0 || p.n <= 0 || p.b > 65535 ||
      p.nt != (p.n + kT - 1) / kT || p.n_pairs != p.nt * (p.nt + 1) / 2)
    return cudaErrorInvalidValue;
  return with_de(d, e, cudaErrorInvalidValue, [&](auto dd, auto ee) {
    constexpr int D = decltype(dd)::value;
    constexpr int E = decltype(ee)::value;
    return shared_chain ? launch<T, D, E, true>(p) : launch<T, D, E, false>(p);
  });
}

template <typename T>
long long plan_of(int d, int e, int shared_chain, bool smem) {
  return with_de(d, e, -1LL, [&](auto dd, auto ee) {
    constexpr int D = decltype(dd)::value;
    constexpr int E = decltype(ee)::value;
    if (smem)
      return static_cast<long long>(
          shared_chain ? sym_smem_bytes<T, D, E, true>()
                       : sym_smem_bytes<T, D, E, false>());
    return static_cast<long long>(shared_chain
                                      ? sym_scenarios<T, D, E, true>()
                                      : sym_scenarios<T, D, E, false>());
  });
}

// Pair blocks an SM holds at once; -1 on an error.
template <typename T>
long long blocks_per_sm_of(int d, int e, int shared_chain) {
  return with_de(d, e, -1LL, [&](auto dd, auto ee) {
    constexpr int D = decltype(dd)::value;
    constexpr int E = decltype(ee)::value;
    const auto kernel = shared_chain ? rw_sym_pair_kernel<T, D, E, true>
                                     : rw_sym_pair_kernel<T, D, E, false>;
    const size_t smem = shared_chain ? sym_smem_bytes<T, D, E, true>()
                                     : sym_smem_bytes<T, D, E, false>();
    int n = 0;
    if (allow_smem(kernel, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                      smem) != cudaSuccess)
      return -1LL;
    return static_cast<long long>(n);
  });
}

}  // namespace

// The plain C interface of one dtype's K4 instances, for ctypes: the launches
// (return their cudaError_t, 0 on success; asynchronous on `stream`), the
// compiled plan for the wrapper's check at load (long long, as ctypes reads
// it: S and the dynamic shared bytes of a pair block per (d, E, chain), -1
// outside d, E in 1 .. 8; kT, kThreads, kChunk), the pair blocks an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the error string.
#define GPMPC_RW_SYM_EXPORTS(T, SUFFIX)                                        \
  extern "C" int gpmpc_rw_sym_##SUFFIX(                                       \
      const T* z, const T* aod, const T* dv, const T* blam, T* part, T* rw,   \
      const int* iidx, const int* jidx, int b, int n, int d, int e, int nt,   \
      int n_pairs, int shared_chain, void* stream) {                          \
    const SymArgs<T> p{z,    aod,  dv, blam, part, rw, iidx,                  \
                       jidx, b,    n,  nt,   n_pairs,                         \
                       static_cast<cudaStream_t>(stream)};                    \
    return static_cast<int>(dispatch<T>(d, e, shared_chain, p));             \
  }                                                                           \
  extern "C" long long gpmpc_rw_sym_scenarios_##SUFFIX(int d, int e,          \
                                                       int shared_chain) {    \
    return plan_of<T>(d, e, shared_chain, false);                             \
  }                                                                           \
  extern "C" long long gpmpc_rw_sym_smem_##SUFFIX(int d, int e,               \
                                                  int shared_chain) {         \
    return plan_of<T>(d, e, shared_chain, true);                              \
  }                                                                           \
  extern "C" long long gpmpc_rw_sym_blocks_per_sm_##SUFFIX(                  \
      int d, int e, int shared_chain) {                                       \
    return blocks_per_sm_of<T>(d, e, shared_chain);                           \
  }                                                                           \
  extern "C" long long gpmpc_rw_sym_tile_##SUFFIX() { return kT; }            \
  extern "C" long long gpmpc_rw_sym_threads_##SUFFIX() { return kThreads; }   \
  extern "C" long long gpmpc_rw_sym_chunk_##SUFFIX() { return kChunk; }       \
  extern "C" const char* gpmpc_rw_sym_error_string_##SUFFIX(int err) {        \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                 \
  }
