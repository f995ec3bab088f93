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
//   1. rw_sym_pair_kernel, one block per (tile pair, scenario): writes the
//      partial of row tile R from contraction tile K to part[b, R, K] (each
//      slot is written by exactly one pair: R <= K by the column reduction of
//      pair (R, K), R > K by the row reduction of pair (K, R)).
//   2. rw_sym_sum_kernel, one thread per (scenario, row): sums part[b, R, K]
//      over K = 0 .. nt-1 in that order and applies the final dv scale.
//
// Tiles are kT = 64 rows; a ragged last tile is masked (rows past n carry no
// blam and no aod), so any n works. Per block the shared memory holds the exp
// tile (shared chain only), the blam o W tile of one output, tile J's z rows
// and both tiles' aod rows: 39 KB in f32 and 78 KB in f64 at d = 8, above
// the 48 KB static limit, hence dynamic shared memory.
//
// Bound on an H100: operations, as K1, with the exp count cut to
// (nt + 1) / (2 nt) of K1's (5/8 at the headline's nt = 4); the reductions
// are unchanged in number. This first version does nothing for speed beyond
// that: 64 threads a block, the exp tile staged in shared memory, the blam
// tile read once per pair, coalesced along its rows.
//
// Precision: the accurate expf (never __expf or --use_fast_math) and exact
// f32 FMAs for the (1+d)-wide reductions, as in K1. The double instance lets
// the card evaluate the f64 reference objective on this path.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;        // tile rows = threads per pair block
constexpr int kLd = kT + 1;   // padded row of a shared tile (no bank conflicts)
constexpr int kSumThreads = 128;

__device__ __forceinline__ float accurate_exp(float x) { return expf(x); }
__device__ __forceinline__ double accurate_exp(double x) { return exp(x); }

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

template <int D>
constexpr int smem_elems(bool shared_chain) {
  return (shared_chain ? kT * kLd : 0) + kT * kLd + kT * D + 2 * kT * (D + 1);
}

// dst[jj][t] = exp(-1/4 z_j . z_i) for the rows j of tile J and the column
// i = i0 + t of tile I; z_b is one chain's (n, D) rows.
template <typename T, int D>
__device__ void exp_tile(const T* __restrict__ z_b, T* s_zj, T* dst, int i0,
                         int j0, int ni, int nj) {
  const int t = threadIdx.x;
  __syncthreads();  // s_zj and dst are free
  for (int q = t; q < nj * D; q += kT) s_zj[q] = z_b[static_cast<size_t>(j0) * D + q];
  T zi[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    zi[k] = t < ni ? z_b[static_cast<size_t>(i0 + t) * D + k] : T(0);
  __syncthreads();
  for (int jj = 0; jj < nj; ++jj) {
    T p = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) p = fma(s_zj[jj * D + k], zi[k], p);
    dst[jj * kLd + t] = accurate_exp(T(-0.25) * p);
  }
}

template <typename T, int D, bool SHARED>
__global__ void __launch_bounds__(kT)
rw_sym_pair_kernel(const T* __restrict__ z, const T* __restrict__ aod,
                   const T* __restrict__ blam, T* __restrict__ part,
                   const int* __restrict__ iidx, const int* __restrict__ jidx,
                   int n, int nt, int E) {
  constexpr int W1 = D + 1;
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* s_w = smem;                                   // shared chain's exp tile
  T* s_s = s_w + (SHARED ? kT * kLd : 0);          // blam o W, one output
  T* s_zj = s_s + kT * kLd;                        // z rows of tile J
  T* s_aodj = s_zj + kT * D;                       // aod rows of tile J
  T* s_aodi = s_aodj + kT * W1;                    // aod rows of tile I

  const int pair = blockIdx.x;
  const int b = blockIdx.y;
  const int ti = iidx[pair];
  const int tj = jidx[pair];
  const int i0 = ti * kT;
  const int j0 = tj * kT;
  const int ni = min(kT, n - i0);
  const int nj = min(kT, n - j0);
  const int t = threadIdx.x;

  if (SHARED) exp_tile<T, D>(z + static_cast<size_t>(b) * n * D, s_zj, s_w, i0, j0, ni, nj);

  for (int e = 0; e < E; ++e) {
    const size_t chain = SHARED ? static_cast<size_t>(b)
                                : static_cast<size_t>(b) * E + e;
    if (!SHARED) exp_tile<T, D>(z + chain * n * D, s_zj, s_s, i0, j0, ni, nj);
    const T* aod_c = aod + chain * n * W1;
    __syncthreads();  // the previous output's phase 2 is done with s_aod*
    for (int q = t; q < kT * W1; q += kT) {
      s_aodj[q] = q < nj * W1 ? aod_c[static_cast<size_t>(j0) * W1 + q] : T(0);
      s_aodi[q] = q < ni * W1 ? aod_c[static_cast<size_t>(i0) * W1 + q] : T(0);
    }
    __syncthreads();

    // Phase 1: thread t owns column i = i0 + t; sums over the rows j of tile J
    // into row tile I's partial, and keeps blam o W for phase 2.
    T acc[W1];
#pragma unroll
    for (int c = 0; c < W1; ++c) acc[c] = T(0);
    if (t < ni) {
      const T* blam_j = blam + (static_cast<size_t>(e) * n + j0) * n + i0 + t;
#pragma unroll 2
      for (int jj = 0; jj < nj; ++jj) {
        const T w = SHARED ? s_w[jj * kLd + t] : s_s[jj * kLd + t];
        const T s = blam_j[static_cast<size_t>(jj) * n] * w;
        s_s[jj * kLd + t] = s;
#pragma unroll
        for (int c = 0; c < W1; ++c) acc[c] = fma(s, s_aodj[jj * W1 + c], acc[c]);
      }
    }
    T* out_i = part + ((((static_cast<size_t>(b) * nt + ti) * nt + tj) * E + e) * kT + t) * W1;
#pragma unroll
    for (int c = 0; c < W1; ++c) out_i[c] = acc[c];

    // Phase 2 (off the diagonal): thread t owns row j = j0 + t; sums the same
    // tile over the columns i of tile I into row tile J's partial.
    if (ti != tj) {
      __syncthreads();
      if (t < nj) {
        T acc2[W1];
#pragma unroll
        for (int c = 0; c < W1; ++c) acc2[c] = T(0);
#pragma unroll 2
        for (int ii = 0; ii < ni; ++ii) {
          const T s = s_s[t * kLd + ii];
#pragma unroll
          for (int c = 0; c < W1; ++c) acc2[c] = fma(s, s_aodi[ii * W1 + c], acc2[c]);
        }
        T* out_j = part + ((((static_cast<size_t>(b) * nt + tj) * nt + ti) * E + e) * kT + t) * W1;
#pragma unroll
        for (int c = 0; c < W1; ++c) out_j[c] = acc2[c];
      }
    }
    __syncthreads();  // s_s is reused by the next output
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

template <typename T, int D, bool SHARED>
cudaError_t launch(int e, const SymArgs<T>& p) {
  const size_t smem = sizeof(T) * smem_elems<D>(SHARED);
  cudaError_t err = cudaFuncSetAttribute(
      rw_sym_pair_kernel<T, D, SHARED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rw_sym_pair_kernel<T, D, SHARED><<<dim3(p.n_pairs, p.b), kT, smem, p.stream>>>(
      p.z, p.aod, p.blam, p.part, p.iidx, p.jidx, p.n, p.nt, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rw_sym_sum_kernel<T, D>
      <<<dim3((p.n + kSumThreads - 1) / kSumThreads, p.b), kSumThreads, 0,
         p.stream>>>(p.part, p.dv, p.rw, p.n, p.nt, e, SHARED);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_chain(int e, int shared_chain, const SymArgs<T>& p) {
  return shared_chain ? launch<T, D, true>(e, p) : launch<T, D, false>(e, p);
}

template <typename T>
cudaError_t dispatch(int d, int e, int shared_chain, const SymArgs<T>& p) {
  if (p.b <= 0 || p.n <= 0 || p.b > 65535 || e < 1 || e > 8 ||
      p.nt != (p.n + kT - 1) / kT || p.n_pairs != p.nt * (p.nt + 1) / 2)
    return cudaErrorInvalidValue;
  switch (d) {
    case 1: return dispatch_chain<T, 1>(e, shared_chain, p);
    case 2: return dispatch_chain<T, 2>(e, shared_chain, p);
    case 3: return dispatch_chain<T, 3>(e, shared_chain, p);
    case 4: return dispatch_chain<T, 4>(e, shared_chain, p);
    case 5: return dispatch_chain<T, 5>(e, shared_chain, p);
    case 6: return dispatch_chain<T, 6>(e, shared_chain, p);
    case 7: return dispatch_chain<T, 7>(e, shared_chain, p);
    case 8: return dispatch_chain<T, 8>(e, shared_chain, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes. Each returns the cudaError_t of the launches
// (0 on success); they are asynchronous on `stream`.
extern "C" int gpmpc_rw_sym_tile() { return kT; }

extern "C" int gpmpc_rw_sym_f32(const float* z, const float* aod,
                                const float* dv, const float* blam,
                                float* part, float* rw, const int* iidx,
                                const int* jidx, int b, int n, int d, int e,
                                int nt, int n_pairs, int shared_chain,
                                void* stream) {
  const SymArgs<float> p{z, aod, dv, blam, part, rw, iidx, jidx, b, n, nt,
                         n_pairs, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<float>(d, e, shared_chain, p));
}

extern "C" int gpmpc_rw_sym_f64(const double* z, const double* aod,
                                const double* dv, const double* blam,
                                double* part, double* rw, const int* iidx,
                                const int* jidx, int b, int n, int d, int e,
                                int nt, int n_pairs, int shared_chain,
                                void* stream) {
  const SymArgs<double> p{z, aod, dv, blam, part, rw, iidx, jidx, b, n, nt,
                          n_pairs, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<double>(d, e, shared_chain, p));
}

extern "C" const char* gpmpc_sym_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
