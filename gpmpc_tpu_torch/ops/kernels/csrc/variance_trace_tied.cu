// K1: the tied variance-trace kernel, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_rw_tied_streamed_kernel`, dispatched by
// `_rw_call_tied` in gpmpc_tpu/ops/pallas/variance_trace.py. For scenario b,
// output e, output row i and column c in [0, 1 + d):
//
//   rw[b,e,i,c] = dv[b,i] * sum_j blam[e,j,i] * exp(-1/4 sum_k a[b,j,k] g[b,i,k])
//                                             * aod[b,j,c]
//
// with aod = dv o [1 | a] over the contraction rows. One exp chain serves all
// E outputs (tied lengthscales share M2). Row and contraction lengths are
// separate (n_out, n_c), so the row-block variant for model sharding is a thin
// wrapper over the same kernel.
//
// Bound on an H100: operations. One call does B * n_out * n_c (i, j) pairs;
// each pair costs d FMAs for the exponent, one accurate expf, and E * (1 + (1+d))
// multiply-adds. At the headline shape (B=256, N=256, d=3, E=2) that is
// 16.8 M pairs and ~0.4 G f32 instructions, ~12 us at 132 SMs x 128 lanes at
// ~1.98 GHz, against ~1.6 us to move the bytes (blam is 512 KB and stays in L2).
// So the design spends nothing on data movement tricks: one thread owns one
// output row i and keeps g_i and its E * (1+d) accumulators in registers; the
// block stages the contraction rows a_j and aod_j in shared memory, where every
// thread reads the same word (a broadcast, no bank conflicts); blam[e, j, i]
// is read with i contiguous across the warp, so each load is coalesced.
//
// Precision: the trace cancels (sum |terms| / |result| reaches 1e2-1e3), so the
// exp is the accurate expf (never __expf or --use_fast_math) and the (1+d)-wide
// reduction is exact f32 FMAs; four columns are too narrow for tensor cores.
// The double instance serves the f64 reference objective on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // threads per block = output rows per block
constexpr int kTile = 128;  // contraction rows staged in shared memory per step

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

template <typename T, int D, int E>
__global__ void __launch_bounds__(kRows)
rw_tied_kernel(const T* __restrict__ g, const T* __restrict__ dv,
               const T* __restrict__ a, const T* __restrict__ aod,
               const T* __restrict__ blam, T* __restrict__ rw, int n_out,
               int n_c) {
  constexpr int W1 = D + 1;
  __shared__ T s_a[kTile * D];
  __shared__ T s_aod[kTile * W1];

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
#pragma unroll 2
      for (int jj = 0; jj < jn; ++jj) {
        T p = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) p = fma(s_a[jj * D + k], gi[k], p);
        const T w = accurate_exp(T(-0.25) * p);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T bw =
              blam_j[(static_cast<size_t>(e) * n_c + jj) * n_out] * w;
#pragma unroll
          for (int c = 0; c < W1; ++c)
            acc[e][c] = fma(bw, s_aod[jj * W1 + c], acc[e][c]);
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

template <typename T, int D, int E>
cudaError_t launch(const RwArgs<T>& p) {
  const dim3 grid((p.n_out + kRows - 1) / kRows, p.b);
  rw_tied_kernel<T, D, E><<<grid, kRows, 0, p.stream>>>(
      p.g, p.dv, p.a, p.aod, p.blam, p.rw, p.n_out, p.n_c);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_e(int e, const RwArgs<T>& p) {
  switch (e) {
    case 1: return launch<T, D, 1>(p);
    case 2: return launch<T, D, 2>(p);
    case 3: return launch<T, D, 3>(p);
    case 4: return launch<T, D, 4>(p);
    case 5: return launch<T, D, 5>(p);
    case 6: return launch<T, D, 6>(p);
    case 7: return launch<T, D, 7>(p);
    case 8: return launch<T, D, 8>(p);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int d, int e, const RwArgs<T>& p) {
  if (p.b <= 0 || p.n_out <= 0 || p.n_c < 0 || p.b > 65535)
    return cudaErrorInvalidValue;
  switch (d) {
    case 1: return dispatch_e<T, 1>(e, p);
    case 2: return dispatch_e<T, 2>(e, p);
    case 3: return dispatch_e<T, 3>(e, p);
    case 4: return dispatch_e<T, 4>(e, p);
    case 5: return dispatch_e<T, 5>(e, p);
    case 6: return dispatch_e<T, 6>(e, p);
    case 7: return dispatch_e<T, 7>(e, p);
    case 8: return dispatch_e<T, 8>(e, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes. Each returns the cudaError_t of the launch
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int gpmpc_rw_tied_f32(const float* g, const float* dv,
                                 const float* a, const float* aod,
                                 const float* blam, float* rw, int b,
                                 int n_out, int n_c, int d, int e,
                                 void* stream) {
  const RwArgs<float> p{g, dv, a, aod, blam, rw, b, n_out, n_c,
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<float>(d, e, p));
}

extern "C" int gpmpc_rw_tied_f64(const double* g, const double* dv,
                                 const double* a, const double* aod,
                                 const double* blam, double* rw, int b,
                                 int n_out, int n_c, int d, int e,
                                 void* stream) {
  const RwArgs<double> p{g, dv, a, aod, blam, rw, b, n_out, n_c,
                         static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<double>(d, e, p));
}

extern "C" const char* gpmpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
