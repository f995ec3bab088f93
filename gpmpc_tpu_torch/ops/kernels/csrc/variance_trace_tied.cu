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

// The kernel itself is K1's body in rw_tied_body.cuh, instantiated here as
// Variant::kFull with 128 contraction rows staged per step; the probe
// (variance_trace_probe.cu) instantiates the same body under its variants.

#include <cuda_runtime.h>

#include "rw_tied_body.cuh"

namespace {

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
