// The batched small symmetric eigensolver, written by hand for Hopper
// (sm_90a): w, V of every symmetric (d, d) matrix of a batch, d <= 8, the
// eigenvalues ascending and V's columns orthonormal, as jnp.linalg.eigh
// gives them.
//
// Replaces: no TPU kernel. The JAX package projects a full state covariance
// onto the PSD cone with jnp.linalg.eigh (gpmpc_tpu/dynamics.py:164, 312),
// which XLA compiles; the port's first counterpart, torch.linalg.eigh, is a
// cuSOLVER call whose error check waits on the host, so a rollout step that
// calls it cannot be captured in a CUDA graph. This kernel is that step's
// eigensolver: one launch, no host read.
//
// Bound on an H100: neither bytes nor operations. A matrix is 2 d^2 + d
// numbers in and out (48 bytes at d = 2 in f32), and its Jacobi sweeps are a
// few hundred flops; at the rollout's 1-256 matrices a launch moves a few
// kilobytes. What bounds it is the launch and each thread's serial chain of
// dependent square roots and divisions: about 3 of each a rotation, each
// tens of cycles in f64. The design answers with one thread a matrix, the
// whole matrix in registers, the d (d - 1) / 2 rotations of a sweep
// unrolled at compile time for each d, and a stop after the first sweep
// that rotates nothing (two sweeps at d = 2, where one rotation is exact).
//
// Algorithm: the cyclic Jacobi method with Rutishauser's stable rotation.
// The input is symmetrised as JAX's eigh does, a_pq = (A_pq + A_qp) / 2. A
// sweep visits (p, q) for p < q in row order. A rotation is skipped where
// |a_pq| <= eps sqrt|a_pp| sqrt|a_qq| (eps the dtype's machine epsilon: the
// entry is below the rounding of the diagonal it would change), else
//
//   theta = (a_qq - a_pp) / (2 a_pq),
//   t = sign(theta) / (|theta| + sqrt(1 + theta^2)),
//   c = 1 / sqrt(1 + t^2),  s = t c,  tau = s / (1 + c),
//   a_pp -= t a_pq,  a_qq += t a_pq,  a_pq = 0,
//   x_rp -= s (x_rq + tau x_rp),  x_rq += s (x_rp - tau x_rq)
//
// for the other rows r of a and every row r of V (a theta whose square
// overflows gives t = 0, the identity, with a_pq still set to 0: the entry
// was below eps |a_qq - a_pp|). At most kSweeps sweeps; then the diagonal
// is sorted ascending by a stable sort (NaN last), V's columns with it.
//
// Every operation is an IEEE-rounded intrinsic (__dmul_rn, __fadd_rn, ...),
// which the compiler never contracts into an FMA, so the kernel does the
// arithmetic of its plain version (`eigh_reference` in eigh_small.py: the
// same operations, one torch op each) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 8;
constexpr int kSweeps = 15;
constexpr int kThreads = 128;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float absval(float a) { return fabsf(a); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double absval(double a) { return fabs(a); }

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr float value = 1.1920928955078125e-07f; };
template <> struct Eps<double> { static constexpr double value = 2.220446049250313e-16; };

// The sort's order: x before y where x < y, NaN after every number.
template <typename T>
__device__ __forceinline__ bool before(T x, T y) {
  return x < y || (y != y && x == x);
}

// The upper triangle's slot of (i, j): a holds only the D (D + 1) / 2
// entries i <= j, the registers a full matrix would take twice.
template <int D>
__device__ __forceinline__ constexpr int tri(int i, int j) {
  return i <= j ? i * D - i * (i - 1) / 2 + (j - i)
                : j * D - j * (j - 1) / 2 + (i - j);
}

// One rotation (p, q) of the sweep; returns whether it rotated.
template <typename T, int D, int P, int Q>
__device__ __forceinline__ bool rotate(T (&a)[D * (D + 1) / 2], T (&v)[D][D]) {
  const T apq = a[tri<D>(P, Q)];
  const T app = a[tri<D>(P, P)];
  const T aqq = a[tri<D>(Q, Q)];
  const T tol = mul(Eps<T>::value, mul(sqrt_rn(absval(app)), sqrt_rn(absval(aqq))));
  if (!(absval(apq) > tol)) return false;
  const T theta = div(sub(aqq, app), add(apq, apq));
  T t = div(T(1), add(absval(theta), sqrt_rn(add(T(1), mul(theta, theta)))));
  t = theta < T(0) ? -t : t;
  const T c = div(T(1), sqrt_rn(add(T(1), mul(t, t))));
  const T s = mul(t, c);
  const T tau = div(s, add(T(1), c));
  const T h = mul(t, apq);
  a[tri<D>(P, P)] = sub(app, h);
  a[tri<D>(Q, Q)] = add(aqq, h);
  a[tri<D>(P, Q)] = T(0);
#pragma unroll
  for (int r = 0; r < D; ++r) {
    if (r == P || r == Q) continue;
    const T arp = a[tri<D>(r, P)];
    const T arq = a[tri<D>(r, Q)];
    a[tri<D>(r, P)] = sub(arp, mul(s, add(arq, mul(tau, arp))));
    a[tri<D>(r, Q)] = add(arq, mul(s, sub(arp, mul(tau, arq))));
  }
#pragma unroll
  for (int r = 0; r < D; ++r) {
    const T vrp = v[r][P];
    const T vrq = v[r][Q];
    v[r][P] = sub(vrp, mul(s, add(vrq, mul(tau, vrp))));
    v[r][Q] = add(vrq, mul(s, sub(vrp, mul(tau, vrq))));
  }
  return true;
}

// The rotations (P, Q), (P, Q + 1), ..., then the next rows, in order.
template <typename T, int D, int P, int Q>
__device__ __forceinline__ bool sweep_from(T (&a)[D * (D + 1) / 2],
                                           T (&v)[D][D]) {
  if constexpr (P >= D - 1) {
    return false;
  } else if constexpr (Q >= D) {
    return sweep_from<T, D, P + 1, P + 2>(a, v);
  } else {
    const bool here = rotate<T, D, P, Q>(a, v);
    return sweep_from<T, D, P, Q + 1>(a, v) || here;
  }
}

// One thread a matrix: a (n, D, D) -> w (n, D) ascending, v (n, D, D) with
// the eigenvectors in its columns.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    eigh_small_kernel(const T* __restrict__ in, T* __restrict__ w_out,
                      T* __restrict__ v_out, long long n) {
  const long long m = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (m >= n) return;
  const T* am = in + m * D * D;
  T a[D * (D + 1) / 2];
  T v[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = i; j < D; ++j) {
      a[tri<D>(i, j)] = i == j ? am[i * D + i]
                               : mul(T(0.5), add(am[i * D + j], am[j * D + i]));
    }
#pragma unroll
    for (int j = 0; j < D; ++j) v[i][j] = i == j ? T(1) : T(0);
  }
  for (int k = 0; k < kSweeps; ++k) {
    if (!sweep_from<T, D, 0, 1>(a, v)) break;
  }
  T w[D];
#pragma unroll
  for (int i = 0; i < D; ++i) w[i] = a[tri<D>(i, i)];
  // Stable: odd-even transposition, a swap only where strictly out of order.
#pragma unroll
  for (int pass = 0; pass < D; ++pass) {
#pragma unroll
    for (int i = pass & 1; i + 1 < D; i += 2) {
      if (before(w[i + 1], w[i])) {
        const T x = w[i];
        w[i] = w[i + 1];
        w[i + 1] = x;
#pragma unroll
        for (int r = 0; r < D; ++r) {
          const T y = v[r][i];
          v[r][i] = v[r][i + 1];
          v[r][i + 1] = y;
        }
      }
    }
  }
  T* wm = w_out + m * D;
  T* vm = v_out + m * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    wm[i] = w[i];
#pragma unroll
    for (int j = 0; j < D; ++j) vm[i * D + j] = v[i][j];
  }
}

template <typename T, int D>
cudaError_t launch(const T* a, T* w, T* v, long long n, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  eigh_small_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(a, w, v, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const T* a, T* w, T* v, long long n, int d,
                     cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if ((n + kThreads - 1) / kThreads > 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (d) {
    case 1: return launch<T, 1>(a, w, v, n, stream);
    case 2: return launch<T, 2>(a, w, v, n, stream);
    case 3: return launch<T, 3>(a, w, v, n, stream);
    case 4: return launch<T, 4>(a, w, v, n, stream);
    case 5: return launch<T, 5>(a, w, v, n, stream);
    case 6: return launch<T, 6>(a, w, v, n, stream);
    case 7: return launch<T, 7>(a, w, v, n, stream);
    case 8: return launch<T, 8>(a, w, v, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gpmpc_eigh_small_f32(const float* a, float* w, float* v,
                                    long long n, int d, void* stream) {
  return static_cast<int>(
      dispatch<float>(a, w, v, n, d, static_cast<cudaStream_t>(stream)));
}

extern "C" int gpmpc_eigh_small_f64(const double* a, double* w, double* v,
                                    long long n, int d, void* stream) {
  return static_cast<int>(
      dispatch<double>(a, w, v, n, d, static_cast<cudaStream_t>(stream)));
}

extern "C" long long gpmpc_eigh_small_max_d() { return kMaxD; }
extern "C" long long gpmpc_eigh_small_sweeps() { return kSweeps; }
extern "C" long long gpmpc_eigh_small_threads() { return kThreads; }

extern "C" const char* gpmpc_eigh_small_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
