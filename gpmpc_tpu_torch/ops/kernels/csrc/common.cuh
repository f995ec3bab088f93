// Device helpers shared by K1's body (rw_tied_body.cuh) and K4
// (variance_trace_sym.cu).
//
// Included by .cu files that are each built into their own shared library;
// the anonymous namespace keeps every symbol local to its library.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

// The largest dynamic shared memory a block may ask for on Hopper (227 KB).
constexpr int kMaxSmemBytes = 232448;
// Above this a kernel needs cudaFuncAttributeMaxDynamicSharedMemorySize.
constexpr int kDefaultSmemBytes = 48 * 1024;

__device__ __forceinline__ float accurate_exp(float x) { return expf(x); }
__device__ __forceinline__ double accurate_exp(double x) { return exp(x); }

// n rounded up to a multiple of 4: a row of that many elements is read from
// shared memory as 16-byte vectors (float4, or two double2 per 4 doubles).
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// v[0 .. N) = p[0 .. N) by 16-byte shared-memory loads; p is 16-byte
// aligned and N a multiple of 4. Every lane of a warp that reads the same
// row gets it as one broadcast.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, T (&v)[N]) {
  static_assert(N % 4 == 0, "rows are padded to a multiple of 4");
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const double2 x = reinterpret_cast<const double2*>(p)[q];
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  }
}

// *dst = *src from global to shared memory without a register, by cp.async
// (4 or 8 bytes; the copy lands at cp_async_wait). src_ok false writes 0 and
// reads nothing.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool src_ok) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = src_ok ? static_cast<int>(sizeof(T)) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T))), "r"(n)
               : "memory");
}

// 16 bytes from global to shared memory by cp.async, bypassing L1 (a
// slab read once); dst and src 16-byte aligned. src_ok false writes 0 and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool src_ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = src_ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f(Int<D>{}, Int<E>{}) for runtime d, e in 1 .. 8, else `bad`: one
// instance per (d, E) of whatever f instantiates.
template <int N>
using Int = std::integral_constant<int, N>;

template <typename R, int D, typename F>
R with_e(int e, R bad, F& f) {
  switch (e) {
    case 1: return f(Int<D>{}, Int<1>{});
    case 2: return f(Int<D>{}, Int<2>{});
    case 3: return f(Int<D>{}, Int<3>{});
    case 4: return f(Int<D>{}, Int<4>{});
    case 5: return f(Int<D>{}, Int<5>{});
    case 6: return f(Int<D>{}, Int<6>{});
    case 7: return f(Int<D>{}, Int<7>{});
    case 8: return f(Int<D>{}, Int<8>{});
    default: return bad;
  }
}

template <typename R, typename F>
R with_de(int d, int e, R bad, F f) {
  switch (d) {
    case 1: return with_e<R, 1>(e, bad, f);
    case 2: return with_e<R, 2>(e, bad, f);
    case 3: return with_e<R, 3>(e, bad, f);
    case 4: return with_e<R, 4>(e, bad, f);
    case 5: return with_e<R, 5>(e, bad, f);
    case 6: return with_e<R, 6>(e, bad, f);
    case 7: return with_e<R, 7>(e, bad, f);
    case 8: return with_e<R, 8>(e, bad, f);
    default: return bad;
  }
}

// A kernel's dynamic shared memory: sets the attribute where the size
// passes the default, and refuses more than a block may have.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (bytes <= static_cast<size_t>(kDefaultSmemBytes)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
