// P1 and P2: the probes of K1, written by hand for Hopper (sm_90a).
//
// Replaces the TPU probes `call_variant` (benchmarks/kernel_ablate.py, body
// `make_kernel`) and `call` (benchmarks/kernel_probe.py, body `make_kernel`).
// On the TPU they located K1's time by removing one stage of its body at a
// time (P1) and by changing the arithmetic of the exponent and the reduction
// (P2). Here the same questions are asked of K1's CUDA body: every scalar
// variant is an instance of rw_tied_body.cuh, the header K1 itself is built
// from, so `full` is K1's code and its rw equals K1's to the bit.
//
// Variants (ids as in ops/kernels/probe.py; all f32, d = 3, E = 2, any B, N):
//   0 full          K1 at K1's own plan (P1 full and vpured, P2 vpu_p).
//   1 full_tile256  K1 with twice the contraction rows staged per step, each
//                   slice taking 2 kSubRows of a tile (P1 *_tj256).
//   2 hwexp         __expf in place of expf (P1 hwexp).
//   3 noexp         w = -p / 4 (P1 noexp).
//   4 nop           w = g_i[0] (P1 nop).
//   5 nodots        acc[e][0] += blam * w only (P1 nodots).
//   6 nomul         bw = w, no blam read (P1 nomul).
//   7 empty         staging and one blam read a tile (P1 empty).
//   8 red_tf32      the reduction (blam_e o W)^T-contracted with aod on the
//                   tensor cores, nvcuda::wmma m16n16k8 TF32, one pass
//                   (P2 vpu_def, P1 dott).
//   9 red_3xtf32    the same with hi/lo splits, hi.hi + hi.lo + lo.hi (P2
//                   vpu_3p).
//  10 tc_p          p = G A^T on the tensor cores at 3xTF32 (K = d padded to
//                   8), then K1's exp and FMA reduction (P2 base).
//  11 full_s1       K1 with scenario sharing off (S = 1 a block): what the
//                   sharing alone buys (no TPU counterpart).
//  12 plan_32x8     K1 at another block shape, rows x slices (K1's is
//  13 plan_128x2    64 x 4): the launch plans K1's was chosen from (no TPU
//  14 plan_64x2     counterpart).
//  15 plan_32x4
//
// The f64 variants (ids as F64_VARIANTS in ops/kernels/probe.py; d = 3,
// E = 2, any B, N): the scalar body at T = double, K1's f64 instance before
// the tensor-core body (its launches at small B still), under P1's stages:
//   0 full  1 full_s1  2 noexp  3 nop  4 nodots  5 nomul  6 empty
// (hwexp is f32 only: __expf has no double), and the tensor-core body of
// rw_tied_f64_body.cuh, K1's f64 instance where tied_route takes it, with
// one choice of its MmaCfg changed (S scenarios a block, G of them
// interleaved, K8, PF) or one stage dropped:
//   7 mma        K1 at its plan (mma_plan): K1 f64 at the headline, to the bit
//                (S = 4 scenarios a block, G = 2 of them interleaved).
//   8 mma_s2     S = 2, G = 1.      9 mma_s8     S = 8, G = 4.
//  10 mma_k4     the contraction as two m16n8k4 in place of one m16n8k8.
//  11 mma_cexp   CUDA's exp (its special-case branch in every exp) in place
//                of exp_fast.
//  12 mma_noexp  w = -p / 4: the exponent MMA without the exp.
//  13 mma_nodots no contraction MMA: column c of rw sums blam w over the
//                rows j = c mod 8.
//  14 mma_nop    no exponent MMA: w = exp(-g_i[0] / 4).
//  15 mma_g1     G = 1: one scenario's exps at a time.
//  16 mma_g4     G = 4: all four.
//  17 mma_nopf   blam loaded at its step, not one step ahead.
//  18 mma_blsmem blam staged in shared memory with each chunk (cp.async).
// `gpmpc_exp_table_f64` evaluates table_exp (exp_fast, or exp outside its
// range) alone, for its ulp check.
//
// Bound on an H100: K1's, operations (see variance_trace_tied.cu); each
// variant does that work or less. The tensor-core variants, kept from the
// first design (a thread an output row, 128 rows a block, one scenario a
// block), are a probe of a route K1's redesign weighed and left, not a path:
// nothing in the solve calls them. Their operands are rounded with wmma::__float_to_tf32 (round to
// nearest, ties away from zero), never truncated by the load. Each warp owns
// 32 output rows as two 16-row MMA tiles; the (blam o W) and p tiles are
// staged column-major in shared memory, so that each thread writes and reads
// its own row with the warp on consecutive words (no bank conflicts).

#include <cuda_runtime.h>
#include <mma.h>

#include "rw_tied_body.cuh"
#include "rw_tied_f64_body.cuh"

namespace {

using namespace nvcuda;

constexpr int kD = 3;
constexpr int kE = 2;
constexpr int kW1 = kD + 1;
constexpr int kNumVariants = 16;
constexpr int kChunk = 32;      // contraction rows per tensor-core step
constexpr int kTcRows = 128;    // threads a tensor-core block = its output rows
constexpr int kLd = kTcRows + 4;  // stride of the column-major (row i, *) tiles
constexpr int kNPad = 16;       // aod's 1 + d columns padded to the MMA width
constexpr int kKPad = 8;        // the exponent's d padded to the MMA depth

using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
using FragAColMajor = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                                     wmma::precision::tf32, wmma::col_major>;
using FragARowMajor = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                                     wmma::precision::tf32, wmma::row_major>;
using FragBRowMajor = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                                     wmma::precision::tf32, wmma::row_major>;
using FragBColMajor = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                                     wmma::precision::tf32, wmma::col_major>;

template <typename Frag>
__device__ __forceinline__ void round_tf32(Frag& f) {
#pragma unroll
  for (int t = 0; t < f.num_elements; ++t)
    f.x[t] = wmma::__float_to_tf32(f.x[t]);
}

template <typename Frag>
__device__ __forceinline__ void split_tf32(const Frag& f, Frag& hi, Frag& lo) {
#pragma unroll
  for (int t = 0; t < f.num_elements; ++t) {
    const float h = wmma::__float_to_tf32(f.x[t]);
    hi.x[t] = h;
    lo.x[t] = wmma::__float_to_tf32(f.x[t] - h);
  }
}

// c += a b in TF32: one pass on the rounded operands, or three on their
// hi / lo splits (the lo.lo product is dropped).
template <int Passes, typename FragA, typename FragB>
__device__ __forceinline__ void mma_tf32(FragC& c, const FragA& a,
                                         const FragB& b) {
  static_assert(Passes == 1 || Passes == 3, "one or three passes");
  if constexpr (Passes == 1) {
    FragA ar = a;
    FragB br = b;
    round_tf32(ar);
    round_tf32(br);
    wmma::mma_sync(c, ar, br, c);
  } else {
    FragA ah, al;
    FragB bh, bl;
    split_tf32(a, ah, al);
    split_tf32(b, bh, bl);
    wmma::mma_sync(c, ah, bh, c);
    wmma::mma_sync(c, ah, bl, c);
    wmma::mma_sync(c, al, bh, c);
  }
}

// red_tf32 / red_3xtf32: K1's exp chain, each thread writing its row's
// blam_e o W for kChunk contraction rows into s_bw; then each warp contracts
// its 32 rows against aod on the tensor cores.
template <int Passes>
__global__ void __launch_bounds__(kTcRows)
rw_red_tc_kernel(const float* __restrict__ g, const float* __restrict__ dv,
                 const float* __restrict__ a, const float* __restrict__ aod,
                 const float* __restrict__ blam, float* __restrict__ rw,
                 int n_out, int n_c) {
  __shared__ float s_a[kChunk * kD];
  __shared__ __align__(32) float s_aod[kChunk * kNPad];  // (j, c) row-major
  __shared__ __align__(32) float s_bw[kE][kChunk * kLd];  // (i, j) col-major

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int i = blockIdx.x * kTcRows + tid;
  const bool row_ok = i < n_out;

  float gi[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k)
    gi[k] = row_ok ? g[(static_cast<size_t>(b) * n_out + i) * kD + k] : 0.f;

  FragC acc[kE][2];
#pragma unroll
  for (int e = 0; e < kE; ++e)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) wmma::fill_fragment(acc[e][mt], 0.f);

  const float* a_b = a + static_cast<size_t>(b) * n_c * kD;
  const float* aod_b = aod + static_cast<size_t>(b) * n_c * kW1;

  for (int j0 = 0; j0 < n_c; j0 += kChunk) {
    const int jn = min(kChunk, n_c - j0);
    __syncthreads();  // the previous chunk is consumed
    for (int t = tid; t < jn * kD; t += kTcRows)
      s_a[t] = a_b[static_cast<size_t>(j0) * kD + t];
    for (int t = tid; t < kChunk * kNPad; t += kTcRows) {
      const int jj = t / kNPad;
      const int c = t % kNPad;
      s_aod[t] = (jj < jn && c < kW1)
                     ? aod_b[static_cast<size_t>(j0 + jj) * kW1 + c]
                     : 0.f;
    }
    __syncthreads();
    const float* blam_j = blam + static_cast<size_t>(j0) * n_out + i;
    for (int jj = 0; jj < kChunk; ++jj) {
      const bool ok = row_ok && jj < jn;
      float w = 0.f;
      if (ok) {
        float p = 0.f;
#pragma unroll
        for (int k = 0; k < kD; ++k) p = fmaf(s_a[jj * kD + k], gi[k], p);
        w = accurate_exp(-0.25f * p);
      }
#pragma unroll
      for (int e = 0; e < kE; ++e)
        s_bw[e][jj * kLd + tid] =
            ok ? blam_j[(static_cast<size_t>(e) * n_c + jj) * n_out] * w : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      FragBRowMajor bf;
      wmma::load_matrix_sync(bf, &s_aod[ks * 8 * kNPad], kNPad);
#pragma unroll
      for (int e = 0; e < kE; ++e)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          FragAColMajor af;
          wmma::load_matrix_sync(
              af, &s_bw[e][ks * 8 * kLd + warp * 32 + mt * 16], kLd);
          mma_tf32<Passes>(acc[e][mt], af, bf);
        }
    }
  }

  __syncthreads();
#pragma unroll
  for (int e = 0; e < kE; ++e)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      wmma::store_matrix_sync(&s_bw[e][warp * 32 + mt * 16], acc[e][mt], kLd,
                              wmma::mem_col_major);
  __syncthreads();
  if (!row_ok) return;
  const float dvi = dv[static_cast<size_t>(b) * n_out + i];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    float* out = rw + ((static_cast<size_t>(b) * kE + e) * n_out + i) * kW1;
#pragma unroll
    for (int c = 0; c < kW1; ++c) out[c] = dvi * s_bw[e][c * kLd + tid];
  }
}

// tc_p: each warp computes p for its 32 rows against kChunk contraction rows
// at 3xTF32 into s_p; then each thread runs K1's exp and FMA reduction on
// its row.
__global__ void __launch_bounds__(kTcRows)
rw_tc_p_kernel(const float* __restrict__ g, const float* __restrict__ dv,
               const float* __restrict__ a, const float* __restrict__ aod,
               const float* __restrict__ blam, float* __restrict__ rw,
               int n_out, int n_c) {
  __shared__ __align__(32) float s_g[kTcRows * kKPad];  // (i, k) row-major
  __shared__ __align__(32) float s_a8[kChunk * kKPad];  // (k, j) col-major
  __shared__ float s_aod[kChunk * kW1];
  __shared__ __align__(32) float s_p[kChunk * kLd];     // (i, j) col-major

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int i = blockIdx.x * kTcRows + tid;
  const bool row_ok = i < n_out;

#pragma unroll
  for (int k = 0; k < kKPad; ++k)
    s_g[tid * kKPad + k] =
        (row_ok && k < kD) ? g[(static_cast<size_t>(b) * n_out + i) * kD + k]
                           : 0.f;

  float acc[kE][kW1];
#pragma unroll
  for (int e = 0; e < kE; ++e)
#pragma unroll
    for (int c = 0; c < kW1; ++c) acc[e][c] = 0.f;

  const float* a_b = a + static_cast<size_t>(b) * n_c * kD;
  const float* aod_b = aod + static_cast<size_t>(b) * n_c * kW1;

  for (int j0 = 0; j0 < n_c; j0 += kChunk) {
    const int jn = min(kChunk, n_c - j0);
    __syncthreads();  // the previous chunk is consumed (and s_g is written)
    for (int t = tid; t < kChunk * kKPad; t += kTcRows) {
      const int jj = t / kKPad;
      const int k = t % kKPad;
      s_a8[t] = (jj < jn && k < kD)
                    ? a_b[static_cast<size_t>(j0 + jj) * kD + k]
                    : 0.f;
    }
    for (int t = tid; t < jn * kW1; t += kTcRows)
      s_aod[t] = aod_b[static_cast<size_t>(j0) * kW1 + t];
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      FragARowMajor gf;
      wmma::load_matrix_sync(gf, &s_g[(warp * 32 + mt * 16) * kKPad], kKPad);
#pragma unroll
      for (int nt = 0; nt < kChunk / 16; ++nt) {
        FragBColMajor af;
        wmma::load_matrix_sync(af, &s_a8[nt * 16 * kKPad], kKPad);
        FragC pf;
        wmma::fill_fragment(pf, 0.f);
        mma_tf32<3>(pf, gf, af);
        wmma::store_matrix_sync(&s_p[nt * 16 * kLd + warp * 32 + mt * 16], pf,
                                kLd, wmma::mem_col_major);
      }
    }
    __syncwarp();  // each thread reads only its own warp's rows of s_p
    if (row_ok) {
      const float* blam_j = blam + static_cast<size_t>(j0) * n_out + i;
      for (int jj = 0; jj < jn; ++jj) {
        const float w = accurate_exp(-0.25f * s_p[jj * kLd + tid]);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float bw =
              blam_j[(static_cast<size_t>(e) * n_c + jj) * n_out] * w;
#pragma unroll
          for (int c = 0; c < kW1; ++c)
            acc[e][c] = fmaf(bw, s_aod[jj * kW1 + c], acc[e][c]);
        }
      }
    }
  }

  if (!row_ok) return;
  const float dvi = dv[static_cast<size_t>(b) * n_out + i];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    float* out = rw + ((static_cast<size_t>(b) * kE + e) * n_out + i) * kW1;
#pragma unroll
    for (int c = 0; c < kW1; ++c) out[c] = dvi * acc[e][c];
  }
}

template <typename Kernel>
cudaError_t launch_tc(Kernel kernel, const RwArgs<float>& p) {
  const dim3 grid((p.n_out + kTcRows - 1) / kTcRows, p.b);
  kernel<<<grid, kTcRows, 0, p.stream>>>(p.g, p.dv, p.a, p.aod, p.blam, p.rw,
                                       p.n_out, p.n_c);
  return cudaGetLastError();
}

// K1 at a block of Rows output rows x Slices contraction slices.
template <int Rows, int Slices>
cudaError_t launch_plan(const RwArgs<float>& p) {
  return launch<float, kD, kE, Variant::kFull, scenarios<float, kD, kE>(),
                kSubRows, Rows, Slices>(p);
}

cudaError_t launch_variant(int variant, const RwArgs<float>& p, int sms) {
  switch (variant) {
    case 0: return launch_planned<float, kD, kE, Variant::kFull, false>(
        p, kE, sms, kMaxSplit);
    case 1: return launch<float, kD, kE, Variant::kFull,
                          scenarios<float, kD, kE>(), 2 * kSubRows>(p);
    case 2: return launch<float, kD, kE, Variant::kHwExp>(p);
    case 3: return launch<float, kD, kE, Variant::kNoExp>(p);
    case 4: return launch<float, kD, kE, Variant::kNoP>(p);
    case 5: return launch<float, kD, kE, Variant::kNoDots>(p);
    case 6: return launch<float, kD, kE, Variant::kNoMul>(p);
    case 7: return launch<float, kD, kE, Variant::kEmpty>(p);
    case 8: return launch_tc(rw_red_tc_kernel<1>, p);
    case 9: return launch_tc(rw_red_tc_kernel<3>, p);
    case 10: return launch_tc(rw_tc_p_kernel, p);
    case 11: return launch<float, kD, kE, Variant::kFull, 1>(p);
    case 12: return launch_plan<32, 8>(p);
    case 13: return launch_plan<128, 2>(p);
    case 14: return launch_plan<64, 2>(p);
    case 15: return launch_plan<32, 4>(p);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kNumVariantsF64 = 19;

// The tensor-core body at the headline's (E, KS, NT) with MmaCfg C.
template <class C>
cudaError_t launch_mma_variant(const RwArgs<double>& p) {
  MmaPlan plan = mma_plan_at(C::S, p.b, p.n_out, kE, kD);
  plan.smem = mma_smem_bytes(C::S, kE, mma_ks(kD), mma_nt(kD),
                             C::BL == Blam::kStaged);
  return launch_mma_at<kE, mma_ks(kD), mma_nt(kD), C>(p, kD, plan);
}

cudaError_t launch_variant_f64(int variant, const RwArgs<double>& p, int sms) {
  constexpr int SM = mma_scenarios(kE, mma_nt(kD));
  constexpr Blam Ah = Blam::kAhead;    // K1's
  using Mode = MmaMode;
  switch (variant) {
    case 0: return launch_planned<double, kD, kE, Variant::kFull, false>(
        p, kE, sms, kMaxSplit);
    case 1: return launch<double, kD, kE, Variant::kFull, 1>(p);
    case 2: return launch<double, kD, kE, Variant::kNoExp>(p);
    case 3: return launch<double, kD, kE, Variant::kNoP>(p);
    case 4: return launch<double, kD, kE, Variant::kNoDots>(p);
    case 5: return launch<double, kD, kE, Variant::kNoMul>(p);
    case 6: return launch<double, kD, kE, Variant::kEmpty>(p);
    case 7: return launch_mma_planned<kE, mma_ks(kD), mma_nt(kD)>(
        p, kD, mma_plan(p.b, p.n_out, kE, kD));
    case 8: return launch_mma_variant<MmaCfg<2, 1, true, Ah>>(p);
    case 9: return launch_mma_variant<MmaCfg<8, 4, true, Ah>>(p);
    case 10: return launch_mma_variant<MmaCfg<SM, SM / 2, false, Ah>>(p);
    case 11: return launch_mma_variant<
        MmaCfg<SM, SM / 2, true, Ah, Mode::kCudaExp>>(p);
    case 12: return launch_mma_variant<
        MmaCfg<SM, SM / 2, true, Ah, Mode::kNoExp>>(p);
    case 13: return launch_mma_variant<
        MmaCfg<SM, SM / 2, true, Ah, Mode::kNoDots>>(p);
    case 14: return launch_mma_variant<
        MmaCfg<SM, SM / 2, true, Ah, Mode::kNoP>>(p);
    case 15: return launch_mma_variant<MmaCfg<SM, 1, true, Ah>>(p);
    case 16: return launch_mma_variant<MmaCfg<SM, SM, true, Ah>>(p);
    case 17: return launch_mma_variant<
        MmaCfg<SM, SM / 2, true, Blam::kAtStep>>(p);
    case 18: return launch_mma_variant<
        MmaCfg<SM, SM / 2, true, Blam::kStaged>>(p);
    default: return cudaErrorInvalidValue;
  }
}

__global__ void exp_table_kernel(const double* __restrict__ x,
                                 double* __restrict__ y, int n) {
  __shared__ double2 tab[64];
  for (int q = threadIdx.x; q < 64; q += blockDim.x)
    tab[q] = make_double2(kExp2Table[q][0], kExp2Table[q][1]);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = table_exp(x[i], tab);
}

}  // namespace

// Plain C interface for ctypes: the variant's id, then K1's arguments and
// the card's SM count (`full` takes K1's plan, which reads it). Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`. Only d = 3, E = 2 is instantiated.
extern "C" int gpmpc_rw_probe_f32(int variant, const float* g, const float* dv,
                                  const float* a, const float* aod,
                                  const float* blam, float* rw, int b,
                                  int n_out, int n_c, int d, int e, int sms,
                                  void* stream) {
  if (d != kD || e != kE || b <= 0 || n_out <= 0 || n_c < 0 || b > 65535 ||
      sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RwArgs<float> p{g, dv, a, aod, blam, rw, b, n_out, n_c,
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_variant(variant, p, sms));
}

extern "C" int gpmpc_rw_probe_variants() { return kNumVariants; }

extern "C" const char* gpmpc_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The f64 variants (F64_VARIANTS), arguments as gpmpc_rw_probe_f32.
extern "C" int gpmpc_rw_probe_f64(int variant, const double* g,
                                  const double* dv, const double* a,
                                  const double* aod, const double* blam,
                                  double* rw, int b, int n_out, int n_c,
                                  int d, int e, int sms, void* stream) {
  if (d != kD || e != kE || b <= 0 || n_out <= 0 || n_c < 0 || b > 65535 ||
      sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RwArgs<double> p{g, dv, a, aod, blam, rw, b, n_out, n_c,
                         static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_variant_f64(variant, p, sms));
}

extern "C" int gpmpc_rw_probe_variants_f64() { return kNumVariantsF64; }

// y = table_exp(x) for n doubles, asynchronous on `stream`.
extern "C" int gpmpc_exp_table_f64(const double* x, double* y, int n,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  exp_table_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
