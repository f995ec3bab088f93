// K1's f64 body for Hopper's FP64 tensor cores: the tied variance-trace
// column sweep in double, the exponent and the contraction on f64 mma.sync.
//
// Replaces, for every tied f64 launch the route below gives it (K1 and, on
// its rectangle, K3), the TPU kernel `_make_rw_tied_streamed_kernel`
// (gpmpc_tpu/ops/pallas/variance_trace.py, dispatched by `_rw_call_tied`
// and, for K3, by `_rw_call_tied_nm`). For scenario b, output e, output row
// i and column c in [0, 1 + d):
//
//   rw[b,e,i,c] = dv[b,i] * sum_j blam[e,j,i] * exp(-1/4 sum_k a[b,j,k] g[b,i,k])
//                                             * aod[b,j,c]
//
// Bound on an H100 (chip_smoke.py's bound_ms, PERF.md): operations on the
// FP64 datapath. Per (i, j) pair the exp (exp_fast below: 11 FP64
// instructions, benchmarks/sass_fp64.py), the scale and E blam multiplies at
// the vector peak of 34 TFLOP/s, and the exponent's d and the
// contraction's E (1 + d) multiply-adds at the tensor cores' 67 TFLOP/s.
// The two share one datapath (benchmarks/dmma_rate.py on the card: 66
// TFLOP/s of m16n8k4 alone, 32 of DFMA alone, 38 mixed in one loop), so
// their times add: ~0.0178 ms at the headline (B = N = 256, d = 3, E = 2),
// against ~0.0033 ms for the bytes.
//
// What held the old f64 instance back (the scalar body of rw_tied_body.cuh
// at T = double, 0.0606 ms at the headline; the probe's f64 variants,
// PERF.md): all of its ~29 FP64 instructions a pair and chain on the vector
// pipe (without the exp 0.039 ms, without the contraction's FMAs 0.051,
// without blam 0.048; launch, staging and stores 0.007), and CUDA's exp,
// whose special-case branch in every call keeps a warp's exps from
// interleaving.
//
// This design:
//   - A warp owns a strip of 16 output rows of S scenarios and walks the
//     contraction in steps of 8 rows. For each scenario the 16 x 8 tile of
//     exponents P = G A^T is one m16n8k4 f64 MMA (two where d > 4: the k
//     axis is d padded to 4 or 8 with zeros); the -1/4 is folded into G
//     when the warp loads it (exact: a power of two).
//   - Each thread applies exp to the 4 elements of P it holds in its
//     accumulator fragment, (row g, column 2t), (g, 2t+1), (g+8, 2t) and
//     (g+8, 2t+1) (g = lane / 4, t = lane % 4), and multiplies them by the
//     same 4 elements of blam_e, for each output e. The exp is exp_fast, a
//     table-driven double exp without a branch (within 1 ulp of exp on
//     |x| < 707; one warp-uniform branch a step takes exp beyond), so the
//     4 G exps of G scenarios interleave.
//   - Those products go straight back into the tensor cores as the A
//     operand of the contraction against aod (B: 8 rows of the contraction
//     x 8 columns, 1 + d of them used; 16 where d = 8): the sum over j does
//     not depend on its order, so the thread's column 2t is the k index t
//     and its column 2t+1 the k index t + 4 of one m16n8k8, and aod's rows
//     are read in the same order. No shuffle. Each (scenario, output) keeps
//     a 16 x 8 accumulator, 4 doubles a thread, so S rises to 4 at the
//     headline (8 at E = 1).
//   - blam is read once per warp and step, for all S scenarios of the
//     block, into registers one step ahead of its use (a block's warps own
//     different rows, so no two of them read the same value; staging it in
//     shared memory with each chunk measured 1.25x slower: PERF.md).
//   - a and aod are staged per scenario in chunks of 32 contraction rows by
//     cp.async into two buffers (chunk t + 1 lands while chunk t is used),
//     with row strides (4 or 12 for a, 10 or 18 for aod) at which the
//     fragment loads of a half-warp hit 16 distinct 8-byte banks.
//   - A block is 4 warps, 4 row strips (64 output rows), each warp walking
//     the whole contraction in order, so the bits do not depend on
//     scheduling. (Splitting the contraction across 2 warps a strip, their
//     sums added in a fixed order, measured slower at the headline: its
//     blocks of 256 threads left the second wave half empty.)
//   - Ragged edges: rows past n_out have g = 0 and blam = 0, contraction
//     rows past n_c a = aod = 0 and blam = 0, scenarios past B a = aod =
//     g = 0: each adds exp(0) * 0 = 0, and nothing is stored for them.
//   - K1's grouped form (`mma_group_plan` below): blam (G, E,
//     n_c, n_out), one slab a group of B / G consecutive scenarios (one GP
//     a lane), float or double: the width the fit stored it at. Unlike the
//     ungrouped blam, which stays in L2 for all B, each slab comes from
//     device memory, and the recipe's five scenarios a group fill neither
//     S = 4 nor 8 slots (in ceil(group / S) blocks of S = 4, 5 of 8 slots
//     live, the empty ones doing full FP64 work, and the slab loaded by
//     both blocks). So a grouped block is P scenario sets
//     (blockDim.z) of the 4 warps above, each warp one scenario (S = 1),
//     P = ceil(group / gblocks), gblocks = ceil(group / group_sets(d, E))
//     blocks a group (five at d = 3, E = 2: one block of five sets, every
//     slot live). The block stages each chunk of its slab once, by 16-byte
//     cp.async at the slab's width, into two buffers beside a and aod (one
//     where two do not fit: an f64 slab at E >= 7), and
//     every set reads it from there, widening each element to double in a
//     register before its one multiply (exact: the values of a widened
//     copy). A scenario's sums are those of the ungrouped S = 1 launch on
//     its slab, so the bits do not depend on the grouping.
//   The plans (scenarios, grid, shared bytes) are worked out on the
//   host (mma_plan, mma_group_plan below), mirrored by `rw_tied_mma_plan`
//   and `rw_tied_grouped_plan` in ops/kernels/variance_trace.py and checked
//   against these exports at load; so is the route (`tied_route`,
//   `rw_tied_body`), which sends a tied f64 launch to this body where its
//   grid (grouped: at S_max, no block across two groups) has a block for
//   every SM, else to the scalar body's plan.
//
// What the card showed (PERF.md): the tensor cores do not run beside the
// vector pipe, and the contraction's 1 + d = 4 columns fill half of an n8
// tile, so this body's FP64 work (~46 flop-equivalents a pair at the
// vector rate) is hardly less than the scalar body's with the same exp
// (~48): its gain is the branch-free exp, the scenarios sharing each blam
// tile, and the interleaving.
//
// Precision: IEEE double throughout (the FP64 tensor cores are full f64,
// not TF32); the exp is exp_fast, within 1 ulp of exp (never a fast-math
// path), and exp itself outside exp_fast's range.
//
// Included by variance_trace_tied_f64.cu (K1 and K3 in f64),
// variance_trace_grouped.cu (K1's grouped form) and the probe;
// the anonymous namespace keeps every symbol local to its library.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "rw_tied_body.cuh"

namespace {

constexpr int kMmaRows = 16;      // output rows a warp (the MMA tile's m)
constexpr int kMmaStep = 8;       // contraction rows a step (P's n)
constexpr int kMmaStrips = 4;     // row strips a block (blockDim.y)
constexpr int kMmaTileRows = kMmaRows * kMmaStrips;   // 64 rows a block
constexpr int kMmaChunk = 32;     // contraction rows a staged chunk
constexpr int kMmaSteps = kMmaChunk / kMmaStep;        // 4 steps a chunk
constexpr int kMmaMaxGridY = 65535;

// Scenarios a block serves at most: the accumulators, S E NT 4 doubles a
// thread, within 32 doubles; 1 to 8.
__host__ __device__ constexpr int mma_scenarios(int e, int nt) {
  const int s = 8 / (e * nt);
  return s < 1 ? 1 : s;
}

// The k steps of the exponent (d padded to 4 or 8) and the n tiles of the
// contraction (1 + d padded to 8 or 16).
__host__ __device__ constexpr int mma_ks(int d) { return d > 4 ? 2 : 1; }
__host__ __device__ constexpr int mma_nt(int d) { return d + 1 > 8 ? 2 : 1; }
// Row strides of the staged a and aod (see the note above).
__host__ __device__ constexpr int mma_kp(int ks) { return ks == 1 ? 4 : 12; }
__host__ __device__ constexpr int mma_ap(int nt) { return 8 * nt + 2; }
// The row stride of a staged blam tile (the block's 64 output rows, padded:
// a half-warp's fragment loads hit 16 distinct 8-byte banks; as float, 68,
// a warp's loads hit 32 distinct 4-byte banks). A multiple of 16 bytes.
constexpr int kMmaBlamStride = kMmaTileRows + 2;
constexpr int kMmaBlamStrideF32 = kMmaTileRows + 4;

// Dynamic shared memory: two staging buffers of a chunk of a and aod for S
// scenarios (and, staging blam, the probe's mma_blsmem, of the block's blam
// tile of the chunk).
__host__ __device__ constexpr size_t mma_smem_bytes(int s, int e, int ks,
                                                    int nt,
                                                    bool stage_blam = false) {
  return sizeof(double) * 2 *
         (static_cast<size_t>(s) * kMmaChunk * (mma_kp(ks) + mma_ap(nt)) +
          (stage_blam ? static_cast<size_t>(e) * kMmaChunk * kMmaBlamStride
                      : 0));
}

struct MmaPlan {
  int s;
  dim3 grid;
  size_t smem;
};

// The launch of B scenarios and n_out output rows at S scenarios a block:
// grid (row tiles, scenario blocks), each block 4 warps, the whole
// contraction in each.
inline MmaPlan mma_plan_at(int s, int b, int n_out, int e, int d) {
  MmaPlan p{};
  p.s = s;
  p.grid = dim3(static_cast<unsigned>((n_out + kMmaTileRows - 1) /
                                      kMmaTileRows),
                static_cast<unsigned>((b + s - 1) / s));
  p.smem = mma_smem_bytes(s, e, mma_ks(d), mma_nt(d));
  return p;
}

// K1's plan in this body: S = S_max where B >= S_max, else 1.
inline MmaPlan mma_plan(int b, int n_out, int e, int d) {
  const int smax = mma_scenarios(e, mma_nt(d));
  return mma_plan_at(b >= smax ? smax : 1, b, n_out, e, d);
}

// A grouped block's staged chunk of the slab, in bytes (blam_bytes 4 or 8
// an element), and how many it keeps: two (chunk t + 1 lands while chunk t
// is used) where two fit beside group_sets(d, E) sets' staging buffers and
// the exp table (1 KB of static shared memory), else one (an f64 slab at
// E >= 7), refilled after each chunk's last barrier.
__host__ __device__ constexpr size_t mma_blam_chunk_bytes(int e,
                                                          int blam_bytes) {
  return static_cast<size_t>(e) * kMmaChunk *
         (blam_bytes == 8 ? kMmaBlamStride : kMmaBlamStrideF32) * blam_bytes;
}
__host__ __device__ constexpr int mma_blam_bufs(int e, int ks, int nt,
                                                int blam_bytes) {
  return 2 * mma_blam_chunk_bytes(e, blam_bytes) +
                     group_sets_nt(e, nt) * mma_smem_bytes(1, e, ks, nt) +
                     64 * sizeof(double2) <=
                 static_cast<size_t>(kMaxSmemBytes)
             ? 2
             : 1;
}

// Dynamic shared memory of a grouped block: its staged chunks of the slab,
// then each of its `sets` sets' two staging buffers of a and aod (one
// scenario).
__host__ __device__ constexpr size_t mma_group_smem_bytes(int sets, int e,
                                                          int ks, int nt,
                                                          int blam_bytes) {
  return mma_blam_bufs(e, ks, nt, blam_bytes) *
             mma_blam_chunk_bytes(e, blam_bytes) +
         static_cast<size_t>(sets) * mma_smem_bytes(1, e, ks, nt);
}

// K1's grouped form in this body: group_blocks over group_sets(d, E)
// sets, 32 x kMmaStrips threads a set.
inline GroupPlan mma_group_plan(int b, int n_out, int e, int d, int group,
                                int blam_bytes) {
  GroupPlan p{};
  group_blocks(group, group_sets(d, e), &p.sets, &p.gblocks);
  p.grid = dim3(static_cast<unsigned>((n_out + kMmaTileRows - 1) /
                                      kMmaTileRows),
                static_cast<unsigned>((b / group) * p.gblocks));
  p.block = dim3(32, kMmaStrips, static_cast<unsigned>(p.sets));
  p.smem = mma_group_smem_bytes(p.sets, e, mma_ks(d), mma_nt(d), blam_bytes);
  return p;
}

// The route of a tied f64 launch: this body (1) where its grid at S_max
// scenarios a block holds at least one block for every SM, else the scalar
// body's plan (0), which at such a grid splits the contraction or serves
// fewer scenarios a block and was the faster of the two at every such
// shape the paths launch (PERF.md).
inline int tied_route(int b, int n_out, int n_c, int d, int e, int sms,
                      int group = 0) {
  (void)n_c;
  const long long tiles = (n_out + kMmaTileRows - 1) / kMmaTileRows;
  const int smax = mma_scenarios(e, mma_nt(d));
  return tiles * scenario_blocks(b, group, smax) >= sms ? 1 : 0;
}

// c += a b, one m16n8k4 f64 MMA: a0 = A(g, t), a1 = A(g + 8, t); b0 =
// B(t, g); c0, c1 = C(g, 2t), C(g, 2t + 1); c2, c3 = C(g + 8, 2t),
// C(g + 8, 2t + 1).
__device__ __forceinline__ void mma_k4(double (&c)[4], double a0, double a1,
                                       double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// c += a b, one m16n8k8 f64 MMA: a0 = A(g, t), a1 = A(g + 8, t), a2 =
// A(g, t + 4), a3 = A(g + 8, t + 4); b0 = B(t, g), b1 = B(t + 4, g); c as
// mma_k4.
__device__ __forceinline__ void mma_k8(double (&c)[4], double a0, double a1,
                                       double a2, double a3, double b0,
                                       double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// 2^(j / 64) for j in [0, 64) as the double nearest it (hi) and the rest
// (lo), from Python's decimal at 60 digits
// (tests/test_torch_rw_f64_plan.py recomputes them).
__device__ const double kExp2Table[64][2] = {
    {1.0, 0.0},
    {1.0108892860517005, -1.5234778603368577e-17},
    {1.0218971486541166, 5.109225028973444e-17},
    {1.0330248790212284, 7.600838874027088e-18},
    {1.0442737824274138, 8.551889705537965e-17},
    {1.0556451783605572, 1.759325738772092e-18},
    {1.0671404006768237, -7.899853966841582e-17},
    {1.0787607977571199, -6.656660436056593e-17},
    {1.0905077326652577, -3.046782079812471e-17},
    {1.102382583307841, 5.2660368715706944e-17},
    {1.1143867425958924, 1.0410278456845571e-16},
    {1.1265216186082418, 5.165856758795457e-17},
    {1.1387886347566916, 8.912812676025408e-17},
    {1.1511892299529827, 3.250710218863827e-17},
    {1.1637248587775775, 3.8292048369240935e-17},
    {1.1763969916502812, 5.554203254218079e-17},
    {1.189207115002721, 3.982015231465646e-17},
    {1.202156731452703, 6.644981499252301e-17},
    {1.215247359980469, -7.712630692681488e-17},
    {1.22848053610687, -1.89878163130253e-17},
    {1.241857812073484, 4.658027591836937e-17},
    {1.255380757024691, -6.7113898212968784e-18},
    {1.2690509571917332, 2.667932131342186e-18},
    {1.2828700160787783, 1.713594918243561e-17},
    {1.2968395546510096, 2.5382502794888315e-17},
    {1.3109612115247644, -7.181536135519454e-17},
    {1.3252366431597413, -2.8587312100388614e-17},
    {1.339667524053303, 8.927282594831732e-17},
    {1.3542555469368927, 7.70094837980299e-17},
    {1.3690024229745905, 9.593797919118849e-17},
    {1.383909881963832, -6.770511658794786e-17},
    {1.3989796725383112, -9.614213209051323e-17},
    {1.4142135623730951, -9.667293313452913e-17},
    {1.42961333839197, -1.2031642489053655e-17},
    {1.4451808069770467, -3.0237581349939873e-17},
    {1.460917794180647, -5.600377186075216e-17},
    {1.4768261459394993, -3.483994556892796e-17},
    {1.4929077282912648, 1.4192920154284036e-17},
    {1.5091644275934228, -1.016455327754295e-16},
    {1.5255981507445384, -1.1024941712342561e-16},
    {1.5422108254079407, 7.949834809697621e-17},
    {1.559004400237837, 3.7812070533575275e-17},
    {1.5759808451078865, -1.0136916471278304e-17},
    {1.593142151342267, -1.0094406542311964e-16},
    {1.6104903319492543, 2.4707192569797888e-17},
    {1.6280274218573478, -6.712955084707084e-17},
    {1.645755478153965, -1.0125679913674773e-16},
    {1.6636765803267364, 5.8909926967131e-17},
    {1.681792830507429, 8.199010020581497e-17},
    {1.7001063537185235, -8.0237193703977e-18},
    {1.718619298122478, -1.851380418263111e-17},
    {1.7373338352737062, 3.164389299292957e-17},
    {1.7562521603732995, 2.960140695448873e-17},
    {1.7753764925265212, 6.429731796556572e-17},
    {1.7947090750031072, 1.8227458427912087e-17},
    {1.8142521755003989, -9.969531538920349e-17},
    {1.8340080864093424, 3.283107224245627e-17},
    {1.8539791250833855, 9.761887490727594e-17},
    {1.8741676341103, -6.122763413004143e-17},
    {1.8945759815869656, 3.4034035352165297e-17},
    {1.9152065613971474, -1.0619946056195963e-16},
    {1.9360617934922943, 1.0332385960676326e-16},
    {1.9571441241754002, 8.960767791036668e-17},
    {1.978456026387951, 4.0388753109278167e-17},
};

// exp(x) for |x| < 707 (where exp(x) is a normal double, far from the
// overflow), branch-free, from the table in shared memory: x = k ln2 / 64 +
// r (|r| <= ln2 / 128, the two-part ln2 / 64 of fdlibm), exp(r) - 1 = q by
// its degree-5 Taylor polynomial (truncation below 0.2 ulp), 2^(j/64)
// (1 + q) as hi + (hi q + lo), then 2^(k >> 6) added to the exponent bits
// as an integer: 11 FP64 instructions, no branch, so that a warp's exps
// interleave. Outside |x| < 707 (exp_fast_ok false) its value is not exp's:
// the caller takes exp there.
__device__ __forceinline__ bool exp_fast_ok(double x) {
  return (__double2hiint(x) & 0x7fffffff) < 0x40861800;   // |x| < 707
}

__device__ __forceinline__ double exp_fast(double x, const double2* tab) {
  constexpr double kShift = 6755399441055744.0;        // 1.5 * 2^52
  constexpr double kInvL = 92.33248261689366;          // 64 / ln 2
  constexpr double kLHi = 0.6931471803691238 / 64;     // ln 2 / 64, 32 bits
  constexpr double kLLo = 1.9082149292705877e-10 / 64;  // the rest
  const double kd = fma(x, kInvL, kShift);
  const int k = __double2loint(kd);
  const double kr = kd - kShift;
  double r = fma(kr, -kLHi, x);
  r = fma(kr, -kLLo, r);
  double p = fma(r, 1.0 / 120, 1.0 / 24);
  p = fma(r, p, 1.0 / 6);
  p = fma(r, p, 0.5);
  const double q = fma(r * r, p, r);
  const double2 t = tab[k & 63];
  const double y = t.x + fma(t.x, q, t.y);
  return __hiloint2double(__double2hiint(y) + (k >> 6) * (1 << 20),
                          __double2loint(y));
}

// The table-driven exp at any x: exp_fast, or exp outside its range.
__device__ __forceinline__ double table_exp(double x, const double2* tab) {
  return exp_fast_ok(x) ? exp_fast(x, tab) : exp(x);
}

// The body's stages, and the probe's variants that drop or swap one.
enum class MmaMode : int {
  kFull,      // K1: exp_fast on every exponent of a step, exp where out of
              // its range (one warp-uniform branch a step)
  kCudaExp,   // CUDA's exp (with its special-case branch) on each exponent
  kNoExp,     // w = -p / 4: no exp
  kNoDots,    // no contraction MMA: each thread adds blam w into its own
              // fragment, so column c sums the rows j = c mod 8
  kNoP,       // no exponent MMA: w = exp(-g_i[0] / 4)
};

// How a warp gets blam: loaded at its step, loaded one step ahead into
// registers (K1), or staged for the whole block with each chunk (cp.async,
// with a and aod; slower on the card: PERF.md).
enum class Blam : int { kAtStep, kAhead, kStaged };

// The compile-time choices of an instance: S scenarios a block, of which G
// at a time have their exponent tiles, exps and contraction interleaved
// (G divides S; more G is more independent FP64 work in flight and more
// registers); K8: the contraction (and a two-step exponent) as one m16n8k8
// in place of two m16n8k4; BL: how blam arrives; M: K1's stages or a
// probe's variant; BT: blam's element type; Sets: K1's grouped form
// (blockDim.z scenario sets of S a warp, the slab staged once a block).
template <int S_, int G_, bool K8_, Blam BL_, MmaMode M_ = MmaMode::kFull,
          typename BT_ = double, bool Sets_ = false>
struct MmaCfg {
  static constexpr int S = S_;
  static constexpr int G = G_;
  static constexpr bool K8 = K8_;
  static constexpr Blam BL = BL_;
  static constexpr MmaMode M = M_;
  using BT = BT_;
  static constexpr bool Sets = Sets_;
  static_assert(S % G == 0, "groups of G scenarios");
  static_assert(!Sets || BL == Blam::kStaged, "a grouped block stages blam");
};

// K1's grouped instance: one scenario a warp, its slab of BT staged.
template <typename BT>
using GroupCfg = MmaCfg<1, 1, true, Blam::kStaged, MmaMode::kFull, BT, true>;

// K1's instance at S scenarios a block: half of the scenarios interleaved
// at a time (the fastest of G = 1, 2, 4 at S = 4 on the card; PERF.md), the
// contraction as one m16n8k8 a step, blam one step ahead in registers.
template <int S>
using K1Cfg = MmaCfg<S, (S > 1 ? S / 2 : 1), true, Blam::kAhead>;

// E outputs; KS k steps of the exponent; NT n tiles of the contraction; C
// an MmaCfg.
template <int E, int KS, int NT, class C>
__global__ void __launch_bounds__(32 * kMmaStrips *
                                  (C::Sets ? group_sets_nt(E, NT) : 1))
rw_tied_mma_kernel(const double* __restrict__ g, const double* __restrict__ dv,
                   const double* __restrict__ a,
                   const double* __restrict__ aod,
                   const typename C::BT* __restrict__ blam,
                   double* __restrict__ rw, int b_total, int n_out, int n_c,
                   int d, int group, int gblocks) {
  using BT = typename C::BT;
  constexpr int S = C::S;
  constexpr int G = C::G;
  constexpr bool K8 = C::K8;
  constexpr MmaMode M = C::M;
  constexpr bool kSets = C::Sets;
  constexpr int KP = mma_kp(KS);
  constexpr int AP = mma_ap(NT);
  constexpr int kStageA = S * kMmaChunk * KP;
  constexpr int kStageAod = S * kMmaChunk * AP;
  // The probe's staged variant keeps blam in each buffer; the grouped form
  // stages it once a block, ahead of the sets' buffers.
  constexpr bool kStagedBlam = C::BL == Blam::kStaged && !kSets;
  constexpr int kBuf = kStageA + kStageAod +
                       (kStagedBlam ? E * kMmaChunk * kMmaBlamStride : 0);
  // The grouped form's slab of BT, staged in kBlamBufs chunks of kBlamBuf
  // elements (row stride kBlamStride: 66 doubles or 68 floats).
  constexpr int kBB = static_cast<int>(sizeof(BT));
  constexpr int kBlamStride = kBB == 8 ? kMmaBlamStride : kMmaBlamStrideF32;
  constexpr int kBlamBuf = kSets ? E * kMmaChunk * kBlamStride : 0;
  constexpr int kBlamBufs = kSets ? mma_blam_bufs(E, KS, NT, kBB) : 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BT* s_blam = reinterpret_cast<BT*>(smem_raw);
  const int set = kSets ? static_cast<int>(threadIdx.z) : 0;
  const int sets = kSets ? static_cast<int>(blockDim.z) : 1;
  double* smem = reinterpret_cast<double*>(smem_raw + kBlamBufs * kBlamBuf *
                                                          sizeof(BT))
                 + set * 2 * kBuf;
  __shared__ double2 s_tab[64];

  constexpr int nthreads = 32 * kMmaStrips;
  const int lane = threadIdx.x;
  const int strip = threadIdx.y;
  const int tid = strip * 32 + lane;
  // The block's threads, all sets: they stage the slab together.
  const int btid = set * nthreads + tid;
  const int bthreads = sets * nthreads;
  const int gq = lane >> 2;   // the fragments' groupID
  const int tq = lane & 3;    // and threadID_in_group
  const int i0 = blockIdx.x * kMmaTileRows + strip * kMmaRows;
  // The warp's scenarios: set `set` of block y of group blockIdx.y /
  // gblocks, whose scenarios read that group's blam slab and end with it.
  const int grp = static_cast<int>(blockIdx.y) / gblocks;
  const int b0 = grp * group +
                 ((static_cast<int>(blockIdx.y) - grp * gblocks) * sets + set) * S;
  const int b_end = min(b_total, (grp + 1) * group);
  blam += static_cast<size_t>(grp) * E * n_c * n_out;
  const int w1 = d + 1;
  // The slab's rows go by 16 bytes where n_out and the slab allow.
  constexpr int kVec = 16 / kBB;
  const bool blam_vec = n_out % kVec == 0 &&
                        reinterpret_cast<size_t>(blam) % 16 == 0;

  // exp_fast's table; first read after the first chunk's barrier.
  for (int q = btid; q < 64; q += bthreads)
    s_tab[q] = make_double2(kExp2Table[q][0], kExp2Table[q][1]);

  // The grouped form: stage contraction rows [j0, j0 + kMmaChunk) of the
  // slab on the block's rows, (E, kMmaChunk, kBlamStride) of BT, at its
  // width, by all the block's threads; every element past n_c or n_out is
  // written 0.
  auto stage_blam = [&](int j0, BT* dst) {
    const int r0 = blockIdx.x * kMmaTileRows;
    if (blam_vec) {
      constexpr int kPerRow = kMmaTileRows / kVec;
      for (int q = btid; q < E * kMmaChunk * kPerRow; q += bthreads) {
        const int ej = q / kPerRow;   // e kMmaChunk + jj
        const int ii = (q - ej * kPerRow) * kVec;
        const int e = ej / kMmaChunk;
        const int j = j0 + ej - e * kMmaChunk;
        const bool ok = j < n_c && r0 + ii < n_out;
        cp_async16(dst + ej * kBlamStride + ii,
                   ok ? blam + (static_cast<size_t>(e) * n_c + j) * n_out + r0 + ii
                      : blam,
                   ok);
      }
    } else {
      for (int q = btid; q < E * kMmaChunk * kMmaTileRows; q += bthreads) {
        const int ej = q / kMmaTileRows;
        const int ii = q - ej * kMmaTileRows;
        const int e = ej / kMmaChunk;
        const int j = j0 + ej - e * kMmaChunk;
        const bool ok = j < n_c && r0 + ii < n_out;
        cp_async(dst + ej * kBlamStride + ii,
                 ok ? blam + (static_cast<size_t>(e) * n_c + j) * n_out + r0 + ii
                    : blam,
                 ok);
      }
    }
  };

  // Stage contraction rows [j0, j0 + kMmaChunk) of a and aod for the
  // block's scenarios, (S, kMmaChunk, KP) and (S, kMmaChunk, AP), and, with
  // kStagedBlam, blam on the block's rows, (E, kMmaChunk, kMmaBlamStride);
  // every element past d, 1 + d, n_c, n_out or B is written 0.
  auto stage = [&](int j0, double* buf) {
    if constexpr (kStagedBlam) {
      double* sbl = buf + kStageA + kStageAod;
      const int r0 = blockIdx.x * kMmaTileRows;
      for (int q = tid; q < E * kMmaChunk * kMmaTileRows; q += nthreads) {
        const int ej = q / kMmaTileRows;   // e kMmaChunk + jj
        const int ii = q - ej * kMmaTileRows;
        const int e = ej / kMmaChunk;
        const int j = j0 + ej - e * kMmaChunk;
        const bool ok = j < n_c && r0 + ii < n_out;
        cp_async(sbl + ej * kMmaBlamStride + ii,
                 ok ? blam + (static_cast<size_t>(e) * n_c + j) * n_out + r0 + ii
                    : blam,
                 ok);
      }
    }
    for (int q = tid; q < kStageA; q += nthreads) {
      const int s = q / (kMmaChunk * KP);
      const int r = q - s * (kMmaChunk * KP);
      const int jj = r / KP;
      const int k = r - jj * KP;
      const bool ok = b0 + s < b_end && j0 + jj < n_c && k < d;
      cp_async(buf + q,
               ok ? a + (static_cast<size_t>(b0 + s) * n_c + j0 + jj) * d + k
                  : a,
               ok);
    }
    double* bod = buf + kStageA;
    for (int q = tid; q < S * kMmaChunk * AP; q += nthreads) {
      const int s = q / (kMmaChunk * AP);
      const int r = q - s * (kMmaChunk * AP);
      const int jj = r / AP;
      const int c = r - jj * AP;
      const bool ok = b0 + s < b_end && j0 + jj < n_c && c < w1;
      cp_async(bod + q,
               ok ? aod + (static_cast<size_t>(b0 + s) * n_c + j0 + jj) * w1 + c
                  : aod,
               ok);
    }
  };

  // The exponent's A fragments, -G / 4 on the warp's 16 rows.
  double ga[S][KS][2];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i0 + gq + 8 * h;
        const int k = 4 * ks + tq;
        ga[s][ks][h] =
            (b0 + s < b_end && row < n_out && k < d)
                ? -0.25 * g[(static_cast<size_t>(b0 + s) * n_out + row) * d + k]
                : 0.0;
      }

  double acc[S][E][NT][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][e][nt][q] = 0.0;

  // blam at the thread's 4 fragment positions of the step at contraction
  // row jg: q = 2 h + p is row g + 8 h, column jg + 2t + p; 0 off the edges.
  auto load_blam = [&](int jg, double (&bl)[E][4]) {
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = i0 + gq + 8 * (q >> 1);
        const int j = jg + 2 * tq + (q & 1);
        bl[e][q] = (row < n_out && j < n_c)
                       ? blam[(static_cast<size_t>(e) * n_c + j) * n_out + row]
                       : 0.0;
      }
  };

  // The exponents -G A^T / 4 of scenario s at the step's rows (a row of
  // the staged chunk, KP wide) into p, the C fragment.
  auto exponent = [&](const double* ar, int s, double (&p)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = 0.0;
    if constexpr (K8 && KS == 2) {
      mma_k8(p, ga[s][0][0], ga[s][0][1], ga[s][1][0], ga[s][1][1], ar[tq],
             ar[4 + tq]);
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_k4(p, ga[s][ks][0], ga[s][ks][1], ar[4 * ks + tq]);
    }
  };

  // -g[i, 0] / 4 of scenario s at the fragment's 4 positions, from the
  // group's lane t = 0 (the kNoP variant's exponents).
  auto g0 = [&](int s, double (&p)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[q] = __shfl_sync(0xffffffffu, ga[s][0][q >> 1], lane & ~3);
  };

  // One step: the 8 contraction rows [jl, jl + 8) of the staged chunk, for
  // every scenario of the block, G scenarios at a time: their exponent
  // tiles, then their 4 G exps (branch-free, so that the FP64 chains
  // interleave), then their contraction.
  auto step = [&](const double* s_a, const double* s_aod, int jl,
                  const double (&bl)[E][4]) {
    double wa[S][4];
#pragma unroll
    for (int s0 = 0; s0 < S; s0 += G) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if constexpr (M == MmaMode::kNoP)
          g0(s0 + h, wa[s0 + h]);
        else
          exponent(s_a + ((s0 + h) * kMmaChunk + jl + gq) * KP, s0 + h,
                   wa[s0 + h]);
      }
      if constexpr (M == MmaMode::kCudaExp) {
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) wa[s0 + h][q] = exp(wa[s0 + h][q]);
      } else if constexpr (M != MmaMode::kNoExp) {
        bool ok = true;
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ok &= exp_fast_ok(wa[s0 + h][q]);
            wa[s0 + h][q] = exp_fast(wa[s0 + h][q], s_tab);
          }
        // Rare: an exponent outside exp_fast's range somewhere in the warp.
        // The whole warp recomputes the group's tiles (the MMAs need every
        // lane) and takes exp where exp_fast does not hold.
        if (__any_sync(0xffffffffu, !ok)) {
#pragma unroll
          for (int h = 0; h < G; ++h) {
            double p[4];
            if constexpr (M == MmaMode::kNoP)
              g0(s0 + h, p);
            else
              exponent(s_a + ((s0 + h) * kMmaChunk + jl + gq) * KP, s0 + h,
                       p);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (!exp_fast_ok(p[q])) wa[s0 + h][q] = exp(p[q]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const int sc = s0 + h;
        // aod rows jl + 2t (even) and jl + 2t + 1 (odd), column nt 8 + g.
        const double* od = s_aod + (sc * kMmaChunk + jl + 2 * tq) * AP + gq;
        double be[NT], bo[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          be[nt] = od[8 * nt];
          bo[nt] = od[AP + 8 * nt];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          double bw[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) bw[q] = bl[e][q] * wa[s0 + h][q];
          if constexpr (M == MmaMode::kNoDots) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[sc][e][0][q] += bw[q];
          } else {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if constexpr (K8) {
                mma_k8(acc[sc][e][nt], bw[0], bw[2], bw[1], bw[3], be[nt],
                       bo[nt]);
              } else {
                mma_k4(acc[sc][e][nt], bw[0], bw[2], be[nt]);
                mma_k4(acc[sc][e][nt], bw[1], bw[3], bo[nt]);
              }
            }
          }
        }
      }
    }
  };

  const int n_chunks = (n_c + kMmaChunk - 1) / kMmaChunk;
  if (n_chunks > 0) {
    stage(0, smem);
    if constexpr (kSets) stage_blam(0, s_blam);
  }
  cp_async_commit();
  double bl[E][4], bn[E][4];
  if constexpr (C::BL == Blam::kAhead) load_blam(0, bl);
  for (int t = 0; t < n_chunks; ++t) {
    const double* s_a = smem + (t & 1) * kBuf;
    const double* s_aod = s_a + kStageA;
    const double* s_bl = s_aod + kStageAod;
    const BT* s_blb = s_blam + (kBlamBufs == 2 ? (t & 1) * kBlamBuf : 0);
    // The other buffer was last read in chunk t - 1, before its barrier.
    if (t + 1 < n_chunks) {
      stage((t + 1) * kMmaChunk, smem + ((t + 1) & 1) * kBuf);
      if constexpr (kSets && kBlamBufs == 2)
        stage_blam((t + 1) * kMmaChunk, s_blam + ((t + 1) & 1) * kBlamBuf);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk t has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    for (int st = 0; st < kMmaSteps; ++st) {
      const int jg = t * kMmaChunk + st * kMmaStep;
      if constexpr (C::BL == Blam::kAhead) {
        load_blam(jg + kMmaStep, bn);
        step(s_a, s_aod, st * kMmaStep, bl);
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q) bl[e][q] = bn[e][q];
      } else if constexpr (C::BL == Blam::kStaged) {
        // q = 2 h + p: row g + 8 h of the strip, column 2t + p of the step;
        // the grouped form's slab widened to double here.
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int at = (e * kMmaChunk + st * kMmaStep + 2 * tq + (q & 1))
                               * (kSets ? kBlamStride : kMmaBlamStride)
                           + strip * kMmaRows + gq + 8 * (q >> 1);
            if constexpr (kSets)
              bl[e][q] = static_cast<double>(s_blb[at]);
            else
              bl[e][q] = s_bl[at];
          }
        step(s_a, s_aod, st * kMmaStep, bl);
      } else {
        load_blam(jg, bl);
        step(s_a, s_aod, st * kMmaStep, bl);
      }
    }
    __syncthreads();  // chunk t is consumed: its buffer may be refilled
    // One slab buffer: chunk t + 1's lands before the next chunk's wait
    // (the group committed here is older than the next chunk's a and aod).
    if constexpr (kSets && kBlamBufs == 1) {
      if (t + 1 < n_chunks) stage_blam((t + 1) * kMmaChunk, s_blam);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int b = b0 + s;
    if (b >= b_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + gq + 8 * h;
      if (row >= n_out) continue;
      const double dvi = dv[static_cast<size_t>(b) * n_out + row];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        double* out = rw + ((static_cast<size_t>(b) * E + e) * n_out + row) * w1;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int c = 8 * nt + 2 * tq + par;
            if (c < w1) out[c] = dvi * acc[s][e][nt][2 * h + par];
          }
      }
    }
  }
}

// Launch instance (E, KS, NT, C) at plan p; d is the runtime width (KS
// and NT must be those of d).
template <int E, int KS, int NT, class C>
cudaError_t launch_mma_at(const RwArgs<double>& a, int d, const MmaPlan& p) {
  const auto kernel = rw_tied_mma_kernel<E, KS, NT, C>;
  if (p.s != C::S || mma_ks(d) != KS || mma_nt(d) != NT ||
      p.grid.y > static_cast<unsigned>(kMmaMaxGridY))
    return cudaErrorInvalidValue;
  // An ungrouped launch is one group of all B over all of grid.y.
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err == cudaSuccess)
    kernel<<<p.grid, dim3(32, kMmaStrips), p.smem, a.stream>>>(
        a.g, a.dv, a.a, a.aod, a.blam, a.rw, a.b, a.n_out, a.n_c, d, a.b,
        static_cast<int>(p.grid.y));
  // A refused launch leaves its error as the thread's last error too: read
  // it here, so that the next launch starts clean.
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The instance of plan p for runtime (d, E): S_max(E, NT) or 1.
template <int E, int KS, int NT>
cudaError_t launch_mma_planned(const RwArgs<double>& a, int d,
                               const MmaPlan& p) {
  constexpr int SMax = mma_scenarios(E, NT);
  if (p.s == SMax) return launch_mma_at<E, KS, NT, K1Cfg<SMax>>(a, d, p);
  if constexpr (SMax > 1)
    if (p.s == 1) return launch_mma_at<E, KS, NT, K1Cfg<1>>(a, d, p);
  return cudaErrorInvalidValue;
}

// f(Int<E>{}, Int<KS>{}, Int<NT>{}) for runtime d, e in 1 .. 8, else bad.
template <typename R, typename F>
R with_mma_shape(int d, int e, R bad, F f) {
  return with_de(d, e, bad, [&](auto dd, auto ee) {
    constexpr int D = decltype(dd)::value;
    return f(ee, Int<mma_ks(D)>{}, Int<mma_nt(D)>{});
  });
}

// K1 in this body at its plan (mma_plan) for a card of `sms` SMs. (The
// functions that instantiate kernels are templates, so that a source that
// includes this header builds only the instances it launches.)
template <typename T>
cudaError_t dispatch_mma(int d, int e, const RwArgs<T>& p, int sms) {
  static_assert(std::is_same_v<T, double>, "the tensor-core body is f64");
  if (p.b <= 0 || p.n_out <= 0 || p.n_c < 0 || sms <= 0)
    return cudaErrorInvalidValue;
  const MmaPlan plan = mma_plan(p.b, p.n_out, e, d);
  return with_mma_shape(d, e, cudaErrorInvalidValue,
                        [&](auto ee, auto kk, auto nn) {
                          return launch_mma_planned<decltype(ee)::value,
                                                    decltype(kk)::value,
                                                    decltype(nn)::value>(
                              p, d, plan);
                        });
}

// The tied f64 launch: body -1 takes the route (tied_route), 0 the scalar
// body (rw_tied_body.cuh, its small-B plan), 1 this body.
template <typename T>
cudaError_t dispatch_routed(int d, int e, const RwArgs<T>& p, int sms,
                            int max_split, int body) {
  static_assert(std::is_same_v<T, double>, "the tensor-core body is f64");
  if (body < -1 || body > 1) return cudaErrorInvalidValue;
  if (body == -1)
    body = (p.b > 0 && p.n_out > 0 && sms > 0)
               ? tied_route(p.b, p.n_out, p.n_c, d, e, sms)
               : 0;
  if (body == 1) return dispatch_mma(d, e, p, sms);
  return dispatch<T>(d, e, p, sms, max_split);
}

// K1's grouped form in this body at plan p (mma_group_plan), its slab of
// BT.
template <int E, int KS, int NT, typename BT>
cudaError_t launch_mma_grouped(const GroupArgs<double>& a, int d,
                               const GroupPlan& p) {
  const auto kernel = rw_tied_mma_kernel<E, KS, NT, GroupCfg<BT>>;
  if (mma_ks(d) != KS || mma_nt(d) != NT || p.sets < 1 ||
      p.sets > group_sets_nt(E, NT) ||
      p.grid.y > static_cast<unsigned>(kMmaMaxGridY))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err == cudaSuccess)
    kernel<<<p.grid, p.block, p.smem, a.stream>>>(
        a.g, a.dv, a.a, a.aod, static_cast<const BT*>(a.blam), a.rw, a.b,
        a.n_out, a.n_c, d, a.group, p.gblocks);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename BT>
cudaError_t dispatch_mma_grouped(int d, int e, const GroupArgs<double>& a) {
  if (!group_ok(a.b, a.n_out, a.n_c, a.group)) return cudaErrorInvalidValue;
  const GroupPlan plan = mma_group_plan(a.b, a.n_out, e, d, a.group,
                                        static_cast<int>(sizeof(BT)));
  return with_mma_shape(d, e, cudaErrorInvalidValue,
                        [&](auto ee, auto kk, auto nn) {
                          return launch_mma_grouped<decltype(ee)::value,
                                                    decltype(kk)::value,
                                                    decltype(nn)::value, BT>(
                              a, d, plan);
                        });
}

// The grouped f64 launch, its slab float (blam_bytes 4) or double (8):
// body -1 takes the route (tied_route at the group), 0 the scalar body's
// grouped form, 1 this body's. (A template, as every function here that
// instantiates kernels, so that only the source that calls it builds them.)
template <typename T>
cudaError_t dispatch_grouped(int d, int e, const GroupArgs<T>& p,
                             int blam_bytes, int sms, int body) {
  static_assert(std::is_same_v<T, double>, "the grouped form is f64");
  if (body < -1 || body > 1 || (blam_bytes != 4 && blam_bytes != 8) ||
      !group_ok(p.b, p.n_out, p.n_c, p.group))
    return cudaErrorInvalidValue;
  if (body == -1)
    body = sms > 0 ? tied_route(p.b, p.n_out, p.n_c, d, e, sms, p.group) : 0;
  if (body == 1)
    return blam_bytes == 4 ? dispatch_mma_grouped<float>(d, e, p)
                           : dispatch_mma_grouped<double>(d, e, p);
  return blam_bytes == 4 ? dispatch_grouped_scalar<T, float>(d, e, p)
                         : dispatch_grouped_scalar<T, double>(d, e, p);
}

// A grouped plan of either body for the wrapper's check (put_group_plan);
// -1 on what no plan exists for.
template <typename T>
int group_plan_export(int body, int b, int n_out, int d, int e, int group,
                      int blam_bytes, long long* out) {
  if (body < 0 || body > 1 || (blam_bytes != 4 && blam_bytes != 8) ||
      d < 1 || d > 8 || e < 1 || e > 8 || !group_ok(b, n_out, 0, group))
    return -1;
  if (body == 1)
    return put_group_plan(mma_group_plan(b, n_out, e, d, group, blam_bytes),
                          out);
  return group_plan_export_scalar<T>(b, n_out, d, e, group, out);
}

// Blocks of this body's instance at (d, E, S) that an SM holds at once; -1
// on an error or an S that is not built.
template <typename T>
long long mma_blocks_per_sm(int d, int e, int s) {
  static_assert(std::is_same_v<T, double>, "the tensor-core body is f64");
  return with_mma_shape(d, e, -1LL, [&](auto ee, auto kk, auto nn) {
    constexpr int E = decltype(ee)::value;
    constexpr int KS = decltype(kk)::value;
    constexpr int NT = decltype(nn)::value;
    constexpr int SMax = mma_scenarios(E, NT);
    auto query = [&](auto kernel) {
      const size_t smem = mma_smem_bytes(s, E, KS, NT);
      int n = 0;
      if (allow_smem(kernel, smem) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, kernel, 32 * kMmaStrips, smem) != cudaSuccess)
        return -1LL;
      return static_cast<long long>(n);
    };
    if (s == SMax)
      return query(rw_tied_mma_kernel<E, KS, NT, K1Cfg<SMax>>);
    if constexpr (SMax > 1)
      if (s == 1) return query(rw_tied_mma_kernel<E, KS, NT, K1Cfg<1>>);
    return -1LL;
  });
}

}  // namespace

// The plain C interface of this body in the f64 library, for ctypes: its
// constants, its plan for the wrapper's check at load (out = S, grid x, y,
// shared bytes; 0, or -1 outside d, E in 1 .. 8), the
// route (1: this body, 0: the scalar body; `group` > 0 a grouped launch's)
// and the blocks an SM holds.
#define GPMPC_RW_TIED_MMA_EXPORTS                                             \
  extern "C" long long gpmpc_rw_tied_mma_rows_f64() { return kMmaTileRows; }  \
  extern "C" long long gpmpc_rw_tied_mma_chunk_f64() { return kMmaChunk; }    \
  extern "C" long long gpmpc_rw_tied_mma_scenarios_f64(int d, int e) {        \
    if (d < 1 || d > 8 || e < 1 || e > 8) return 0;                           \
    return mma_scenarios(e, mma_nt(d));                                       \
  }                                                                           \
  extern "C" int gpmpc_rw_tied_mma_plan_f64(int b, int n_out, int d, int e,   \
                                            long long* out) {                 \
    if (d < 1 || d > 8 || e < 1 || e > 8) return -1;                          \
    const MmaPlan p = mma_plan(b, n_out, e, d);                               \
    const long long v[4] = {p.s, p.grid.x, p.grid.y,                          \
                            static_cast<long long>(p.smem)};                  \
    for (int q = 0; q < 4; ++q) out[q] = v[q];                                \
    return 0;                                                                 \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_route_f64(int b, int n_out, int n_c,     \
                                               int d, int e, int sms,         \
                                               int group) {                   \
    return tied_route(b, n_out, n_c, d, e, sms, group);                       \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_mma_blocks_per_sm_f64(int d, int e,      \
                                                           int s) {           \
    return mma_blocks_per_sm<double>(d, e, s);                                \
  }

// The plain C interface of K1's grouped form (its own library,
// variance_trace_grouped.cu; f64 operands, the precision policy's): the
// launch (blam (b / group, E, n_c, n_out) of blam_bytes 4 or 8; body -1
// the route, 0 the scalar body, 1 this body; returns the cudaError_t,
// asynchronous on `stream`), its plan for the wrapper's check at load (out
// = sets, blocks a group, grid x, y, block x, y, z, shared bytes; -1 on
// what has no plan), kGroupRows, kMaxSets, group_sets per (d, E), and the
// error string.
#define GPMPC_RW_TIED_GROUPED_EXPORTS                                          \
  extern "C" int gpmpc_rw_tied_grouped_f64(                                   \
      const double* g, const double* dv, const double* a, const double* aod,  \
      const void* blam, int blam_bytes, double* rw, int b, int n_out,         \
      int n_c, int d, int e, int group, int sms, int body, void* stream) {    \
    const GroupArgs<double> p{g,   dv,    a,     aod,   blam, rw,             \
                              b,   n_out, n_c,   group,                       \
                              static_cast<cudaStream_t>(stream)};             \
    return static_cast<int>(                                                  \
        dispatch_grouped<double>(d, e, p, blam_bytes, sms, body));            \
  }                                                                           \
  extern "C" int gpmpc_rw_tied_grouped_plan_f64(                              \
      int body, int b, int n_out, int d, int e, int group, int blam_bytes,    \
      long long* out) {                                                       \
    return group_plan_export<double>(body, b, n_out, d, e, group, blam_bytes, \
                                     out);                                    \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_group_sets_f64(int d, int e) {           \
    if (d < 1 || d > 8 || e < 1 || e > 8) return 0;                           \
    return group_sets(d, e);                                                  \
  }                                                                           \
  extern "C" long long gpmpc_rw_tied_group_rows_f64() { return kGroupRows; }  \
  extern "C" long long gpmpc_rw_tied_max_sets_f64() { return kMaxSets; }      \
  extern "C" const char* gpmpc_rw_tied_grouped_error_string_f64(int err) {    \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                 \
  }
