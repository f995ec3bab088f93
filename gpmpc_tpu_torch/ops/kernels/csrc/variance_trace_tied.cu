// K1: the tied variance-trace kernel, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_rw_tied_streamed_kernel`, dispatched by
// `_rw_call_tied` in gpmpc_tpu/ops/pallas/variance_trace.py. K3
// (`_rw_call_tied_nm`, this shard's rows against all contraction rows)
// launches the same kernel; K2 (`_rw_call`, which the JAX package runs as
// K1 at E = 1 once per output) is the body's untied mode, one launch a
// trace with the outputs on the grid (`gpmpc_rw_untied_*`). For scenario b,
// output e, output row i and column c in [0, 1 + d):
//
//   rw[b,e,i,c] = dv[b,i] * sum_j blam[e,j,i] * exp(-1/4 sum_k a[b,j,k] g[b,i,k])
//                                             * aod[b,j,c]
//
// with aod = dv o [1 | a] over the contraction rows. One exp chain serves all
// E outputs (tied lengthscales share M2).
//
// Bound on an H100: operations. One call does B * n_out * n_c (i, j) pairs;
// each pair costs 2d + 2 flops for the exponent and its scale and exp, and
// per output one blam multiply and 1 + d multiply-adds: 0.0065 ms at the
// headline shape (B = N = 256, d = 3, E = 2, f32) at 67 TFLOP/s, against
// ~0.0006 ms to move the bytes (chip_smoke.py's bound_ms).
//
// The first design (a thread an output row, a block one scenario,
// each thread's chain all n_c rows long) took 0.063 ms, held back by the
// chain's latency of E scalar L2 loads of blam a step. The kernel is now K1's
// body in rw_tied_body.cuh, whose note gives the numbers and the design:
// S scenarios a block share each blam load, the contraction is split across
// the block's warps and their partials summed in a fixed order, and a and
// aod are read as 16-byte broadcasts; at a small B a block serves only the
// scenarios there are, and a grid that would leave the card mostly idle
// splits the contraction over a thread-block cluster. The block shape
// (64 rows x 4 slices) is a constexpr of the body, and the launch plan is
// mirrored by `rw_tied_plan` and `rw_untied_plan` in
// ops/kernels/variance_trace.py; the probe (variance_trace_probe.cu)
// instantiates the same body under its variants.
//
// Precision: the trace cancels (on the headline GP sum |terms| / |result|
// reaches 1e3-1e6), so the exp is the accurate expf (never __expf or
// --use_fast_math) and the (1+d)-wide reduction is exact FMAs. Even so an
// f32 evaluation costs the solver its quality, so the solver's paths launch
// the double instances from f32 operands upcast by the wrapper (the
// precision policy of ops/kernels/variance_trace.py; PERF.md, fault F1).
// These float instances stay built and held against their plain versions;
// they serve callers that ask for native f32 arithmetic. The double
// instances are built from variance_trace_tied_f64.cu into a library of
// their own, so that the two build side by side.

#include "rw_tied_body.cuh"

GPMPC_RW_TIED_EXPORTS(float, f32, dispatch_scalar_tied<float>)
