// K4's double instances: the ones the GPMPC_SYM_KERNEL=1 opt-in launches,
// from f32 operands too (the trace's precision policy), and the f64
// reference objective through the symmetric pairs. The kernels are in
// rw_sym_body.cuh and their note at the head of variance_trace_sym.cu; this
// file only gives the double instances a library of their own, built beside
// the float one.

#include "rw_sym_body.cuh"

GPMPC_RW_SYM_EXPORTS(double, f64)
