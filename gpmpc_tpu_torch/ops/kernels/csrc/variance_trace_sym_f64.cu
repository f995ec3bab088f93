// K4's double instances (the f64 reference objective on the card through
// the symmetric pairs). The kernels are in rw_sym_body.cuh and their note at
// the head of variance_trace_sym.cu; this file only gives the double
// instances a library of their own, built beside the float one.

#include "rw_sym_body.cuh"

GPMPC_RW_SYM_EXPORTS(double, f64)
