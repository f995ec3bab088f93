// K1's double instances (K1, K2 and K3 in f64): the instances every solver
// path launches, from f32 operands too (the trace's precision policy), and
// the reference objective on the card. The kernel and its note are in
// variance_trace_tied.cu and rw_tied_body.cuh; this file only gives the
// double instances a library of their own, built beside the float one.

#include "rw_tied_body.cuh"

GPMPC_RW_TIED_EXPORTS(double, f64)
