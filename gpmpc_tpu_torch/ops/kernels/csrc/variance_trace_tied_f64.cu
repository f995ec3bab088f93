// K1's double instances (K1, K2 and K3 in f64): the instances every solver
// path launches, from f32 operands too (the trace's precision policy), and
// the reference objective on the card. A tied launch (K1, K3) takes the
// route of `tied_route` (dispatch_routed, rw_tied_f64_body.cuh): the tensor-core body of
// rw_tied_f64_body.cuh, whose note gives its design and bound, or the scalar
// body's small-B plan (rw_tied_body.cuh); K2 is the scalar body's untied
// mode. The scalar kernel's note is in variance_trace_tied.cu and
// rw_tied_body.cuh; this file gives the double instances a library of their
// own, built beside the float one.

#include "rw_tied_body.cuh"
#include "rw_tied_f64_body.cuh"

GPMPC_RW_TIED_EXPORTS(double, f64, dispatch_routed<double>)
GPMPC_RW_TIED_MMA_EXPORTS
