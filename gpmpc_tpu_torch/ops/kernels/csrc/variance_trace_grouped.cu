// K1's grouped form: the tied variance trace with one blam slab a group of
// scenarios (one GP a lane), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_rw_tied_streamed_kernel` under JAX's vmap
// (the `pallas_call` of `_rw_call_tied`, gpmpc_tpu/ops/pallas/
// variance_trace.py, batched over a lane axis of blam): the batched
// episode's multistart route, each lane's candidates against its own GP.
// The bodies are K1's: rw_tied_f64_body.cuh (the f64 tensor-core body,
// where the route sends a launch) and rw_tied_body.cuh (the scalar body),
// each in its grouped form, whose notes give the design: a block of up to
// group_sets(d, E) scenario sets of one scenario each, so that a group's
// candidates fill its slots, and the group's slab read once a launch at
// the width the fit stored it (f32 or f64), widened in registers.
//
// Bound on an H100 (chip_smoke.py's bound_ms, with the slab's bytes at its
// width): the FP64 operations at the recipe's five a group, (1,280, 512,
// d = 3, E = 2): 0.3569 ms; the slab's bytes at one a group, (256, 512):
// 0.1662 ms for an f32 slab (0.54 GB).
//
// Its own library, built beside K1's: its 256 instances (64 (d, E) x two
// bodies x two slab widths) keep every source's build within budget.
// Operands are f64 (the precision policy); a trace in f32 arithmetic
// (native=True) does not take the grouped form on the card.

#include "rw_tied_body.cuh"
#include "rw_tied_f64_body.cuh"

GPMPC_RW_TIED_GROUPED_EXPORTS
