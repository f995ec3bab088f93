"""The published peaks of one H100 and the least time of the variance
trace's rw function (K1, K2, K3) at a launch's shape.

A frozen copy of chip_smoke.py:405-432 (the peaks and EXP_F64_INSTR) and
chip_smoke.py:792-838 (`_bound`, `exp_flops`, `bound_ms`), so that a later
change to the program cannot move the yardstick.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32 and
# float64 outside the tensor cores, float64 on the tensor cores, and HBM3
# bandwidth. The FP64 tensor cores and the FP64 vector pipe share one
# datapath (66 TFLOP/s of m16n8k4 alone, 32 of DFMA alone, 38 for the two in
# one loop on one H100 80GB HBM3 at 700 W), so an f64 bound adds the two
# times.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_F64_TC_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP64 instructions (8 DFMA, 1 DMUL, 2 DADD) of the cheapest accurate double
# exp, read from the SASS of the kernels' exp for sm_90a; each takes one FP64
# issue slot, which the 34 TFLOP/s peak counts as the 2 flops of a DFMA.
EXP_F64_INSTR = 11


def _bound(flops, elems, f64=False, tc_flops=0, more_bytes=0):
    """(ms, what bounds it): the larger of the operations over the card's
    peaks for their type (f32: all of `flops` at the f32 peak; f64: `flops`
    on the FP64 vector pipe plus `tc_flops` on the FP64 tensor cores, which
    share it) and the bytes (elems of 8 or 4 bytes, and more_bytes) over
    its memory rate."""
    t_ops = (flops / (PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS)
             + tc_flops / PEAK_F64_TC_FLOPS)
    t_bytes = (elems * (8 if f64 else 4) + more_bytes) / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def exp_flops(f64: bool) -> int:
    """The flops a bound counts for one exp: expf as one; the double exp as
    its FP64 instructions at 2 flops each (EXP_F64_INSTR)."""
    return 2 * EXP_F64_INSTR if f64 else 1


def bound_ms(b, n_out, n_c, d, e, chains, f64=False, groups=1,
             blam_bytes=None):
    """Least time for the rw function (K1, K2, K3) on this card: the largest
    of its operations over the peak for their type and its bytes (each
    input read once, each output written once) over the memory rate. Per
    (i, j) pair and exp chain: d multiply-adds and one scale for the
    exponent, one exp (exp_flops), and per output one blam multiply and
    (1 + d) multiply-adds. In f32 all of them at the f32 peak; in f64 the
    scale, the exp and the blam multiplies on the vector pipe and the
    multiply-adds on the FP64 tensor cores, the two times added. K1's
    grouped form reads `groups` blam slabs, each once, at blam_bytes an
    element (None: the operands' width). Returns (ms, what bounds it)."""
    w1 = d + 1
    e_per_chain = e // chains
    pairs = b * n_out * n_c * chains
    elems = (b * n_out * (d + 1) * chains + b * n_c * (d + w1) * chains
             + b * e * n_out * w1)
    more = groups * e * n_c * n_out * (blam_bytes or (8 if f64 else 4))
    if not f64:
        return _bound(pairs * (2 * d + 1 + exp_flops(False)
                               + e_per_chain * (1 + 2 * w1)), elems,
                      more_bytes=more)
    return _bound(pairs * (1 + exp_flops(True) + e_per_chain), elems, True,
                  tc_flops=pairs * (2 * d + e_per_chain * 2 * w1),
                  more_bytes=more)


def trace_op_seconds(pairs, d, e, chains=1):
    """The least seconds of the operations of an f64 variance trace over
    `pairs` (i, j) pairs of one exp chain each (bound_ms's count, without
    the bytes): the exponent's scale, the exp and the blam multiplies on
    the FP64 vector pipe, the multiply-adds on the FP64 tensor cores."""
    w1 = d + 1
    e_per_chain = e // chains
    return (pairs * chains * (1 + exp_flops(True) + e_per_chain)
            / PEAK_F64_FLOPS
            + pairs * chains * (2 * d + e_per_chain * 2 * w1)
            / PEAK_F64_TC_FLOPS)
