"""P1 and P2 on the card: K1's body under its variants.

Port of the TPU probes `call_variant` (benchmarks/kernel_ablate.py) and
`call` (benchmarks/kernel_probe.py). The CUDA source
(csrc/variance_trace_probe.cu) instantiates K1's own body
(csrc/rw_tied_body.cuh) once per variant, so `full` is the kernel the solve
launches, at K1's own launch plan (`variance_trace.rw_tied_plan`: at a small
B fewer scenarios a block and the contraction split over a cluster); every
other variant runs at S_max scenarios a block with no split, K1's plan at
the headline shape where the probes are timed. Each variant computes a defined function of K1's arguments
(g, dv, a, aod, blam; `variance_trace.rw_tied`), given by its plain version
`rw_probe_reference`:

    full          K1: rw[b,e,i,c] = dv_i sum_j blam[e,j,i] exp(-p_ji / 4)
                  aod[j,c], p_ji = a_j . g_i
    full_tile256  the same, twice K1's contraction rows staged per step
                  (256 at K1's plan)
    full_s1       the same with scenario sharing off (S = 1 a block)
    plan_RxK      the same at a block of R output rows x K contraction
                  slices (K1's is ROWS x SLICES = 64 x 4)
    hwexp         the same with __expf (plain version: torch.exp)
    noexp         w = -p / 4 in place of exp(-p / 4)
    nop           w = g_i[0]
    nodots        column 0 only: dv_i sum_j blam w; columns 1..d are 0
    nomul         bw = w (no blam): every output gets dv_i sum_j w aod
    empty         column 0 only: dv_i sum over tiles of blam[e, j0, i], one
                  j0 every EMPTY_TILE rows (K1's staged tile)
    red_tf32      the reduction on the tensor cores, TF32 operands, one pass
    red_3xtf32    the same at 3xTF32 (hi.hi + hi.lo + lo.hi)
    tc_p          p at 3xTF32 on the tensor cores, then K1's exp and sums

At f64 (F64_VARIANTS) the scalar body's variants are built again at
T = double (hwexp and the TF32 ones are f32 only), K1's f64 instance before
the tensor-core body, beside the tensor-core body of
csrc/rw_tied_f64_body.cuh (all of them computing `full`):

    mma           K1's f64 instance where the route takes that body, at its
                  plan (`variance_trace.rw_tied_mma_plan`: S = 4 scenarios a
                  block, the exps of G = 2 of them interleaved)
    mma_s2, s8    (S, G) = (2, 1), (8, 4)
    mma_g1, g4    G = 1 or 4
    mma_k4        the contraction as two m16n8k4 per step, not one m16n8k8
    mma_cexp      CUDA's exp (a branch in every exp) in place of exp_fast
    mma_nopf      blam loaded at its step, not one step ahead
    mma_blsmem    blam staged in shared memory with each chunk
    mma_noexp     w = -p / 4 (as noexp)
    mma_nodots    no contraction MMA: column c sums dv_i blam w over the
                  rows j = c mod 8
    mma_nop       no exponent MMA: w = exp(-g_i[0] / 4)

Only d = 3 and E = 2 (the headline) is built; anything else raises.
`rw_probe` launches the kernel for CUDA tensors and takes the plain version
for CPU tensors only. `checks` gives the plain versions a variant's kernel
output is held to on the card, each with its elementwise bar.
"""

from __future__ import annotations

import ctypes

import torch

from gpmpc_tpu_torch.ops.kernels import _build
from gpmpc_tpu_torch.ops.kernels import variance_trace as vt

# In the order of the source's variant ids.
VARIANTS = ('full', 'full_tile256', 'hwexp', 'noexp', 'nop', 'nodots',
            'nomul', 'empty', 'red_tf32', 'red_3xtf32', 'tc_p', 'full_s1',
            'plan_32x8', 'plan_128x2', 'plan_64x2', 'plan_32x4')
# The variants built at f64, in the order of the source's f64 ids.
F64_VARIANTS = ('full', 'full_s1', 'noexp', 'nop', 'nodots', 'nomul',
                'empty', 'mma', 'mma_s2', 'mma_s8', 'mma_k4', 'mma_cexp',
                'mma_noexp', 'mma_nodots', 'mma_nop', 'mma_g1', 'mma_g4',
                'mma_nopf', 'mma_blsmem')
MMA_VARIANTS = tuple(v for v in F64_VARIANTS if v.startswith('mma'))
# The tensor-core body's variants that compute K1's function (`full`).
MMA_FULL = tuple(v for v in MMA_VARIANTS
                 if v not in ('mma_noexp', 'mma_nodots', 'mma_nop'))
# K1's function at other launch plans than K1's own.
PLANS = tuple(v for v in VARIANTS if v.startswith('plan_'))
TENSOR_CORE = ('red_tf32', 'red_3xtf32', 'tc_p')
EMPTY_TILE = vt.SLICES * vt.SUB_ROWS   # the tile K1's plan stages a step
D, E = 3, 2             # the only shape the probe source instantiates

# Launches of the probe kernel, counted where they happen.
LAUNCHES_PROBE = 0

_LIB = 'variance_trace_probe'
EPS32 = 2.0 ** -23      # torch.finfo(torch.float32).eps
EPS64 = 2.0 ** -52      # torch.finfo(torch.float64).eps
F64_RTOL = 1e-12
FWD_TOL = dict(rtol=5e-5, atol=5e-5)
# CUDA C++ Programming Guide, single-precision intrinsics: __expf(x) has a
# maximum error of 2 + floor(|1.173 x|) ulp.
HWEXP_ULP = (2.0, 1.173)


# ------------------------------------------------------------------ TF32 --
def tf32_round(x):
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero,
    as `wmma::__float_to_tf32` (cvt.rna.tf32.f32) rounds: add half of the 13
    dropped bits to the magnitude on the int32 view, then clear them."""
    if x.dtype != torch.float32:
        raise TypeError(f'tf32_round takes float32, got {x.dtype}')
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """(hi, lo), both TF32, with hi + lo = x to within 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


# --------------------------------------------------------- plain versions --
def _check_variant(variant):
    if variant not in VARIANTS + MMA_VARIANTS:
        raise ValueError(f'unknown probe variant {variant!r}; one of '
                         f'{VARIANTS + MMA_VARIANTS}')


def _check(variant, g, dv, a, aod, blam):
    _check_variant(variant)
    vt._check(g, dv, a, aod, blam)
    if g.shape[-1] != D or blam.shape[0] != E:
        raise ValueError(f'the probe is built for d = {D}, E = {E}; got '
                         f'd = {g.shape[-1]}, E = {blam.shape[0]}')
    built = {torch.float32: VARIANTS, torch.float64: F64_VARIANTS}
    if variant not in built.get(g.dtype, ()):
        raise TypeError(f'probe {variant} is not built for {g.dtype}')


def _exponent(a, g):
    """p[b, j, i] = a_j . g_i."""
    return torch.einsum('bjk,bik->bji', a, g)


def _exponent_3xtf32(a, g):
    """p as tc_p's tensor cores form it: hi.hi + hi.lo + lo.hi of g and a."""
    gh, gl = tf32_split(g)
    ah, al = tf32_split(a)
    return _exponent(ah, gh) + _exponent(al, gh) + _exponent(ah, gl)


def _reduce(blam, w, aod, dv):
    """rw_tied_reference's reduction of a given W (B, Nc, Nout)."""
    rw = torch.einsum('eji,bji,bjc->beic', blam, w, aod)
    return dv[:, None, :, None] * rw


def _column0(r0, dv, shape):
    out = torch.zeros(shape, dtype=r0.dtype, device=r0.device)
    out[..., 0] = dv[:, None, :] * r0
    return out


def _columns_mod8(blam, w, dv, shape):
    """mma_nodots: rw[b,e,i,c] = dv_i sum over j = c mod 8 of blam[e,j,i]
    w[b,j,i], for c < 1 + d (each thread of the MMA's fragment keeps its
    own columns 2t, 2t+1 of every step of 8 rows)."""
    bw = torch.einsum('eji,bji->beji', blam, w)
    cols = [bw[:, :, c::8].sum(dim=2) for c in range(shape[-1])]
    return dv[:, None, :, None] * torch.stack(cols, dim=-1)


def _weights(variant, g, a):
    """W (B, Nc, Nout) of a variant that has one."""
    if variant == 'nop':
        return g[:, None, :, 0].expand(g.shape[0], a.shape[1], g.shape[1])
    if variant == 'mma_nop':
        return torch.exp(-0.25 * g[:, None, :, 0]).expand(
            g.shape[0], a.shape[1], g.shape[1])
    if variant in ('noexp', 'mma_noexp'):
        return -0.25 * _exponent(a, g)
    if variant == 'tc_p':
        return torch.exp(-0.25 * _exponent_3xtf32(a, g))
    return torch.exp(-0.25 * _exponent(a, g))


def magnitude(variant, g, dv, a, aod, blam):
    """The terms' magnitude sum of a variant's plain version: the same sums
    over |blam|, |W|, |aod| and |dv|, in f64."""
    g, dv, a, aod, blam = (t.double() for t in (g, dv, a, aod, blam))
    if variant == 'empty':
        return rw_probe_reference(variant, g, dv.abs(), a, aod.abs(),
                                  blam.abs())
    w = _weights(variant, g, a).abs()
    b, n_out = dv.shape
    if variant == 'mma_nodots':
        return _columns_mod8(blam.abs(), w, dv.abs(),
                             (b, blam.shape[0], n_out, aod.shape[-1]))
    if variant == 'nodots':
        return _column0(torch.einsum('eji,bji->bei', blam.abs(), w),
                        dv.abs(), (b, blam.shape[0], n_out, aod.shape[-1]))
    if variant == 'nomul':
        r = torch.einsum('bji,bjc->bic', w, aod.abs())
        return (dv.abs()[:, None, :, None] * r[:, None]).expand(
            b, blam.shape[0], n_out, aod.shape[-1]).contiguous()
    return _reduce(blam.abs(), w, aod.abs(), dv.abs())


def rw_probe_reference(variant, g, dv, a, aod, blam):
    """The plain PyTorch version of `variant`, in the inputs' dtype (f64 for
    the scalar variants' oracle; the tensor-core variants emulate TF32 and
    take f32 only). Shapes as `variance_trace.rw_tied_reference`."""
    _check_variant(variant)
    if variant in ('full', 'full_tile256', 'full_s1', 'hwexp') + PLANS \
            + MMA_FULL:
        return vt.rw_tied_reference(g, dv, a, aod, blam)
    if variant in TENSOR_CORE and g.dtype != torch.float32:
        raise TypeError(f'{variant} emulates TF32 and takes float32')
    b, n_out = dv.shape
    shape = (b, blam.shape[0], n_out, aod.shape[-1])
    if variant == 'empty':
        return _column0(blam[:, ::EMPTY_TILE].sum(dim=1)[None], dv, shape)
    w = _weights(variant, g, a)
    if variant == 'mma_nodots':
        return _columns_mod8(blam, w, dv, shape)
    if variant == 'nodots':
        return _column0(torch.einsum('eji,bji->bei', blam, w), dv, shape)
    if variant == 'nomul':
        r = torch.einsum('bji,bjc->bic', w, aod)
        return (dv[:, None, :, None] * r[:, None]).expand(shape).contiguous()
    if variant == 'red_tf32':
        bw = blam[None] * w[:, None]                     # (B, E, Nc, Nout)
        r = torch.einsum('beji,bjc->beic', tf32_round(bw), tf32_round(aod))
        return dv[:, None, :, None] * r
    if variant == 'red_3xtf32':
        bh, bl = tf32_split(blam[None] * w[:, None])
        ah, al = tf32_split(aod)
        r = sum(torch.einsum('beji,bjc->beic', x, y)
                for x, y in ((bh, ah), (bh, al), (bl, ah)))
        return dv[:, None, :, None] * r
    return _reduce(blam, w, aod, dv)                     # nop, noexp, tc_p


# ------------------------------------------------------------------ bars --
def _magnitude(weight, aod, dv):
    """dv_i sum_j weight[b,e,j,i] |aod[j,c]| in f64: weight (B, E, Nc, Nout)."""
    r = torch.einsum('beji,bjc->beic', weight, aod.abs().double())
    return dv.abs().double()[:, None, :, None] * r


def checks(variant, g, dv, a, aod, blam):
    """[(label, want, bar)]: the f64 values a variant's f32 kernel output is
    held to on these f32 inputs, elementwise |rw - want| <= bar.

    An f64 variant on f64 inputs: its plain version in f64 within
    F64_RTOL |want| plus 16 f64 ulps of the terms' magnitude sum (phase 3's
    bar for the kernels' f64 instances), plus the smallest normal double.

    Scalar variants: their plain version in f64, rtol 5e-5 and atol 5e-5
    (the JAX kernel test's bars). hwexp: the plain f64 `full`, at those bars
    plus, on each term, __expf's documented error of 2 + 1.173 |x| ulp at
    its exponent x = -p / 4. Tensor-core variants: their TF32-emulating plain
    version in f32, at 2 N eps32 of the terms' magnitude sum a pass (f32
    accumulation over N = Nc terms, by the kernel and by the plain version,
    each add within one ulp: the tensor cores truncate) plus what the
    operands may differ by: kernel and plain version compute W with
    different exps and exponent sums, within delta = eps32 (8 + sum_k
    |a_jk g_ik|) of each other, so a (blam o W) element within delta of a
    TF32 rounding boundary may round to the neighbouring TF32 value (one
    TF32 ulp, 2^-10 of it) in red_tf32; red_3xtf32 and tc_p carry delta
    itself (and 2^-20 for the dropped lo.lo, 2^-19 of the exponent's sum for
    tc_p's p). red_3xtf32 and tc_p also against the plain f64 `full` at
    5e-5."""
    _check(variant, g, dv, a, aod, blam)
    if g.dtype == torch.float64:
        want = rw_probe_reference(variant, g, dv, a, aod, blam)
        mag = magnitude(variant, g, dv, a, aod, blam)
        # The smallest normal double keeps the bar of the zero columns
        # (nodots, empty) positive: there the kernel must write 0 exactly.
        return [('plain f64', want, F64_RTOL * want.abs() + 16 * EPS64 * mag
                 + torch.finfo(torch.float64).tiny)]
    f64 = [t.double() for t in (g, dv, a, aod, blam)]

    def fwd(want):
        return want, FWD_TOL['atol'] + FWD_TOL['rtol'] * want.abs()

    if variant not in TENSOR_CORE and variant != 'hwexp':
        return [('plain f64', *fwd(rw_probe_reference(variant, *f64)))]
    full64 = fwd(rw_probe_reference('full', *f64))
    p64 = _exponent(f64[2], f64[0])                      # (B, Nc, Nout)
    w64 = torch.exp(-0.25 * p64)
    bw_abs = f64[4].abs()[None] * w64[:, None]           # |blam o W|, f64
    if variant == 'hwexp':
        ulps = HWEXP_ULP[0] + HWEXP_ULP[1] * 0.25 * p64.abs()
        extra = EPS32 * _magnitude(bw_abs * ulps[:, None], aod, dv)
        return [('plain full f64', full64[0], full64[1] + extra)]
    n_c = a.shape[1]
    passes = 1 if variant == 'red_tf32' else 3
    pmag = _exponent(f64[2].abs(), f64[0].abs())
    delta = EPS32 * (8.0 + pmag)[:, None]                # (B, 1, Nc, Nout)
    mag = _magnitude(bw_abs, aod, dv)
    if variant == 'red_tf32':
        bw = blam[None] * torch.exp(-0.25 * _exponent(a, g))[:, None]
        d32 = delta.float()
        amb = tf32_round(bw * (1 - d32)) != tf32_round(bw * (1 + d32))
        slack = 2.0 ** -10 * _magnitude(bw_abs * amb, aod, dv)
    elif variant == 'red_3xtf32':
        slack = _magnitude(bw_abs * (delta + 2.0 ** -20), aod, dv)
    else:
        slack = _magnitude(bw_abs * (delta + 2.0 ** -19 * pmag[:, None]),
                           aod, dv)
    plain = rw_probe_reference(variant, g, dv, a, aod, blam).double()
    out = [('TF32 plain f32', plain, 2 * passes * n_c * EPS32 * mag + slack)]
    if variant != 'red_tf32':
        out.append(('plain full f64', *full64))
    return out


# ----------------------------------------------------------------- kernel --
def _kernel_fn(dtype=torch.float32):
    """(library, launch of `dtype`'s variants); the variant counts are
    checked against the wrapper's when the library is first loaded."""
    lib = _build.load(_LIB)
    fn = {torch.float32: lib.gpmpc_rw_probe_f32,
          torch.float64: lib.gpmpc_rw_probe_f64}[dtype]
    if lib.gpmpc_probe_error_string.restype is None:
        lib.gpmpc_probe_error_string.argtypes = [ctypes.c_int]
        lib.gpmpc_probe_error_string.restype = ctypes.c_char_p
        for count, names in ((lib.gpmpc_rw_probe_variants, VARIANTS),
                             (lib.gpmpc_rw_probe_variants_f64, F64_VARIANTS)):
            count.restype = ctypes.c_int
            if count() != len(names):
                raise RuntimeError('csrc/variance_trace_probe.cu has '
                                   f'{count()} variants, the wrapper '
                                   f'{len(names)}')
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def rw_probe(variant, g, dv, a, aod, blam):
    """The probe kernel's `variant` on K1's arguments -> rw (B, E, Nout, 1+d),
    launched on the current stream for CUDA tensors; CPU tensors take
    `rw_probe_reference`. Raises on an unknown variant or a shape, dtype or
    device the probe is not built for."""
    global LAUNCHES_PROBE
    _check(variant, g, dv, a, aod, blam)
    if g.device.type == 'cpu':
        return rw_probe_reference(variant, g, dv, a, aod, blam)
    if g.device.type != 'cuda':
        raise ValueError(f'the probe runs on CUDA tensors, got {g.device}')
    b, n_out, d = g.shape
    e, n_c, _ = blam.shape
    vt.rw_tied_plan(b, n_out, n_c, d, e, g.dtype)     # raises past the grid
    rw = torch.empty((b, e, n_out, d + 1), dtype=g.dtype, device=g.device)
    lib, fn = _kernel_fn(g.dtype)
    ids = VARIANTS if g.dtype == torch.float32 else F64_VARIANTS
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ids.index(variant), g.data_ptr(), dv.data_ptr(),
                 a.data_ptr(), aod.data_ptr(), blam.data_ptr(), rw.data_ptr(),
                 b, n_out, n_c, d, e, vt.device_sms(g.device), stream)
    if err != 0:
        msg = lib.gpmpc_probe_error_string(err).decode()
        raise RuntimeError(f'probe {variant} launch failed: cudaError {err} '
                           f'({msg})')
    LAUNCHES_PROBE += 1
    return rw


def exp_table(x):
    """exp(x) by the table-driven double exp of csrc/rw_tied_f64_body.cuh
    (`table_exp`: K1's f64 exp_fast where |x| < 707, exp elsewhere) for an
    f64 CUDA tensor; a CPU tensor takes its plain version, torch.exp."""
    if x.dtype != torch.float64:
        raise TypeError(f'exp_table takes float64, got {x.dtype}')
    if x.device.type == 'cpu':
        return torch.exp(x)
    if x.device.type != 'cuda':
        raise ValueError(f'exp_table runs on CUDA tensors, got {x.device}')
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _build.load(_LIB)
    fn = lib.gpmpc_exp_table_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), x.numel(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'exp_table launch failed: cudaError {err}')
    return y
