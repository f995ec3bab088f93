"""The uncertain-input variance trace and its CUDA kernel (K1).

Port of gpmpc_tpu/ops/pallas/variance_trace.py. The per-rollout-step hot tile
is, for each scenario b with a = u_b - x (N, d), g = a M2_b, q_i = g_i . a_i and
dv = exp(-q / 8),

    t[b, e] = sum_ij blam_e[i, j] dv_i dv_j exp(-1/4 g_i . a_j).

The kernel's only job is the O(N^2) chain reduced against the augmented matrix
AO = [1 | a] (the "rw" contract):

    rw[b, e, i, c] = dv_i sum_j blam[e, j, i] exp(-1/4 a_j . g_i) (dv o AO)[j, c]

so t = sum_i rw[..., 0], and the backward needs only rw and O(N d) tensor
work (derived for SYMMETRIC blam and M2, always true here):

    z0 = A^T r,  zs = A^T (W A + diag(r) A),  dt/du = -M2 z0,  dt/dM2 = -1/4 zs.

`rw_tied` launches the hand-written CUDA kernel
(csrc/variance_trace_tied.cu) for CUDA tensors and takes the plain PyTorch
version `rw_tied_reference` only for CPU tensors; there is no fallback from
one to the other. The untied form (K2) is the same kernel launched once per
output at E = 1, as the JAX package dispatches it.
"""

from __future__ import annotations

import ctypes

import torch

from gpmpc_tpu_torch.ops.kernels import _build

# Kernel launches, counted where they happen (tied K1 and untied K2), so a
# run can show that it went through the kernel.
LAUNCHES = 0
LAUNCHES_UNTIED = 0

MAX_D = 8
MAX_E = 8
_MAX_B = 65535          # grid.y of the launch
_LIB = 'variance_trace_tied'
_FN = {torch.float32: 'gpmpc_rw_tied_f32', torch.float64: 'gpmpc_rw_tied_f64'}


def _kernel_fn(dtype):
    lib = _build.load(_LIB)
    fn = getattr(lib, _FN[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gpmpc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gpmpc_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def rw_tied_reference(g_out, dv_out, a, aod, blam):
    """Plain PyTorch version of the kernel: materialises the (B, Nc, Nout)
    exp chain. g_out (B, Nout, d); dv_out (B, Nout); a (B, Nc, d);
    aod (B, Nc, 1+d); blam (E, Nc, Nout) -> rw (B, E, Nout, 1+d)."""
    w = torch.exp(-0.25 * torch.einsum('bjk,bik->bji', a, g_out))
    rw = torch.einsum('eji,bji,bjc->beic', blam, w, aod)
    return dv_out[:, None, :, None] * rw


def _check(g_out, dv_out, a, aod, blam):
    b, n_out, d = g_out.shape
    e, n_c = blam.shape[:2]
    want = {'dv_out': (b, n_out), 'a': (b, n_c, d), 'aod': (b, n_c, d + 1),
            'blam': (e, n_c, n_out)}
    got = {'dv_out': dv_out.shape, 'a': a.shape, 'aod': aod.shape,
           'blam': blam.shape}
    for k, shape in want.items():
        if tuple(got[k]) != shape:
            raise ValueError(f'rw kernel: {k} has shape {tuple(got[k])}, '
                             f'expected {shape}')
    if not (1 <= d <= MAX_D and 1 <= e <= MAX_E and b <= _MAX_B):
        raise ValueError(f'rw kernel supports d <= {MAX_D}, E <= {MAX_E} and '
                         f'B <= {_MAX_B}; got d={d}, E={e}, B={b}')
    ts = (g_out, dv_out, a, aod, blam)
    if g_out.dtype not in _FN or any(t.dtype != g_out.dtype for t in ts):
        raise TypeError('rw kernel takes float32 or float64 tensors of one '
                        f'dtype; got {[t.dtype for t in ts]}')
    if any(t.device != g_out.device for t in ts):
        raise ValueError('rw kernel: tensors lie on different devices')
    if any(not t.is_contiguous() for t in ts):
        raise ValueError('rw kernel takes contiguous tensors')


def _launch(g_out, dv_out, a, aod, blam):
    """Launch the CUDA kernel on the current stream; returns (rw, launched)."""
    _check(g_out, dv_out, a, aod, blam)
    if g_out.device.type != 'cuda':
        raise ValueError(f'rw kernel runs on CUDA tensors, got {g_out.device}')
    b, n_out, d = g_out.shape
    e, n_c, _ = blam.shape
    rw = torch.empty((b, e, n_out, d + 1), dtype=g_out.dtype,
                     device=g_out.device)
    if rw.numel() == 0:
        return rw, False
    lib, fn = _kernel_fn(g_out.dtype)
    with torch.cuda.device(g_out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g_out.data_ptr(), dv_out.data_ptr(), a.data_ptr(),
                 aod.data_ptr(), blam.data_ptr(), rw.data_ptr(),
                 b, n_out, n_c, d, e, stream)
    if err != 0:
        msg = lib.gpmpc_cuda_error_string(err).decode()
        raise RuntimeError(f'rw kernel launch failed: cudaError {err} ({msg})')
    return rw, True


def rw_tied(g_out, dv_out, a, aod, blam):
    """K1: rw (B, E, Nout, 1+d) with one exp chain shared by all E outputs.
    CUDA tensors launch the kernel; CPU tensors take `rw_tied_reference`."""
    global LAUNCHES
    if g_out.device.type == 'cpu':
        return rw_tied_reference(g_out, dv_out, a, aod, blam)
    rw, launched = _launch(g_out, dv_out, a, aod, blam)
    LAUNCHES += launched
    return rw


def rw_untied_reference(g, dv, a, ao, blam):
    """Plain version of K2: g (B, E, N, d); dv (B, E, N); a (B, N, d);
    ao (B, N, 1+d); blam (E, N, N) -> rw (B, E, N, 1+d)."""
    return torch.cat([rw_tied_reference(g[:, k], dv[:, k], a,
                                        ao * dv[:, k, :, None], blam[k:k + 1])
                      for k in range(blam.shape[0])], dim=1)


def rw_untied(g, dv, a, ao, blam):
    """K2: one exp chain per output (untied M2_e), as K1 launched once per
    output at E = 1. CPU tensors take `rw_untied_reference`."""
    global LAUNCHES_UNTIED
    if g.device.type == 'cpu':
        return rw_untied_reference(g, dv, a, ao, blam)
    outs = []
    for k in range(blam.shape[0]):
        rw, launched = _launch(g[:, k].contiguous(), dv[:, k].contiguous(), a,
                               (ao * dv[:, k, :, None]).contiguous(),
                               blam[k:k + 1])
        LAUNCHES_UNTIED += launched
        outs.append(rw)
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------- public entry --
def _aug(a):
    """AO = [1 | A]: the augmented reduction matrix (a: (B, N, d))."""
    return torch.cat([torch.ones_like(a[..., :1]), a], dim=-1)


def _prep_tied(u, m2, x):
    a = u[:, None, :] - x[None]                        # (B, N, d)
    g = torch.einsum('bnd,bdk->bnk', a, m2)            # (B, N, d)
    q = torch.sum(g * a, dim=-1)                       # (B, N)
    return a, g, torch.exp(-0.125 * q)


def _prep_batched(u, m2, x):
    a = u[:, None, :] - x[None]                        # (B, N, d)
    g = torch.einsum('bnd,bedk->benk', a, m2)          # (B, E, N, d)
    q = torch.sum(g * a[:, None], dim=-1)              # (B, E, N)
    return a, g, torch.exp(-0.125 * q)


class _VarianceTraceTied(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, m2, x, blam):
        a, g, dv = _prep_tied(u, m2, x)
        rw = rw_tied(g.contiguous(), dv.contiguous(), a.contiguous(),
                     (_aug(a) * dv[..., None]).contiguous(), blam.contiguous())
        ctx.save_for_backward(u, m2, x, rw)
        return rw[..., 0].sum(dim=-1)

    @staticmethod
    def backward(ctx, ct):
        u, m2, x, rw = ctx.saved_tensors
        a = u[:, None, :] - x[None]                    # (B, N, d)
        r = rw[..., 0]                                 # (B, E, N)
        wa = rw[..., 1:]                               # (B, E, N, d)
        # The untied cotangents summed over e, because m2 is shared.
        z0c = torch.einsum('bnd,ben,be->bd', a, r, ct)
        du = -torch.einsum('bdk,bk->bd', m2, z0c)
        warc = torch.einsum('be,benk->bnk', ct, wa + a[:, None] * r[..., None])
        dm2 = -0.25 * torch.einsum('bnd,bnk->bdk', a, warc)
        return du, dm2, None, None


class _VarianceTraceUntied(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, m2, x, blam):
        a, g, dv = _prep_batched(u, m2, x)
        rw = rw_untied(g, dv, a.contiguous(), _aug(a), blam.contiguous())
        ctx.save_for_backward(u, m2, x, rw)
        return rw[..., 0].sum(dim=-1)

    @staticmethod
    def backward(ctx, ct):
        u, m2, x, rw = ctx.saved_tensors
        a = u[:, None, :] - x[None]                    # (B, N, d)
        r = rw[..., 0]                                 # (B, E, N)
        wa = rw[..., 1:]                               # (B, E, N, d)
        z0 = torch.einsum('bnd,ben->bed', a, r)
        du = -torch.einsum('be,bedk,bek->bd', ct, m2, z0)
        war = wa + a[:, None] * r[..., None]           # W A + diag(r) A
        dm2 = -0.25 * torch.einsum('bnd,benk->bedk', a,
                                   ct[..., None, None] * war)
        return du, dm2, None, None


def variance_trace_batched_tied(u, m2, x, blam):
    """Tied-lengthscale batched trace: u (B, d); m2 (B, d, d) shared across
    outputs; x (N, d); blam (E, N, N) -> (B, E). Analytic gradients in
    (u, m2); x and blam are constants (the rollout cache is detached)."""
    return _VarianceTraceTied.apply(u, m2, x, blam)


def variance_trace_batched(u, m2, x, blam):
    """Untied batched trace: u (B, d); m2 (B, E, d, d); x (N, d);
    blam (E, N, N) -> (B, E). Gradients as variance_trace_batched_tied."""
    return _VarianceTraceUntied.apply(u, m2, x, blam)


def variance_trace_batched_reference(u, m2, x, blam):
    """Plain PyTorch twin of variance_trace_batched, differentiated by autograd
    (the test oracle)."""
    a = u[:, None, :] - x[None]                        # (B, N, d)
    g = torch.einsum('bnd,bedk->benk', a, m2)          # (B, E, N, d)
    p = torch.einsum('bend,bmd->benm', g, a)           # (B, E, N, N)
    q = torch.sum(g * a[:, None], dim=-1)              # (B, E, N)
    dvec = torch.exp(-0.125 * q)
    w = blam[None] * torch.exp(-0.25 * p)
    return torch.einsum('ben,benm,bem->be', dvec, w, dvec)


def variance_trace_batched_tied_reference(u, m2, x, blam):
    """Plain PyTorch twin of variance_trace_batched_tied (the test oracle)."""
    e = blam.shape[0]
    m2b = m2[:, None].expand(m2.shape[0], e, *m2.shape[1:])
    return variance_trace_batched_reference(u, m2b, x, blam)
