"""Analytic uncertain-input moment propagation (port of
gpmpc_tpu/ops/moments.py).

Given a GP posterior and Gaussian inputs x* ~ N(u, S), these ops compute the
exact predictive mean, variance, input-output covariance and cross-output
covariance (Girard / Quinonero-Candela, eqs. 21/31 and A14). Padded training
rows are excluded through the mask; `kinv` is identity and beta zero on the
padded block. Three families:

  - scenario-batched, diagonal S (`*_batched_diag`): the rollout's hot path;
  - scenario-batched, full S (`*_batched`): the full-covariance rollout. Its
    variance goes through the trace kernels with a non-diagonal M2 (K1 tied,
    K2 untied); the cross-output covariance is torch ops, one (B, N, N) exp
    chain for the whole (E, E) block when tied;
  - single-input (`mean_prop`, `variance_prop_multi`, `covariance_prop`,
    ...): plain torch, as the JAX package keeps them XLA-only; the
    per-scenario routes map them over lanes (dynamics.rollout_lanes). Their
    variance trace follows the precision policy of
    ops/kernels/variance_trace.py: it is evaluated in f64 whatever the
    operands' dtype (`_single_trace`), since it cancels as the batched
    traces do (PERF.md, fault F4).

Small (d, d) solves and log-determinants go through the unrolled Cholesky of
utils/smallchol; the non-symmetric R = S Lam* + I of eq. A14 through
torch.linalg.solve_ex and slogdet, which do not wait on the host.
"""

from __future__ import annotations

import math

import torch

from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
from gpmpc_tpu_torch.utils.linalg import sq_dists
from gpmpc_tpu_torch.utils.smallchol import (logdet_psd_small as _logdet_psd,
                                             solve_psd_small as _solve_psd)

_LOG2 = math.log(2.0)


class _TiedHypergradGuard(torch.autograd.Function):
    """Identity on the value; NaN on the cotangent.

    The tied paths share ONE exp chain across the E outputs, so per-output
    lengthscale cotangents are not attributable; this turns silent smearing
    into a loud NaN. The rollout detaches the GP state, so the backward never
    runs there. Under torch.func.vmap it maps to itself on the batched
    tensor (the `vmap` rule), so a lanes rollout may reach it."""

    @staticmethod
    def forward(log_lambdas):
        return log_lambdas.view_as(log_lambdas)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ct):
        return torch.full_like(ct, math.nan)

    @staticmethod
    def vmap(info, in_dims, log_lambdas):
        return _TiedHypergradGuard.apply(log_lambdas), in_dims[0]


def _tied_hypergrad_guard(log_lambdas):
    return _TiedHypergradGuard.apply(log_lambdas)


def make_variance_cache(x, beta, kinv, log_lambdas, log_sigma_f, mask):
    """Input-independent part of the variance contraction for all outputs:
    b_lam = (Ky^{-1} - beta beta^T) o exp(-1/4 d^2_Lambda(x_i, x_j)) sigma_f^4,
    masked. x (N, d); beta (E, N); kinv (E, N, N); log_lambdas (E, d);
    log_sigma_f (E,); mask (N,) -> b_lam (E, N, N)."""
    xs = x[None] * torch.exp(-0.5 * log_lambdas)[:, None, :]   # (E, N, d)
    lam_part = torch.exp(-0.25 * sq_dists(xs, xs))
    m = mask.to(x.dtype)
    b = kinv - beta[:, :, None] * beta[:, None, :]
    return (b * lam_part * torch.exp(4.0 * log_sigma_f)[:, None, None]
            * (m[:, None] * m[None, :]))


def mean_prop_batched_diag(u, s_diag, x, beta, log_lambdas, log_sigma_f, mask,
                           tied: bool = False):
    """Predictive mean for a diagonal input covariance.

    u (B, d); s_diag (B, d); x (N, d); beta (E, N); log_lambdas (E, d);
    log_sigma_f (E,); mask (N,) -> (means (B, E), l (B, E, N)).

    tied=True (all lengthscale rows equal): q and the det correction are
    shared, and l_e differs from the shared l0 only by sigma_f_e^2. Values
    equal tied=False; lengthscale cotangents are NaN (the guard).
    """
    diff = u[:, None, :] - x[None]                              # (B, N, d)
    if tied:
        ll_g = _tied_hypergrad_guard(log_lambdas)
        lam0 = torch.mean(torch.exp(ll_g), dim=0)               # (d,)
        spl0 = s_diag + lam0[None]                              # (B, d)
        q0 = torch.einsum('bnd,bd->bn', diff * diff, 1.0 / spl0)
        log_det0 = -0.5 * (torch.sum(torch.log(spl0), dim=-1)
                           - torch.sum(torch.mean(ll_g, dim=0)))
        l0 = torch.exp(log_det0[:, None] - 0.5 * q0) * mask.to(u.dtype)
        sf2 = torch.exp(2.0 * log_sigma_f)                      # (E,)
        means = torch.einsum('en,bn->be', beta, l0) * sf2[None]
        return means, sf2[None, :, None] * l0[:, None, :]
    spl = s_diag[:, None, :] + torch.exp(log_lambdas)[None]     # (B, E, d)
    q = torch.einsum('bnd,bed->ben', diff * diff, 1.0 / spl)    # (B, E, N)
    log_det_corr = -0.5 * (torch.sum(torch.log(spl), dim=-1)
                           - torch.sum(log_lambdas, dim=-1)[None])
    l = torch.exp(2.0 * log_sigma_f[None, :, None]
                  + log_det_corr[:, :, None] - 0.5 * q) * mask.to(u.dtype)
    return torch.einsum('en,ben->be', beta, l), l


def input_output_cov_batched_diag(u, s_diag, x, beta, l, log_lambdas):
    """cov(x*, f_e) = sum_j beta_ej l_bej S (S + Lambda_e)^{-1} (x_j - u_b).

    u (B, d); s_diag (B, d); x (N, d); beta (E, N); l (B, E, N);
    log_lambdas (E, d) -> (B, E, d)."""
    diff = x[None] - u[:, None, :]                              # (B, N, d)
    w = torch.einsum('en,ben,bnd->bed', beta, l, diff)
    scale = s_diag[:, None, :] / (s_diag[:, None, :]
                                  + torch.exp(log_lambdas)[None])
    return scale * w


def variance_prop_multi_batched_diag(u, s_diag, x, b_lam, log_lambdas,
                                     log_sigma_f, means, tied: bool = False):
    """Predictive variances for a diagonal input covariance: hls = Lambda/2 + S
    is diagonal, so M2 = 1/hls elementwise.

    u (B, d); s_diag (B, d); x (N, d); b_lam (E, N, N); means (B, E)
    -> (B, E). tied=True shares M2 across outputs, so the trace kernel runs
    one exp chain per scenario (K1) instead of one per (scenario, output)
    (K2)."""
    hls = (torch.exp(log_lambdas) / 2.0)[None] + s_diag[:, None, :]  # (B, E, d)
    log_det_part = -0.5 * (torch.sum(torch.log(hls), dim=-1)
                           - torch.sum(log_lambdas - _LOG2, dim=-1)[None])
    if tied:
        lam0g = torch.mean(torch.exp(_tied_hypergrad_guard(log_lambdas)), dim=0)
        m2s = torch.diag_embed(1.0 / ((lam0g / 2.0)[None] + s_diag))  # (B, d, d)
        t = vt.variance_trace_batched_tied(u, m2s, x, b_lam)
    else:
        t = vt.variance_trace_batched(u, torch.diag_embed(1.0 / hls), x, b_lam)
    return (torch.exp(2.0 * log_sigma_f)[None]
            - torch.exp(log_det_part) * t - means ** 2)


# ------------------------------------------ scenario-batched, full S --
def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def mean_prop_batched(u, S, x, beta, log_lambdas, log_sigma_f, mask,
                      tied: bool = False):
    """Predictive mean for a full input covariance.

    u (B, d); S (B, d, d); x (N, d); beta (E, N); log_lambdas (E, d);
    log_sigma_f (E,); mask (N,) -> (means (B, E), l (B, E, N)). tied=True
    shares the (S + Lambda) solve across outputs (values equal tied=False;
    lengthscale cotangents NaN, as mean_prop_batched_diag)."""
    d = u.shape[-1]
    diff = u[:, None, :] - x[None]                              # (B, N, d)
    if tied:
        ll_g = _tied_hypergrad_guard(log_lambdas)
        lam0 = torch.mean(torch.exp(ll_g), dim=0)               # (d,)
        spl = S + torch.diag(lam0)[None]                        # (B, d, d)
        sol = _solve_psd(spl, diff.transpose(1, 2))             # (B, d, N)
        q0 = torch.einsum('bnd,bdn->bn', diff, sol)
        log_det0 = -0.5 * (_logdet_psd(spl) - torch.sum(torch.mean(ll_g, dim=0)))
        l0 = torch.exp(log_det0[:, None] - 0.5 * q0) * mask.to(u.dtype)
        sf2 = torch.exp(2.0 * log_sigma_f)                      # (E,)
        means = torch.einsum('en,bn->be', beta, l0) * sf2[None]
        return means, sf2[None, :, None] * l0[:, None, :]
    e = beta.shape[0]
    spl = (S[:, None] + (torch.exp(log_lambdas)[..., None]
                         * _eye(d, u))[None])                   # (B, E, d, d)
    rhs = diff.transpose(1, 2)[:, None].expand(-1, e, -1, -1)   # (B, E, d, N)
    q = torch.einsum('bnd,bedn->ben', diff, _solve_psd(spl, rhs))
    log_det = -0.5 * (_logdet_psd(spl)
                      - torch.sum(log_lambdas, dim=-1)[None])   # (B, E)
    l = torch.exp(2.0 * log_sigma_f[None, :, None] + log_det[..., None]
                  - 0.5 * q) * mask.to(u.dtype)
    return torch.einsum('en,ben->be', beta, l), l


def input_output_cov_batched(u, S, x, beta, l, log_lambdas):
    """cov(x*, f_e) = S (S + Lambda_e)^{-1} sum_j beta_ej l_bej (x_j - u_b).

    u (B, d); S (B, d, d); x (N, d); beta (E, N); l (B, E, N)
    -> (B, E, d)."""
    d = u.shape[-1]
    diff = x[None] - u[:, None, :]                              # (B, N, d)
    w = torch.einsum('en,ben,bnd->bed', beta, l, diff)          # (B, E, d)
    spl = (S[:, None] + (torch.exp(log_lambdas)[..., None]
                         * _eye(d, u))[None])                   # (B, E, d, d)
    return torch.einsum('bdk,bek->bed', S, _solve_psd(spl, w))


def variance_prop_multi_batched(u, S, x, b_lam, log_lambdas, log_sigma_f,
                                means, tied: bool = False):
    """Predictive variances for a full input covariance: M2 = (Lambda/2 +
    S)^{-1}, a non-diagonal (B, d, d) (tied, K1) or (B, E, d, d) (K2).

    u (B, d); S (B, d, d); x (N, d); b_lam (E, N, N); log_lambdas (E, d);
    log_sigma_f (E,); means (B, E) -> (B, E)."""
    d = x.shape[1]
    eye = _eye(d, u)
    ll_part = torch.sum(log_lambdas - _LOG2, dim=-1)[None]     # (1, E)
    if tied:
        lam0g = torch.mean(torch.exp(_tied_hypergrad_guard(log_lambdas)), dim=0)
        hls0 = torch.diag(lam0g / 2.0)[None] + S                # (B, d, d)
        log_det_part = -0.5 * (_logdet_psd(hls0)[:, None] - ll_part)
        m2 = _solve_psd(hls0, eye.expand(hls0.shape))           # (B, d, d)
        t = vt.variance_trace_batched_tied(u, m2, x, b_lam)
    else:
        hls = ((torch.exp(log_lambdas) / 2.0)[None, :, :, None] * eye
               + S[:, None])                                    # (B, E, d, d)
        log_det_part = -0.5 * (_logdet_psd(hls) - ll_part)
        m2 = _solve_psd(hls, eye.expand(hls.shape))
        t = vt.variance_trace_batched(u, m2, x, b_lam)
    return (torch.exp(2.0 * log_sigma_f)[None]
            - torch.exp(log_det_part) * t - means ** 2)


def _a14_factor(S, lam_inv_sum):
    """A = (S Lam* + I)^{-1} S (symmetric) and det(S Lam* + I)^{-1/2} for
    Lam* = diag(lam_inv_sum); S (B, d, d), lam_inv_sum (d,)."""
    r = S * lam_inv_sum[None, None, :] + _eye(S.shape[-1], S)
    a_mat = torch.linalg.solve_ex(r, S)[0]
    return a_mat, torch.exp(-0.5 * torch.linalg.slogdet(r)[1])


def covariance_prop_multi_batched(u, S, x, beta, log_lambdas, log_sigma_f,
                                  means, mask, tied: bool = False):
    """All-pairs cross-output covariance (eq. A14): u (B, d); S (B, d, d);
    x (N, d); beta (E, N); means (B, E) -> (B, E, E), entry [e1, e2] =
    cov(f_e1(x*), f_e2(x*)). Its diagonal is beta^T Qt beta - m^2, not the
    exact predictive variance: callers overwrite it (variance_prop).

    tied=True: Qt differs across pairs only by the sigma_f^2 scalars, so one
    (B, N, N) exp chain serves the whole (E, E) block as
    Bd exp(P) Bd^T. Untied: one (B, N, N) chain per pair. No kernel: this is
    O(B N^2) memory, 67 MB at B = N = 256 in f32."""
    m = mask.to(u.dtype)
    diff = x[None] - u[:, None, :]                              # (B, N, d)
    if tied:
        lam_inv = torch.exp(-torch.mean(_tied_hypergrad_guard(log_lambdas),
                                        dim=0))                 # (d,)
        z = diff * lam_inv                                      # (B, N, d)
        a_mat, det_part = _a14_factor(S, 2.0 * lam_inv)
        za = torch.einsum('bnd,bdk->bnk', z, a_mat)             # (B, N, d)
        q = torch.sum(za * z, dim=-1)                           # (B, N)
        p = torch.einsum('bnk,bmk->bnm', za, z)                 # (B, N, N)
        # k_i = exp(-1/2 d_i^2), folded with e^{q_i/2} into one weight.
        d2 = torch.sum(diff * diff * lam_inv[None, None, :], dim=-1)
        dv = torch.exp(0.5 * (q - d2)) * m[None]                # (B, N)
        sf2 = torch.exp(2.0 * log_sigma_f)                      # (E,)
        bd = beta[None] * dv[:, None, :]                        # (B, E, N)
        quad = torch.einsum('ben,bnm,bfm->bef', bd, torch.exp(p), bd)
        c = det_part[:, None, None] * quad * (sf2[:, None] * sf2[None])[None]
        return c - means[:, :, None] * means[:, None, :]
    lam_inv = torch.exp(-log_lambdas)                           # (E, d)

    def pair(e1, e2):
        li1, li2 = lam_inv[e1], lam_inv[e2]
        z1, z2 = diff * li1, diff * li2                         # (B, N, d)
        a_mat, det_part = _a14_factor(S, li1 + li2)
        z1a = torch.einsum('bnd,bdk->bnk', z1, a_mat)
        q1 = torch.sum(z1a * z1, dim=-1)                        # (B, N)
        q2 = torch.sum(torch.einsum('bnd,bdk->bnk', z2, a_mat) * z2, dim=-1)
        cross = torch.einsum('bnk,bmk->bnm', z1a, z2)           # (B, N, N)
        k1 = torch.exp(2.0 * log_sigma_f[e1]
                       - 0.5 * torch.sum(diff * diff * li1, dim=-1))
        k2 = torch.exp(2.0 * log_sigma_f[e2]
                       - 0.5 * torch.sum(diff * diff * li2, dim=-1))
        w1 = beta[e1][None] * k1 * torch.exp(0.5 * q1) * m[None]
        w2 = beta[e2][None] * k2 * torch.exp(0.5 * q2) * m[None]
        quad = torch.einsum('bn,bnm,bm->b', w1, torch.exp(cross), w2)
        return det_part * quad - means[:, e1] * means[:, e2]

    e = beta.shape[0]
    return torch.stack([torch.stack([pair(i, j) for j in range(e)], dim=-1)
                        for i in range(e)], dim=-2)             # (B, E, E)


# ------------------------------------------------------- single input --
# Shapes (one output): u (d,), S (d, d), x (N, d), beta (N,), kinv (N, N),
# log_lambdas (d,), log_sigma_f (), mask (N,). Each op runs under
# torch.func.vmap too (dynamics.rollout_lanes), where each lane's value is
# the unmapped one's.
def _pair_dot(a, b):
    """sum(a * b) over the last axis, in pairs: adjacent products first,
    then the pair sums (a zero pads an odd length). Written as the same ops
    for one input and under vmap; the tests check a lane's mean against
    the unmapped one to the bit on the CPU only for compat's nominal
    models, and elsewhere (the card included) at rtol 1e-12. On the CPU
    tests' problems it reads nearer JAX's f64 dot than a flat sum, which
    keeps two JAX-parity tests inside their bars (PERF.md §7)."""
    p = a * b
    if p.shape[-1] % 2:
        p = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
    return p.reshape(*p.shape[:-1], -1, 2).sum(-1).sum(-1)


def mean_prop(u, S, x, beta, log_lambdas, log_sigma_f, mask):
    """Predictive mean under a Gaussian input (eqs. 21/31):
    m = beta . l, l_j = sigma_f^2 det(Lambda^{-1} S + I)^{-1/2}
    exp(-1/2 (u - x_j)^T (S + Lambda)^{-1} (u - x_j)). Returns (m, l)."""
    spl = S + torch.diag(torch.exp(log_lambdas))
    diff = u[None, :] - x                                       # (N, d)
    q = torch.sum(diff.T * _solve_psd(spl, diff.T), dim=0)      # (N,)
    log_det_corr = -0.5 * (_logdet_psd(spl) - torch.sum(log_lambdas))
    l = torch.exp(2.0 * log_sigma_f + log_det_corr - 0.5 * q) * mask.to(q.dtype)
    return _pair_dot(beta, l), l


def input_output_cov(u, S, x, beta, l, log_lambdas):
    """cov(x*, f) = sum_j beta_j l_j S (S + Lambda)^{-1} (x_j - u), (d,);
    l from mean_prop."""
    spl = S + torch.diag(torch.exp(log_lambdas))
    w = torch.sum(beta[:, None] * l[:, None] * (x - u[None, :]), dim=0)
    return S @ _solve_psd(spl, w)


def _single_trace(chain, u, S, x, b_lam, log_lambdas):
    """The precision policy for one input: chain(u, S, x, b_lam,
    log_lambdas) -> (t, log_det_part) evaluated in vt.TRACE_DTYPE whatever
    the operands' dtype, both rounded back to it (the trace t cancels: on
    the headline GP its terms sum to 1e3-1e6 times the variance). u, S, x
    and log_lambdas are upcast, so hls, its solve and log-determinant, P, d
    and the contraction run in f64; b_lam enters as stored, and its product
    with the f64 exponent promotes it exactly, so no f64 copy of the
    (..., N, N) cache is made or kept for the backward. The cotangents of u
    and S come back through the casts, computed in f64 and rounded. f64
    operands pass untouched: to() returns them, so the ops are the chain's
    own, bit for bit."""
    dt = u.dtype
    t, log_det_part = chain(*(v.to(vt.TRACE_DTYPE) for v in (u, S, x)),
                            b_lam, log_lambdas.to(vt.TRACE_DTYPE))
    return t.to(dt), log_det_part.to(dt)


def _trace_one(u, S, x, b_lam, log_lambdas):
    """variance_prop_cached's chain: (t, log_det_part) of one output."""
    hls = torch.diag(torch.exp(log_lambdas) / 2.0) + S
    diff = u[None, :] - x                                       # (N, d)
    g = _solve_psd(hls, diff.T).T                               # (N, d)
    p = diff @ g.T                                              # (N, N)
    d_vec = torch.exp(-0.125 * torch.sum(g * diff, dim=1))
    t = d_vec @ (b_lam * torch.exp(-0.25 * p)) @ d_vec
    return t, -0.5 * (_logdet_psd(hls) - torch.sum(log_lambdas - _LOG2))


def variance_prop_cached(u, S, x, b_lam, log_lambdas, log_sigma_f, mean):
    """Predictive variance under a Gaussian input from one output's (N, N)
    b_lam (make_variance_cache): sigma_f^2 - det_part d^T (b_lam o
    exp(-P/4)) d - m^2, with P = diff (Lambda/2 + S)^{-1} diff^T and
    d_i = exp(-P_ii / 8); the trace in f64 (`_single_trace`)."""
    t, log_det_part = _single_trace(_trace_one, u, S, x, b_lam, log_lambdas)
    return (torch.exp(2.0 * log_sigma_f) - torch.exp(log_det_part) * t
            - mean ** 2)


def variance_prop(u, S, x, beta, kinv, log_lambdas, log_sigma_f, mask, mean):
    """Standalone variance of one output (builds its b_lam inline)."""
    b_lam = make_variance_cache(x, beta[None], kinv[None], log_lambdas[None],
                                log_sigma_f[None], mask)[0]
    return variance_prop_cached(u, S, x, b_lam, log_lambdas, log_sigma_f, mean)


def _trace_multi(u, S, x, b_lam, log_lambdas):
    """variance_prop_multi's chain: (t, log_det_part) of all E outputs."""
    d = x.shape[1]
    hls = (torch.exp(log_lambdas) / 2.0)[:, :, None] * _eye(d, u) + S[None]
    log_det_part = -0.5 * (_logdet_psd(hls)
                           - torch.sum(log_lambdas - _LOG2, dim=-1))
    diff = u[None, :] - x                                       # (N, d)
    g = _solve_psd(hls, diff.T.expand(hls.shape[0], -1, -1)).transpose(1, 2)
    p = torch.einsum('nd,emd->enm', diff, g)                    # (E, N, N)
    d_vec = torch.exp(-0.125 * torch.sum(g * diff[None], dim=-1))  # (E, N)
    t = torch.einsum('en,enm,em->e', d_vec, b_lam * torch.exp(-0.25 * p), d_vec)
    return t, log_det_part


def variance_prop_multi(u, S, x, b_lam, log_lambdas, log_sigma_f, means):
    """All outputs' variances for one input: u (d,); S (d, d); x (N, d);
    b_lam (E, N, N); log_lambdas (E, d); log_sigma_f (E,); means (E,)
    -> (E,); the traces in f64 (`_single_trace`)."""
    t, log_det_part = _single_trace(_trace_multi, u, S, x, b_lam, log_lambdas)
    return (torch.exp(2.0 * log_sigma_f) - torch.exp(log_det_part) * t
            - means ** 2)


def covariance_prop(u, S, x, beta1, beta2, log_lambdas1, log_lambdas2,
                    log_sigma_f1, log_sigma_f2, mask, mean1, mean2):
    """Cross-covariance of two outputs under one Gaussian input (eq. A14):
    beta1^T Qt beta2 - m1 m2, with Qt_ij = k1(x_i, u) k2(x_j, u)
    det(S Lam* + I)^{-1/2} exp(1/2 (z1_i + z2_j)^T A (z1_i + z2_j)),
    Lam* = Lambda1^{-1} + Lambda2^{-1}, z_k = Lambda_k^{-1} (x - u) and
    A = (S Lam* + I)^{-1} S."""
    lam1_inv, lam2_inv = torch.exp(-log_lambdas1), torch.exp(-log_lambdas2)
    diff = x - u[None, :]                                       # (N, d)
    z1, z2 = diff * lam1_inv, diff * lam2_inv
    a, det_part = _a14_factor(S[None], lam1_inv + lam2_inv)
    a, det_part = a[0], det_part[0]
    q1 = torch.sum((z1 @ a) * z1, dim=1)                        # (N,)
    q2 = torch.sum((z2 @ a) * z2, dim=1)
    cross = z1 @ a @ z2.T                                       # (N, N)
    exp_part = torch.exp(0.5 * (q1[:, None] + 2.0 * cross + q2[None, :]))
    k1 = torch.exp(2.0 * log_sigma_f1
                   - 0.5 * torch.sum(diff * diff * lam1_inv, dim=1))
    k2 = torch.exp(2.0 * log_sigma_f2
                   - 0.5 * torch.sum(diff * diff * lam2_inv, dim=1))
    m = mask.to(u.dtype)
    qt = det_part * (k1 * m)[:, None] * (k2 * m)[None, :] * exp_part
    return beta1 @ qt @ beta2 - mean1 * mean2
