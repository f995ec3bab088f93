"""Analytic uncertain-input moment propagation, scenario-batched diagonal path
(port of the batched diagonal ops of gpmpc_tpu/ops/moments.py).

Given a GP posterior and Gaussian inputs x* ~ N(u_b, diag(s_b)), these ops
compute the exact predictive mean, variance and input-output covariance
(Girard / Quinonero-Candela). Padded training rows are excluded through the
mask; `kinv` is identity and beta zero on the padded block.
"""

from __future__ import annotations

import math

import torch

from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
from gpmpc_tpu_torch.utils.linalg import sq_dists


class _TiedHypergradGuard(torch.autograd.Function):
    """Identity on the value; NaN on the cotangent.

    The tied paths share ONE exp chain across the E outputs, so per-output
    lengthscale cotangents are not attributable; this turns silent smearing
    into a loud NaN. The rollout detaches the GP state, so the backward never
    runs there."""

    @staticmethod
    def forward(ctx, log_lambdas):
        return log_lambdas.view_as(log_lambdas)

    @staticmethod
    def backward(ctx, ct):
        return torch.full_like(ct, math.nan)


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
                           - torch.sum(log_lambdas - math.log(2.0),
                                       dim=-1)[None])         # (B, E)
    if tied:
        lam0g = torch.mean(torch.exp(_tied_hypergrad_guard(log_lambdas)), dim=0)
        m2s = torch.diag_embed(1.0 / ((lam0g / 2.0)[None] + s_diag))  # (B, d, d)
        t = vt.variance_trace_batched_tied(u, m2s, x, b_lam)
    else:
        t = vt.variance_trace_batched(u, torch.diag_embed(1.0 / hls), x, b_lam)
    return (torch.exp(2.0 * log_sigma_f)[None]
            - torch.exp(log_det_part) * t - means ** 2)
