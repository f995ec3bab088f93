"""Exact GP posterior prediction and marginal likelihood
(port of gpmpc_tpu/gp/exact.py; Rasmussen & Williams eqs. 2.23-2.24)."""

from __future__ import annotations

import math

import torch

from gpmpc_tpu_torch.gp.kernels import se_gram_batched
from gpmpc_tpu_torch.gp.state import GPState, residuals


def predict(state: GPState, x_pred: torch.Tensor, full_cov: bool = False,
            include_noise: bool = False):
    """Posterior mean and covariance at test points x_pred (P, x_dim) or
    (x_dim,). Returns mean (P, E) and cov (E, P, P) if full_cov else (P, E)
    marginal variances. include_noise adds sigma_n^2 (predicting targets).
    A nominal mean model (GPConfig.nominal_fn) adds f_nom(x_pred) to the
    mean."""
    single = x_pred.ndim == 1
    xp = torch.atleast_2d(x_pred).to(state.x.dtype)
    mvalid = state.mask.to(xp.dtype)

    k_star = se_gram_batched(xp, state.x, state.log_lambdas, state.log_sigma_f)
    k_star = k_star * mvalid[None, None, :]                # (E, P, cap)
    mean = torch.einsum('epn,en->pe', k_star, state.beta)
    if state.config.nominal_fn is not None:
        mean = mean + state.config.nominal_fn(xp)
    sol = torch.einsum('enm,epm->enp', state.kinv, k_star)  # (E, cap, P)
    if full_cov:
        k_pp = se_gram_batched(xp, xp, state.log_lambdas, state.log_sigma_f)
        cov = k_pp - torch.einsum('epn,enq->epq', k_star, sol)
        if include_noise:
            eye = torch.eye(xp.shape[0], dtype=xp.dtype, device=xp.device)
            cov = cov + torch.exp(2.0 * state.log_sigma_n)[:, None, None] * eye
    else:
        var = (torch.exp(2.0 * state.log_sigma_f)[:, None]
               - torch.einsum('epn,enp->ep', k_star, sol))
        if include_noise:
            var = var + torch.exp(2.0 * state.log_sigma_n)[:, None]
        cov = var.T                                          # (P, E)
    if single:
        mean = mean[0]
        cov = cov[:, 0, 0] if full_cov else cov[0]
    return mean, cov


def log_marginal_likelihood(state: GPState) -> torch.Tensor:
    """Per-output log marginal likelihood (E,) on the valid block."""
    resid = residuals(state)
    quad = torch.sum(resid * state.beta, dim=-1)
    n = state.count.to(resid.dtype)
    return -0.5 * quad - 0.5 * state.logdet - 0.5 * n * math.log(2.0 * math.pi)
