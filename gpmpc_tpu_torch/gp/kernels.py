"""ARD squared-exponential kernel assembly (port of gpmpc_tpu/gp/kernels.py).

k(x1, x2) = sigma_f^2 exp(-1/2 (x1 - x2)^T Lambda^{-1} (x1 - x2)), with the
hyperparameters stored in log space (lambdas = exp(log_lambdas)).
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch.utils.linalg import sq_dists


def se_kernel(x1, x2, log_lambdas, log_sigma_f):
    """Kernel value between two single points (D,)."""
    d = x1 - x2
    return (torch.exp(2.0 * log_sigma_f)
            * torch.exp(-0.5 * torch.sum(d * d * torch.exp(-log_lambdas))))


def se_gram(x1, x2, log_lambdas, log_sigma_f):
    """Gram matrix K(x1, x2): (N, M) for x1 (N, D), x2 (M, D). Scaling each
    input by Lambda^{-1/2} makes the Mahalanobis distance Euclidean."""
    inv_sqrt_lam = torch.exp(-0.5 * log_lambdas)
    return (torch.exp(2.0 * log_sigma_f)
            * torch.exp(-0.5 * sq_dists(x1 * inv_sqrt_lam, x2 * inv_sqrt_lam)))


def se_gram_batched(x1, x2, log_lambdas, log_sigma_f):
    """Gram matrices for E outputs sharing the inputs: x1 (N, D), x2 (M, D),
    log_lambdas (E, D), log_sigma_f (E,) -> (E, N, M)."""
    inv_sqrt_lam = torch.exp(-0.5 * log_lambdas)[:, None, :]     # (E, 1, D)
    d2 = sq_dists(x1[None] * inv_sqrt_lam, x2[None] * inv_sqrt_lam)
    return torch.exp(2.0 * log_sigma_f)[:, None, None] * torch.exp(-0.5 * d2)
