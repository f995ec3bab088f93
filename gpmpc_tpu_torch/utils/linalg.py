"""Masked / padded linear-algebra helpers (port of gpmpc_tpu/utils/linalg.py).

The growing GP training set is a fixed-capacity padded buffer with a validity
mask. A masked Gram matrix gets an identity block on the padded diagonal, so
Cholesky factors and solves stay well-posed and padded rows contribute nothing
to posteriors or log-determinants.
"""

from __future__ import annotations

import torch


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances between rows of `a` (..., N, D) and
    `b` (..., M, D): ||a||^2 + ||b||^2 - 2 a b^T, clamped at 0."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)                  # (..., N, 1)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).transpose(-1, -2)  # (..., 1, M)
    cross = a @ b.transpose(-1, -2)
    return torch.clamp(a2 + b2 - 2.0 * cross, min=0.0)


def masked_psd_add(k: torch.Tensor, mask: torch.Tensor, diag_add) -> torch.Tensor:
    """Masked Ky assembly: zero padded rows/cols of K (..., N, N), add
    `diag_add` (scalar or (...,)) to the valid diagonal and 1.0 to the padded
    diagonal."""
    m = mask.to(k.dtype)
    km = k * (m[:, None] * m[None, :])
    diag_add = torch.as_tensor(diag_add, dtype=k.dtype, device=k.device)
    diag = torch.where(mask, diag_add[..., None], torch.zeros((), dtype=k.dtype,
                                                               device=k.device))
    diag = diag + (1.0 - m)
    return km + torch.diag_embed(diag)


def chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor of A. b: (N,) or (N, M)."""
    vector = b.ndim == chol.ndim - 1
    x = torch.cholesky_solve(b[..., None] if vector else b, chol, upper=False)
    return x[..., 0] if vector else x


def chol_inverse(chol: torch.Tensor) -> torch.Tensor:
    """Explicit inverse from a Cholesky factor."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return chol_solve(chol, eye.expand_as(chol))


def chol_logdet(chol: torch.Tensor) -> torch.Tensor:
    """log det(A) from its Cholesky factor; padded rows carry 1.0 on the factor
    diagonal and contribute 0."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                           dim=-1)
