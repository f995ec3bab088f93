"""Unrolled small-matrix Cholesky and triangular solves
(port of gpmpc_tpu/utils/smallchol.py).

The risk-sensitive cost factorizes many tiny (d, d) SPD matrices
(d = state_dim, typically 2-6) batched over lanes and horizon steps. Unrolled
over the static d, the factorization is ~d^3/6 elementwise ops over the
batch. A non-PD input yields a NaN diagonal (sqrt of a negative pivot),
exactly as in the JAX package: the cost's PD-cone test reads it.

All functions take (..., d, d) / (..., d, m) tensors with arbitrary leading
batch dims; the Python loops run over d only.
"""

from __future__ import annotations

import torch

MAX_UNROLL_DIM = 8


def _check_dim(d: int) -> None:
    if d > MAX_UNROLL_DIM:
        raise ValueError(f'unrolled small-matrix routines take d <= '
                         f'{MAX_UNROLL_DIM}, got d={d}')


def chol_small(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., d, d) SPD matrices, unrolled over d."""
    d = a.shape[-1]
    _check_dim(d)
    col = [[None] * d for _ in range(d)]     # col[i][j] = L[..., i, j], j <= i
    for j in range(d):
        s = a[..., j, j]
        for k in range(j):
            s = s - col[j][k] * col[j][k]
        ljj = torch.sqrt(s)
        col[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, d):
            s = a[..., i, j]
            for k in range(j):
                s = s - col[i][k] * col[j][k]
            col[i][j] = s * inv
    zero = torch.zeros_like(a[..., 0, 0])
    rows = [torch.stack([col[i][j] if j <= i else zero for j in range(d)],
                        dim=-1) for i in range(d)]
    return torch.stack(rows, dim=-2)


def solve_lower_small(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b by unrolled forward substitution. b: (..., d, m)."""
    d = l.shape[-1]
    _check_dim(d)
    xs = []
    for i in range(d):
        s = b[..., i, :]
        for k in range(i):
            s = s - l[..., i, k][..., None] * xs[k]
        xs.append(s / l[..., i, i][..., None])
    return torch.stack(xs, dim=-2)


def solve_upper_small(lt_as_l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b (given the LOWER factor) by unrolled back substitution."""
    d = lt_as_l.shape[-1]
    _check_dim(d)
    xs = [None] * d
    for i in reversed(range(d)):
        s = b[..., i, :]
        for k in range(i + 1, d):
            s = s - lt_as_l[..., k, i][..., None] * xs[k]
        xs[i] = s / lt_as_l[..., i, i][..., None]
    return torch.stack(xs, dim=-2)


def solve_psd_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small SPD A via the unrolled Cholesky.
    b: (..., d, m) or (..., d) (a vector right-hand side)."""
    vector_rhs = b.ndim == a.ndim - 1
    if vector_rhs:
        b = b[..., None]
    l = chol_small(a)
    x = solve_upper_small(l, solve_lower_small(l, b))
    return x[..., 0] if vector_rhs else x


def logdet_psd_small(a: torch.Tensor) -> torch.Tensor:
    """log det of small SPD matrices via the unrolled factor."""
    l = chol_small(a)
    return 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)),
                           dim=-1)
