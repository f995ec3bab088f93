"""Risk-sensitive MPC cost, batched over B lanes (port of gpmpc_tpu/mpc/cost.py).

  J = sum_{i=0..H} [ (1/gamma) log det(I + gamma Q Sigma_i)
                     + (x_i - x_ref)^T (Q^{-1} + gamma Sigma_i)^{-1} (x_i - x_ref) ]
    + sum_{j=0..H-1} (u_j - u_ref)^T R (u_j - u_ref)
    + sum_{j=0..H-1} du_j^T R_delta du_j          (du = diff of [u_prev; u])

gamma < 0 is risk-averse, gamma > 0 risk-seeking. gamma = 0 takes the exact
limit tr(Q Sigma) + dx^T Q dx, and a step where I + gamma Q Sigma leaves the
PD cone costs a finite 1e6 instead of NaN.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gpmpc_tpu_torch.utils.smallchol import (chol_small, solve_lower_small,
                                             solve_psd_small)

_PD_PENALTY = 1e6

# Canonical (shared) rank of each leaf; a leaf one rank higher carries a
# leading (B,) lane axis. R and R_delta are always shared.
_SHARED_RANK = {'Q': 2, 'gamma': 0, 'x_ref': 1, 'u_ref': 1, 'u_prev': 1}


class CostParams(NamedTuple):
    Q: torch.Tensor                         # (ds, ds) or (B, ds, ds)
    R: torch.Tensor                         # (da, da)
    gamma: torch.Tensor                     # () or (B,)
    x_ref: torch.Tensor                     # (ds,) or (B, ds)
    u_ref: torch.Tensor                     # (da,) or (B, da)
    R_delta: Optional[torch.Tensor] = None  # (da, da) or None
    u_prev: Optional[torch.Tensor] = None   # (da,) or (B, da)


def is_lane_leaf(name: str, v) -> bool:
    """Whether cost leaf `name` with value v carries a leading (B,) lane axis.
    By its RANK, one above the shared rank, never by comparing its first dim
    to B (ambiguous when B = 1 or da == B): the rank rule of the JAX
    package's `_params_axes`. R and R_delta are always shared."""
    return (name in _SHARED_RANK and v is not None
            and torch.as_tensor(v).ndim == _SHARED_RANK[name] + 1)


def lane_params(params: CostParams, b: int) -> CostParams:
    """Give every leaf that may be per-lane a leading (B,) axis, broadcasting
    the shared ones (`is_lane_leaf`)."""
    out = {}
    for name, v in params._asdict().items():
        if name in _SHARED_RANK and v is not None:
            v = torch.as_tensor(v)
            if not is_lane_leaf(name, v):
                v = v.expand(b, *v.shape)
        out[name] = v
    return CostParams(**out)


def params_key(params: CostParams) -> tuple:
    """Which leaves are None: with `params_tensors` it rebuilds the params
    (`params_from`)."""
    return tuple(v is None for v in params)


def params_tensors(params: CostParams, device) -> tuple:
    """The leaves that are not None, as tensors on `device` (their dtypes
    kept)."""
    return tuple(torch.as_tensor(v, device=device) for v in params
                 if v is not None)


def params_from(key: tuple, tensors) -> CostParams:
    """The CostParams of params_key() and params_tensors()."""
    it = iter(tensors)
    return CostParams(*(None if none else next(it) for none in key))


def _stage_state_cost(q, gamma, x, sig, x_ref):
    """Risk term per (lane, step): q (B, 1, ds, ds); gamma (B, 1);
    x (B, T, ds); sig (B, T, ds, ds); x_ref (B, 1, ds) -> (B, T).

    Both general-branch pieces come from ONE Cholesky of G = Q^{-1} + g Sig:
    det(I + g Q Sig) = det(Q) det(G), and G is PD exactly when I + g Q Sig is
    in the PD cone. A failed Cholesky (NaN diagonal) is the PD-cone test."""
    ds = x.shape[-1]
    eye = torch.eye(ds, dtype=x.dtype, device=x.device)
    dx = x - x_ref
    is_zero = gamma == 0.0
    g = torch.where(is_zero, torch.ones_like(gamma), gamma)

    q_chol = chol_small(q)
    logdet_q = 2.0 * torch.sum(torch.log(torch.diagonal(q_chol, dim1=-2,
                                                        dim2=-1)), dim=-1)
    q_inv = solve_psd_small(q, eye.expand_as(q))

    big_g = q_inv + g[..., None, None] * sig
    g_chol = chol_small(big_g)
    ok = torch.all(torch.isfinite(torch.diagonal(g_chol, dim1=-2, dim2=-1)),
                   dim=-1)
    # Double-where: a sanitized factor keeps NaNs out of the selected branch.
    g_chol_safe = torch.where(ok[..., None, None], g_chol, eye)
    logdet_g = 2.0 * torch.sum(torch.log(torch.diagonal(g_chol_safe, dim1=-2,
                                                        dim2=-1)), dim=-1)
    logdet_term = (logdet_q + logdet_g) / g
    w = solve_lower_small(g_chol_safe, dx[..., None])[..., 0]
    quad_general = torch.sum(w * w, dim=-1)

    limit = (torch.diagonal(q @ sig, dim1=-2, dim2=-1).sum(-1)
             + torch.einsum('...i,...ij,...j->...', dx, q, dx))
    general = torch.where(ok, logdet_term + quad_general,
                          torch.full_like(quad_general, _PD_PENALTY))
    return torch.where(is_zero, limit, general)


def risk_sensitive_cost(params: CostParams, means, covs, u) -> torch.Tensor:
    """means (B, H+1, ds); covs (B, H+1, ds, ds); u (B, H, da) -> (B,).
    Per-lane parameters follow the rank rule of `lane_params`."""
    b = means.shape[0]
    p = lane_params(params, b)
    state_terms = _stage_state_cost(p.Q[:, None], p.gamma[:, None], means,
                                    covs, p.x_ref[:, None])
    cost = torch.sum(state_terms, dim=1)
    du_ref = u - p.u_ref[:, None, :]
    cost = cost + torch.sum((du_ref @ p.R) * du_ref, dim=(1, 2))
    if p.R_delta is not None:
        u_prev = p.u_prev if p.u_prev is not None else u.new_zeros(
            (b, u.shape[2]))
        du = torch.diff(torch.cat([u_prev[:, None, :], u], dim=1), dim=1)
        cost = cost + torch.sum((du @ p.R_delta) * du, dim=(1, 2))
    return cost
