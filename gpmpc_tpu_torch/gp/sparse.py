"""Sparse (inducing-point, FITC) GP regression (port of gpmpc_tpu/gp/sparse.py).

The FITC posterior has the exact GP's algebraic form over the inducing set Z:

    mean(x*) = k(x*, Z) alpha
    var(x*)  = sigma_f^2 - k(x*, Z) W k(Z, x*)

with  B = Kzz + Kzx Lam^{-1} Kxz,  alpha = B^{-1} Kzx Lam^{-1} y,
      W = Kzz^{-1} - B^{-1},  Lam = diag(sigma_f^2 - qff) + sigma_n^2 I.

So `fit_sparse` returns an ordinary GPState whose buffer holds Z with
beta = alpha and kinv = W, and the rollouts, the variance-trace kernels, the
controller and the batch solves run on it unchanged at M^2 cost. Its kinv is
W, not Ky^{-1}: nothing may refit such a state (gp.state's `fit`, `append`,
`set_hyperparams` would rebuild an exact GP over the M points).

The fit runs in f64 from the operands and rounds W, alpha and the marginal
likelihood to their dtype, as the port's exact GP fit does (gp/state.py):
in f32, suite config 4's B = Kzz + Kzx Lam^{-1} Kxz fails its Cholesky
(the JAX package's f32 fit of it on the CPU returns NaN). It is
differentiable in Z by autograd (`optimize_inducing`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gpmpc_tpu_torch.device import ensure_true_f32
from gpmpc_tpu_torch.gp.kernels import se_gram_batched
from gpmpc_tpu_torch.gp.state import GPConfig, GPState, _rows_tied
from gpmpc_tpu_torch.gp.train import adam_step
from gpmpc_tpu_torch.utils.linalg import chol_inverse, chol_solve


def select_inducing(generator: torch.Generator, x: torch.Tensor,
                    m: int) -> torch.Tensor:
    """A random subset of m rows of x (N, d), drawn without replacement
    from `generator` (its bits are not jax.random's: pass Z explicitly to
    reproduce a JAX fit)."""
    idx = torch.randperm(x.shape[0], generator=generator,
                         device=generator.device)[:m]
    return x[idx.to(x.device)]


def fit_sparse(z: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               log_lambdas: torch.Tensor, log_sigma_f: torch.Tensor,
               log_sigma_n: torch.Tensor, mask: Optional[torch.Tensor] = None,
               jitter: float = 1e-6):
    """FITC fit. z (M, d) inducing inputs; x (N, d); y (E, N) targets;
    hyperparameters (E, d), (E,), (E,); mask (N,) marks the valid rows.

    Returns (state, ml): a GPState over the inducing set (x = z,
    beta = alpha, kinv = W, y and logdet zero) and the per-output FITC log
    marginal likelihood (E,), in z's dtype (computed in f64)."""
    ensure_true_f32()
    out_dt = z.dtype
    z_in, ll_in, lsf_in, lsn_in = z, log_lambdas, log_sigma_f, log_sigma_n
    z, x, y, log_lambdas, log_sigma_f, log_sigma_n = (
        t.to(torch.float64) for t in (z, x, y, log_lambdas, log_sigma_f,
                                      log_sigma_n))
    m_ind, d = z.shape
    e = y.shape[0]
    dt, dev = z.dtype, z.device
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=torch.bool, device=dev)
    mw = mask.to(dt)
    sf2 = torch.exp(2.0 * log_sigma_f)[:, None]                   # (E, 1)
    sn2 = torch.exp(2.0 * log_sigma_n)[:, None]
    eye = torch.eye(m_ind, dtype=dt, device=dev)

    kzz = (se_gram_batched(z, z, log_lambdas, log_sigma_f)
           + (jitter * sf2[..., None] + 1e-12) * eye)             # (E, M, M)
    kzx = se_gram_batched(z, x, log_lambdas, log_sigma_f) * mw    # (E, M, N)
    lzz = torch.linalg.cholesky(kzz)
    v = torch.linalg.solve_triangular(lzz, kzx, upper=False)
    qff = torch.sum(v * v, dim=1)                                 # (E, N)
    # FITC heteroscedastic noise; padded columns get 1.0 (inert).
    lam = torch.where(mask, sf2 - qff + sn2, torch.ones_like(qff))
    lam = torch.maximum(lam, sn2)          # guard qff > sf2 roundoff

    kxl = kzx / lam[:, None, :]                                   # (E, M, N)
    b = kzz + kxl @ kzx.transpose(1, 2)
    b = 0.5 * (b + b.transpose(1, 2))
    lb = torch.linalg.cholesky(b)
    y_m = y * mw
    r = (kxl @ y_m[..., None])[..., 0]                            # (E, M)
    alpha = chol_solve(lb, r)
    w = chol_inverse(lzz) - chol_inverse(lb)

    # FITC log marginal likelihood.
    quad = torch.sum(y_m * y_m / lam, dim=-1) - torch.sum(r * alpha, dim=-1)
    logdet = (2.0 * torch.sum(torch.log(torch.diagonal(lb, dim1=-2, dim2=-1)),
                              dim=-1)
              - 2.0 * torch.sum(torch.log(torch.diagonal(lzz, dim1=-2,
                                                         dim2=-1)), dim=-1)
              + torch.sum(torch.where(mask, torch.log(lam),
                                      torch.zeros_like(lam)), dim=-1))
    ml = (-0.5 * quad - 0.5 * logdet
          - 0.5 * torch.sum(mw) * math.log(2.0 * math.pi))

    cfg = GPConfig(capacity=m_ind, x_dim=d, out_dim=e,
                   tied_lambdas=_rows_tied(ll_in))
    state = GPState(
        config=cfg, x=z_in, y=torch.zeros((e, m_ind), dtype=out_dt,
                                          device=dev),
        mask=torch.ones((m_ind,), dtype=torch.bool, device=dev),
        count=torch.tensor(m_ind, dtype=torch.int32, device=dev),
        log_lambdas=ll_in, log_sigma_f=lsf_in, log_sigma_n=lsn_in,
        kinv=w.to(out_dt), beta=alpha.to(out_dt),
        logdet=torch.zeros((e,), dtype=out_dt, device=dev),
        jitter_used=torch.zeros((e,), dtype=out_dt, device=dev))
    return state, ml.to(out_dt)


def optimize_inducing(z0: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      log_lambdas: torch.Tensor, log_sigma_f: torch.Tensor,
                      log_sigma_n: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      num_iters: int = 150, lr: float = 0.05):
    """Gradient refinement of the inducing inputs: num_iters steps of Adam
    (gp.train.adam_step, optax's rule) ascending the FITC log marginal
    likelihood summed over outputs, non-finite gradient entries as 0; the
    hyperparameters stay fixed. Returns fit_sparse at the final Z."""
    def neg_ml_grad(z):
        z_var = z.detach().requires_grad_(True)
        with torch.enable_grad():
            _, ml = fit_sparse(z_var, x, y, log_lambdas, log_sigma_f,
                               log_sigma_n, mask)
            (g,) = torch.autograd.grad(-torch.sum(ml), z_var)
        return torch.where(torch.isfinite(g), g, torch.zeros_like(g))

    z = [z0.detach()]
    mu, nu = [torch.zeros_like(z[0])], [torch.zeros_like(z[0])]
    for t in range(num_iters):
        z, mu, nu = adam_step(z, [neg_ml_grad(z[0])], mu, nu, t + 1, lr)
    with torch.no_grad():
        return fit_sparse(z[0], x, y, log_lambdas, log_sigma_f, log_sigma_n,
                          mask)
