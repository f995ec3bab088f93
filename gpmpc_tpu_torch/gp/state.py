"""GPState: the padded, multi-output exact GP (port of gpmpc_tpu/gp/state.py).

The training set is a fixed-capacity padded buffer with a mask; one state
covers all E outputs that share inputs. Cached per fit:

  kinv   regularized Ky^{-1}              (E, cap, cap)
  beta   Ky^{-1} y on the valid rows      (E, cap)
  logdet log det Ky on the valid block    (E,)

The factorization runs in f64 on the state's device and is cast back to the
storage dtype: at the headline conditioning (cond(Ky) ~ 2e4) an f32 Cholesky
leaves ~1e-3 relative error in beta and kinv, a systematic model error the
H-step rollout amplifies. It is the adaptive-jitter Cholesky of the JAX
package's host f64 core: no jitter first, then 10 eps * mean(diag Ky),
growing tenfold, nine attempts in all.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.gp.kernels import se_gram_batched
from gpmpc_tpu_torch.utils.linalg import (chol_inverse, chol_logdet,
                                          chol_solve, masked_psd_add)

_JITTER_ATTEMPTS = 9


@dataclass(frozen=True)
class GPConfig:
    """Static configuration."""
    capacity: int = 256
    x_dim: int = 1
    out_dim: int = 1
    jitter: float = 0.0
    # All output GPs share one lengthscale vector; auto-detected by make_gp.
    # Enables the shared-exp-chain variance kernel; never changes results.
    tied_lambdas: bool = False
    # Nominal mean model f_nom: (n, x_dim) -> (n, out_dim) torch tensors.
    # When set, the GP fits the residual y - f_nom(x), and dynamics.rollout
    # adds f_nom back (first-order moment propagation).
    nominal_fn: Optional[Callable] = None


@dataclass(frozen=True)
class GPState:
    config: GPConfig
    x: torch.Tensor            # (cap, x_dim) padded training inputs
    y: torch.Tensor            # (E, cap) padded targets, one row per output
    mask: torch.Tensor         # (cap,) bool validity
    count: torch.Tensor        # () int32 number of valid rows
    log_lambdas: torch.Tensor  # (E, x_dim)
    log_sigma_f: torch.Tensor  # (E,)
    log_sigma_n: torch.Tensor  # (E,)
    kinv: torch.Tensor         # (E, cap, cap)
    beta: torch.Tensor         # (E, cap)
    logdet: torch.Tensor       # (E,)
    jitter_used: torch.Tensor  # (E,)


def residuals(state: GPState) -> torch.Tensor:
    """(E, cap) masked targets minus the nominal mean (zero where padded)."""
    y = state.y
    if state.config.nominal_fn is not None:
        y = y - state.config.nominal_fn(state.x).T
    return y * state.mask.to(y.dtype)


def _chol_with_jitter(ky, diag_mask, base_jitter, eps0):
    """Cholesky of ky + j * diag_mask at the smallest j of the escalation that
    factorizes; returns (chol, j)."""
    j = float(base_jitter)
    for _ in range(_JITTER_ATTEMPTS):
        chol, info = torch.linalg.cholesky_ex(ky + j * diag_mask)
        if int(info) == 0:
            return chol, j
        j = eps0 if j == 0.0 else j * 10.0
    raise torch.linalg.LinAlgError('jitter escalation exhausted')


def _factorize(state: GPState) -> GPState:
    """Rebuild kinv / beta / logdet under the current data and hyperparameters
    (masked Ky with a unit padded diagonal), in f64, cast to the storage
    dtype."""
    cfg = state.config
    dt = state.x.dtype
    f64 = torch.float64
    kf = se_gram_batched(state.x.to(f64), state.x.to(f64),
                         state.log_lambdas.to(f64), state.log_sigma_f.to(f64))
    ky = masked_psd_add(kf, state.mask, torch.exp(2.0 * state.log_sigma_n.to(f64)))
    resid = residuals(state).to(f64)
    m = state.mask.to(f64)
    diag_mask = torch.diag(m)
    n_valid = max(int(state.mask.sum()), 1)
    kinv, beta, logdet, jit = [], [], [], []
    for k in range(cfg.out_dim):
        mean_diag = float(torch.sum(torch.diagonal(ky[k]) * m)) / n_valid
        eps0 = 10.0 * torch.finfo(f64).eps * mean_diag
        chol, j = _chol_with_jitter(ky[k], diag_mask, cfg.jitter, eps0)
        kinv.append(chol_inverse(chol))
        beta.append(chol_solve(chol, resid[k]))
        logdet.append(chol_logdet(chol))
        jit.append(j)
    return replace(state,
                   kinv=torch.stack(kinv).to(dt), beta=torch.stack(beta).to(dt),
                   logdet=torch.stack(logdet).to(dt),
                   jitter_used=torch.tensor(jit, dtype=dt, device=state.x.device))


def _rows_tied(v) -> bool:
    """True iff the lengthscale spec `v` has equal per-output rows
    (None, scalar and 1-D specs broadcast to every output, so they tie)."""
    if v is None:
        return True
    arr = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    if arr.ndim <= 1:
        return True
    return bool(np.all(arr == arr[0]))


def make_gp(config: GPConfig, x=None, y=None, log_lambdas=None,
            log_sigma_f=None, log_sigma_n=None, dtype=torch.float32,
            device=None) -> GPState:
    """Create a fitted GPState, optionally pre-loaded with training data.

    x: (n, x_dim); y: (n, out_dim), array-likes loaded into the padded
    buffers. Hyperparameters default to log(1) = 0. `device` defaults to CUDA.
    """
    dev = resolve_device(device)
    cap, d, e = config.capacity, config.x_dim, config.out_dim
    xb = torch.zeros((cap, d), dtype=dtype, device=dev)
    yb = torch.zeros((e, cap), dtype=dtype, device=dev)
    mask = torch.zeros((cap,), dtype=torch.bool, device=dev)
    n = 0
    if x is not None:
        xt = torch.tensor(np.asarray(x), dtype=dtype, device=dev).reshape(-1, d)
        yt = torch.tensor(np.asarray(y), dtype=dtype, device=dev).reshape(-1, e)
        n = xt.shape[0]
        if n > cap:
            raise ValueError(f'{n} training points exceed capacity {cap}')
        xb[:n] = xt
        yb[:, :n] = yt.T
        mask[:n] = True

    def _hp(v, shape):
        if v is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return torch.tensor(np.asarray(v), dtype=dtype,
                            device=dev).broadcast_to(shape).clone()

    state = GPState(
        config=replace(config, tied_lambdas=_rows_tied(log_lambdas)),
        x=xb, y=yb, mask=mask,
        count=torch.tensor(n, dtype=torch.int32, device=dev),
        log_lambdas=_hp(log_lambdas, (e, d)),
        log_sigma_f=_hp(log_sigma_f, (e,)),
        log_sigma_n=_hp(log_sigma_n, (e,)),
        kinv=torch.zeros((e, cap, cap), dtype=dtype, device=dev),
        beta=torch.zeros((e, cap), dtype=dtype, device=dev),
        logdet=torch.zeros((e,), dtype=dtype, device=dev),
        jitter_used=torch.zeros((e,), dtype=dtype, device=dev))
    return _factorize(state)
