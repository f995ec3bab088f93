"""GPState: the padded, multi-output exact GP (port of gpmpc_tpu/gp/state.py).

The training set is a fixed-capacity padded buffer with a mask; one state
covers all E outputs that share inputs. Cached per fit:

  kinv   regularized Ky^{-1}              (E, cap, cap)
  beta   Ky^{-1} y on the valid rows      (E, cap)
  logdet log det Ky on the valid block    (E,)

The factorization runs in f64 on the state's device and is cast back to the
storage dtype: at the headline conditioning (cond(Ky) ~ 2e4) an f32 Cholesky
leaves ~1e-3 relative error in beta and kinv, a systematic model error the
H-step rollout amplifies. The default backend is the adaptive-jitter
Cholesky of the JAX package: no jitter first, then 10 eps * mean(diag Ky),
growing tenfold, nine attempts in all; the jitter is chosen without a
gradient and the Cholesky at that jitter carries it, so hyperparameter
training (gp/train.py) differentiates through the fit. GPConfig(
solve_backend='eigh') takes the spectrum-clipped eigendecomposition instead.

`append` writes new rows on the device with a masked write (rows past the
capacity are dropped) and refits; `grow` repads to a larger capacity;
`set_hyperparams` sets hyperparameters in natural space and refits.
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
    # Factorization backend: 'chol' (adaptive-jitter Cholesky) or 'eigh'
    # (eigendecomposition with the spectrum clipped at N eps w_max).
    solve_backend: str = 'chol'


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

    @property
    def capacity(self) -> int:
        return self.config.capacity

    @property
    def lambdas(self) -> torch.Tensor:
        return torch.exp(self.log_lambdas)

    @property
    def sigma_f(self) -> torch.Tensor:
        return torch.exp(self.log_sigma_f)

    @property
    def sigma_n(self) -> torch.Tensor:
        return torch.exp(self.log_sigma_n)


def residuals(state: GPState) -> torch.Tensor:
    """(E, cap) masked targets minus the nominal mean (zero where padded)."""
    y = state.y
    if state.config.nominal_fn is not None:
        y = y - state.config.nominal_fn(state.x).T
    return y * state.mask.to(y.dtype)


def _chol_with_jitter(ky, diag_mask, base_jitter, eps0):
    """Cholesky of ky + j * diag_mask at the smallest j of the escalation that
    factorizes; returns (chol, j). j is chosen on the host without a gradient;
    the factor at that j carries ky's."""
    j = float(base_jitter)
    for _ in range(_JITTER_ATTEMPTS):
        chol, info = torch.linalg.cholesky_ex(ky + j * diag_mask)
        if int(info) == 0:
            return chol, j
        j = eps0 if j == 0.0 else j * 10.0
    raise torch.linalg.LinAlgError('jitter escalation exhausted')


def _solve_chol(ky, m, resid, base_jitter, need_kinv):
    """One output's (kinv or None, beta, logdet, jitter) by the escalating-
    jitter Cholesky; m is the mask as ky's dtype."""
    n_valid = max(float(m.sum()), 1.0)
    mean_diag = float(torch.sum(torch.diagonal(ky).detach() * m)) / n_valid
    eps0 = 10.0 * torch.finfo(ky.dtype).eps * mean_diag
    chol, j = _chol_with_jitter(ky, torch.diag(m), base_jitter, eps0)
    kinv = chol_inverse(chol) if need_kinv else None
    return kinv, chol_solve(chol, resid), chol_logdet(chol), j


def _solve_eigh(ky, m, resid, base_jitter, need_kinv):
    """One output's (kinv or None, beta, logdet, clip floor) from the
    eigendecomposition with the spectrum clipped at max(jitter,
    N eps w_max): the exact posterior in well-conditioned directions; the
    padded block's unit eigenvalues add 0 to logdet."""
    w, v = torch.linalg.eigh(ky)
    floor = max(float(base_jitter),
                ky.shape[-1] * torch.finfo(ky.dtype).eps * float(w[-1]))
    w_clip = torch.clamp(w, min=floor)
    w_inv = 1.0 / w_clip
    kinv = (v * w_inv[None, :]) @ v.T if need_kinv else None
    beta = v @ (w_inv * (v.T @ resid))
    return kinv, beta, torch.sum(torch.log(w_clip)), floor


def fit_f64(state: GPState, need_kinv: bool = True):
    """(kinv (E, cap, cap) or None, beta (E, cap), logdet (E,), jitter (E,))
    of the masked Ky under the state's data and hyperparameters, all in f64,
    differentiable w.r.t. the log hyperparameters (the jitter is not)."""
    cfg = state.config
    if cfg.solve_backend not in ('chol', 'eigh'):
        raise ValueError(f'unknown solve_backend {cfg.solve_backend!r}')
    f64 = torch.float64
    x = state.x.to(f64)
    kf = se_gram_batched(x, x, state.log_lambdas.to(f64),
                         state.log_sigma_f.to(f64))
    ky = masked_psd_add(kf, state.mask,
                        torch.exp(2.0 * state.log_sigma_n.to(f64)))
    resid = residuals(state).to(f64)
    m = state.mask.to(f64)
    solver = _solve_chol if cfg.solve_backend == 'chol' else _solve_eigh
    outs = [solver(ky[k], m, resid[k], cfg.jitter, need_kinv)
            for k in range(cfg.out_dim)]
    kinv = torch.stack([o[0] for o in outs]) if need_kinv else None
    jit = torch.tensor([o[3] for o in outs], dtype=f64, device=x.device)
    return (kinv, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]), jit)


def _factorize(state: GPState) -> GPState:
    """Rebuild kinv / beta / logdet under the current data and hyperparameters
    (masked Ky with a unit padded diagonal), in f64, cast to the storage
    dtype."""
    dt = state.x.dtype
    kinv, beta, logdet, jit = fit_f64(state)
    return replace(state, kinv=kinv.to(dt), beta=beta.to(dt),
                   logdet=logdet.to(dt), jitter_used=jit.to(dt))


fit = _factorize


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


def append(state: GPState, x_new, y_new) -> GPState:
    """Append observations on the state's device and refit.

    x_new: (x_dim,) or (n, x_dim); y_new: (out_dim,) or (n, out_dim), tensors
    or array-likes. Rows that do not fit in the capacity are dropped (`grow`
    repads): they are written to a spare row that is cut off, so the count
    never leaves the device before the fit."""
    cfg = state.config
    dev = state.x.device
    x_new = torch.as_tensor(x_new, dtype=state.x.dtype,
                            device=dev).reshape(-1, cfg.x_dim)
    y_new = torch.as_tensor(y_new, dtype=state.y.dtype,
                            device=dev).reshape(-1, cfg.out_dim)
    n, cap = x_new.shape[0], cfg.capacity
    idx = state.count.long() + torch.arange(n, device=dev)
    slot = torch.where(idx < cap, idx, torch.full_like(idx, cap))
    x = torch.cat([state.x, state.x.new_zeros((1, cfg.x_dim))])
    y = torch.cat([state.y, state.y.new_zeros((cfg.out_dim, 1))], dim=1)
    mask = torch.cat([state.mask, state.mask.new_zeros((1,))])
    x[slot] = x_new
    y[:, slot] = y_new.T
    mask[slot] = True
    count = torch.clamp(state.count + n, max=cap).to(torch.int32)
    return _factorize(replace(state, x=x[:cap], y=y[:, :cap], mask=mask[:cap],
                              count=count))


# Alias for loop bodies where `append` names a local.
gp_append = append


def grow(state: GPState, new_capacity: int) -> GPState:
    """Repad to a larger capacity and refit."""
    if new_capacity < state.config.capacity:
        raise ValueError('new capacity must be >= current capacity')
    pad = new_capacity - state.config.capacity
    e = state.config.out_dim
    return _factorize(replace(
        state, config=replace(state.config, capacity=new_capacity),
        x=torch.nn.functional.pad(state.x, (0, 0, 0, pad)),
        y=torch.nn.functional.pad(state.y, (0, pad)),
        mask=torch.nn.functional.pad(state.mask, (0, pad)),
        kinv=state.kinv.new_zeros((e, new_capacity, new_capacity)),
        beta=state.beta.new_zeros((e, new_capacity))))


def set_hyperparams(state: GPState, lambdas=None, sigma_f=None, sigma_n=None,
                    refit: bool = True) -> GPState:
    """Set hyperparameters in natural (not log) space, broadcast to every
    output; lengthscales re-detect `tied_lambdas`. Refits unless
    refit=False."""
    e, d = state.log_lambdas.shape
    dt, dev = state.log_lambdas.dtype, state.x.device

    def log_of(v, shape):
        v = (v.to(dt) if isinstance(v, torch.Tensor)
             else torch.tensor(np.asarray(v), dtype=dt))
        return torch.log(v.to(dev)).broadcast_to(shape).clone()

    if lambdas is not None:
        state = replace(state, log_lambdas=log_of(lambdas, (e, d)),
                        config=replace(state.config,
                                       tied_lambdas=_rows_tied(lambdas)))
    if sigma_f is not None:
        state = replace(state, log_sigma_f=log_of(sigma_f, (e,)))
    if sigma_n is not None:
        state = replace(state, log_sigma_n=log_of(sigma_n, (e,)))
    return _factorize(state) if refit else state
