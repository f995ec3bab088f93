"""GP hyperparameter training by marginal-likelihood ascent
(port of gpmpc_tpu/gp/train.py).

Adam over (log_lambdas, log_sigma_f, log_sigma_n) of all E outputs at once
(their log-MLs are independent terms of the summed objective), with frozen
parameters as zeroed gradients, an optional noise floor projected after every
step, an early stop once every gradient entry is below `tol`, and a final
refit. The Adam rule is optax's `adam(lr, b1=0.9, b2=0.999)` written out:
eps = 1e-8 outside the square root, no eps inside it, bias correction by the
step count.

The negative log-likelihood is evaluated in f64 from the f64 fit
(`state.fit_f64`) and differentiated by autograd through it; Adam's state
is f64 too. Only the final hyperparameters are rounded to the storage dtype,
so an f32 GP trains as an f64 one would.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import NamedTuple

import torch

from gpmpc_tpu_torch.gp.exact import log_marginal_likelihood
from gpmpc_tpu_torch.gp.state import GPState, fit, fit_f64, residuals

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class TrainResult(NamedTuple):
    state: GPState            # refit under the trained hyperparameters
    log_ml: torch.Tensor      # (E,) final per-output log marginal likelihood
    iters: int                # iterations taken
    grad_norm: float          # final max |grad| over all hyperparameters


def _neg_ml_and_grad(state64: GPState, hp, resid, n, flags):
    """-sum log ML at hyperparameters hp (three f64 tensors) and its masked
    gradient."""
    hp = [h.detach().requires_grad_(True) for h in hp]
    with torch.enable_grad():
        s = replace(state64, log_lambdas=hp[0], log_sigma_f=hp[1],
                    log_sigma_n=hp[2])
        _, beta, logdet, _ = fit_f64(s, need_kinv=False)
        quad = torch.sum(resid * beta, dim=-1)
        neg = torch.sum(0.5 * quad + 0.5 * logdet
                        + 0.5 * n * math.log(2.0 * math.pi))
        grads = torch.autograd.grad(neg, hp)
    return [g if f else torch.zeros_like(g) for g, f in zip(grads, flags)]


def adam_step(params, grads, mu, nu, count: int, lr: float):
    """One step of optax's adam(lr, b1=0.9, b2=0.999, eps=1e-8) descending
    on each tensor of `params` (lists of tensors): the moments update, bias
    correction by the step count `count` (1 on the first step) and
    params - lr m_hat / (sqrt(v_hat) + eps). Returns (params, mu, nu)."""
    out = ([], [], [])
    for p, g, m, v in zip(params, grads, mu, nu):
        m = (1 - _B1) * g + _B1 * m
        v = (1 - _B2) * g ** 2 + _B2 * v
        m_hat = m / (1 - _B1 ** count)
        v_hat = v / (1 - _B2 ** count)
        for lst, val in zip(out, (p + (-lr) * (m_hat / (torch.sqrt(v_hat)
                                                        + _EPS)), m, v)):
            lst.append(val)
    return out


def _gnorm(g) -> float:
    return max(float(torch.max(torch.abs(gi))) for gi in g)


def train_hyperparams(state: GPState, num_iters: int = 1000, lr: float = 0.1,
                      tol: float = 1e-5, train_lambdas: bool = True,
                      train_sigma_f: bool = True, train_sigma_n: bool = True,
                      min_sigma_n: float = 0.0) -> TrainResult:
    """Maximize the exact log marginal likelihood over the kernel
    hyperparameters.

    The train_* flags freeze parameters; min_sigma_n > 0 projects sigma_n
    onto that floor after every step (a noiseless-interpolation optimum puts
    cond(Ky) beyond what f32 linear algebra can represent). The loop is
    JAX's: the gradient at the start, then while t < num_iters and
    max |g| >= tol, one Adam step and one new gradient. The result's config
    has tied_lambdas=False (per-output training unties the lengthscales)."""
    f64 = torch.float64
    flags = (train_lambdas, train_sigma_f, train_sigma_n)
    state64 = replace(state, x=state.x.to(f64), y=state.y.to(f64))
    resid = residuals(state64)
    n = float(state.count)
    hp = [v.detach().to(f64) for v in
          (state.log_lambdas, state.log_sigma_f, state.log_sigma_n)]
    log_floor = math.log(max(min_sigma_n, 1e-30))

    g = _neg_ml_and_grad(state64, hp, resid, n, flags)
    mu = [torch.zeros_like(h) for h in hp]
    nu = [torch.zeros_like(h) for h in hp]
    t = 0
    while t < num_iters and _gnorm(g) >= tol:
        hp, mu, nu = adam_step(hp, g, mu, nu, t + 1, lr)
        if min_sigma_n > 0.0:
            hp[2] = torch.clamp(hp[2], min=log_floor)
        g = _neg_ml_and_grad(state64, hp, resid, n, flags)
        t += 1

    dt = state.log_lambdas.dtype
    final = fit(replace(state, config=replace(state.config, tied_lambdas=False),
                        log_lambdas=hp[0].to(dt), log_sigma_f=hp[1].to(dt),
                        log_sigma_n=hp[2].to(dt)))
    return TrainResult(state=final, log_ml=log_marginal_likelihood(final),
                       iters=t, grad_norm=_gnorm(g))
