"""The reference objective of the benchmark's problems: exact GPs fitted in
f64 from the raw data, the diagonal-covariance moment-matched rollout and
the risk-sensitive cost, batched over lanes (each lane with its own GP, or
one GP shared by every lane).

Model (the configuration's): k(x, x') = sf^2 exp(-1/2 (x - x')^T L^-1
(x - x')) with L = diag(lambdas), one GP a state output sharing the inputs
(state | action). A step takes the joint input N([m, a], diag([v, va])) to
the GP outputs' exact predictive means and variances; the next state's
variance is the diagonal of the outputs' covariance (the cross-output terms
are not carried), floored at 1e-8. With delta dynamics the GP outputs are
state increments: the next mean is m + the outputs' mean, the next
variance v + the outputs' variance + twice the covariance of each state
with its own increment (Deisenroth's input-output covariance,
sum_i beta_i q_i s / (s + lambda) (x_i - u)). The cost sums, over the H + 1 states
(the first with variance v0), (1/g) log det(I + g Q S) + dx^T (Q^-1 +
g S)^-1 dx (g = 0: tr(Q S) + dx^T Q dx; 1e6 where I + g Q S is not
positive definite) and, over the H actions, u^T R u.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F64 = torch.float64
MIN_VAR = 1e-8
PD_PENALTY = 1e6


class GP(NamedTuple):
    """Exact GPs of E outputs over L lanes: x (L, n, D) the valid rows;
    lambdas (D,); sf2, sn2 floats; beta (L, E, n); kinv (L, E, n, n)."""
    x: torch.Tensor
    lambdas: torch.Tensor
    sf2: float
    beta: torch.Tensor
    kinv: torch.Tensor


def fit(x, y, lambdas, sf, sn) -> GP:
    """x (L, n, D), y (L, n, E) raw data -> the GPs fitted in f64: K =
    sf^2 exp(-1/2 d^2_L) + sn^2 I, one Cholesky a lane, K^-1 and
    beta = K^-1 y (the same K for every output). Where a lane's Cholesky
    fails, the jitter 10 eps mean(diag K) is added to its K and grown
    tenfold until it factorizes, as the model's fit does."""
    x, y = x.to(F64), y.to(F64)
    lam = torch.as_tensor(lambdas, dtype=F64, device=x.device)
    d2 = (((x[:, :, None, :] - x[:, None, :, :]) ** 2) / lam).sum(-1)
    k = sf ** 2 * torch.exp(-0.5 * d2)
    eye = torch.eye(x.shape[1], dtype=F64, device=x.device).expand_as(k)
    k = k + sn ** 2 * eye
    chol, info = torch.linalg.cholesky_ex(k)
    base = 10.0 * torch.finfo(F64).eps * (sf ** 2 + sn ** 2)
    jitter = torch.zeros_like(k[:, 0, 0])
    while bool((info != 0).any()):
        jitter = torch.where(info == 0, jitter, torch.where(
            jitter == 0, torch.full_like(jitter, base), 10.0 * jitter))
        chol, info = torch.linalg.cholesky_ex(k + jitter[:, None, None] * eye)
    kinv = torch.cholesky_solve(eye, chol)
    beta = torch.cholesky_solve(y, chol).transpose(1, 2)      # (L, E, n)
    e = y.shape[2]
    return GP(x=x, lambdas=lam, sf2=float(sf) ** 2, beta=beta,
              kinv=kinv[:, None].expand(-1, e, -1, -1))


def lane(gp: GP, idx) -> GP:
    """The GPs of lanes idx (a shared GP, L = 1, stays shared)."""
    if gp.x.shape[0] == 1:
        return gp
    return gp._replace(x=gp.x[idx], beta=gp.beta[idx], kinv=gp.kinv[idx])


def moments(gp: GP, u, s, io: bool = False):
    """Predictive means and variances (B, E) of the GP outputs at inputs
    N(u, diag(s)), u and s (B, D); lane b of the GP serves row b (or the one
    shared GP every row)."""
    lam, x = gp.lambdas, gp.x                                   # x (L, n, D)
    sf2 = gp.sf2
    # E[k(x*, x_i)] = sf^2 |S L^-1 + I|^-1/2 exp(-1/2 (u - x_i)^T
    # (S + L)^-1 (u - x_i)).
    diff = u[:, None, :] - x                                   # (B, n, D)
    q = sf2 * torch.exp(-0.5 * (diff ** 2 / (s[:, None, :] + lam)).sum(-1)
                        - 0.5 * torch.log(s / lam + 1.0).sum(-1)[:, None])
    beta = gp.beta.expand(u.shape[0], -1, -1)
    mean = torch.einsum('ben,bn->be', beta, q)
    # E[k(x*, x_i) k(x*, x_j)] = sf^4 exp(-1/4 d^2_L(x_i, x_j))
    # |2 S L^-1 + I|^-1/2 exp(-1/2 (u - xbar_ij)^T (L/2 + S)^-1 (u - xbar_ij)).
    xbar = 0.5 * (x[:, :, None, :] + x[:, None, :, :])         # (L, n, n, D)
    dij = (((x[:, :, None, :] - x[:, None, :, :]) ** 2) / lam).sum(-1)
    hls = lam / 2.0 + s                                         # (B, D)
    ex = ((u[:, None, None, :] - xbar) ** 2 / hls[:, None, None, :]).sum(-1)
    qq = (sf2 ** 2 * torch.exp(-0.25 * dij - 0.5 * ex)
          * torch.rsqrt(torch.prod(2.0 * s / lam + 1.0, dim=-1))[:, None, None])
    bmat = gp.kinv - gp.beta[..., :, None] * gp.beta[..., None, :]
    tr = torch.einsum('beij,bij->be', bmat.expand(u.shape[0], -1, -1, -1), qq)
    var = sf2 - tr - mean ** 2
    if not io:
        return mean, var
    # cov(input d, output e) = sum_i beta_ei q_i s_d / (s_d + lambda_d)
    # (x_id - u_d): (B, E, D).
    c = torch.einsum('ben,bn,bnd->bed', beta, q, -diff) * (s / (s + lam))[:, None]
    return mean, var, c


def rollout(gp: GP, x0, u, v0: float, va: float, delta: bool = False):
    """x0 (B, ds), u (B, H, da) -> means (B, H + 1, ds), variances
    (B, H + 1, ds): the next state is the GP outputs' moments, or with
    `delta` the state plus them (module docstring)."""
    b, ds = x0.shape
    mean, var = x0, x0.new_full((b, ds), v0)
    means, variances = [mean], [var]
    for t in range(u.shape[1]):
        a = u[:, t]
        joint = torch.cat([mean, a], dim=1)
        s = torch.cat([var, torch.full_like(a, va)], dim=1)
        if delta:
            d_mean, d_var, c = moments(gp, joint, s, io=True)
            ds = mean.shape[1]
            mean = mean + d_mean
            var = var + d_var + 2.0 * torch.diagonal(c[:, :, :ds], dim1=1,
                                                     dim2=2)
        else:
            mean, var = moments(gp, joint, s)
        var = torch.clamp(var, min=MIN_VAR)
        means.append(mean)
        variances.append(var)
    return torch.stack(means, 1), torch.stack(variances, 1)


def risk_cost(means, variances, u, q_diag, r_diag, gamma, x_ref=None):
    """(B,) risk-sensitive cost of diagonal state covariances: q_diag (ds,),
    r_diag (da,), gamma (B,)."""
    dx = means if x_ref is None else means - x_ref
    g = gamma[:, None, None]
    zero = g == 0.0
    g_safe = torch.where(zero, torch.ones_like(g), g)
    gdiag = 1.0 / q_diag + g_safe * variances                   # (B, T, ds)
    ok = (gdiag > 0).all(-1)
    gpos = torch.where(gdiag > 0, gdiag, torch.ones_like(gdiag))
    general = ((torch.log(q_diag * gpos).sum(-1)) / g_safe[..., 0]
               + (dx ** 2 / gpos).sum(-1))
    general = torch.where(ok, general, torch.full_like(general, PD_PENALTY))
    limit = (q_diag * variances).sum(-1) + (q_diag * dx ** 2).sum(-1)
    state = torch.where(zero[..., 0], limit, general).sum(1)
    return state + (r_diag * u ** 2).sum((1, 2))


class Headline(NamedTuple):
    """A problem's objective constants (the configuration's)."""
    q_diag: torch.Tensor
    r_diag: torch.Tensor
    v0: float
    va: float
    lb: float
    ub: float
    delta: bool = False


def headline(cfg: dict, device) -> Headline:
    ds, da = cfg['state_dim'], cfg['action_dim']
    return Headline(
        q_diag=torch.full((ds,), float(cfg['Q_diag']), dtype=F64,
                          device=device),
        r_diag=torch.full((da,), float(cfg['R_diag']), dtype=F64,
                          device=device),
        v0=float(cfg['init_state_var']), va=float(cfg['action_var']),
        lb=float(cfg['lb']), ub=float(cfg['ub']),
        delta=bool(cfg.get('delta_dynamics', False)))


def objective(gp: GP, h: Headline, x0, u, gamma):
    """(B,) cost of controls u (B, H, da) from x0 (B, ds)."""
    means, variances = rollout(gp, x0, u, h.v0, h.va, h.delta)
    return risk_cost(means, variances, u, h.q_diag, h.r_diag, gamma)


def judge(gp: GP, h: Headline, x0, u, gamma):
    """(cost (B,), projected-gradient residual (B,)) at controls u in f64:
    the residual is max |u - clip(u - dJ/du, lb, ub)| over the horizon."""
    u = u.detach().to(F64).requires_grad_(True)
    with torch.enable_grad():
        j = objective(gp, h, x0.to(F64), u, gamma.to(F64))
        (g,) = torch.autograd.grad(j.sum(), u)
    with torch.no_grad():
        pg = (u - torch.clamp(u - g, h.lb, h.ub)).abs().flatten(1).amax(1)
    return j.detach(), pg


