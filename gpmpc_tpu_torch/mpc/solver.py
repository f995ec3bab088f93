"""Box-constrained trajectory solvers (port of gpmpc_tpu/mpc/solver.py).

`solve_trajectory_batched`: lockstep projected L-BFGS over B independent
solves. Every lane has its own acceptance, step size, history and
convergence; lanes that are done freeze while the loop runs on until all are
done or the iteration cap. The JAX `lax.while_loop` is a host loop here; it
reads `all(done)` once per iteration, so the iteration count is the JAX one.

`solve_trajectory`: one solve of objective(u) -> scalar, by projected L-BFGS
(method='lbfgs', the batched solver at B = 1: JAX's single-scenario L-BFGS
is the same recurrence lane for lane) or by projected Adam with a fixed step
and an optional polish of normalized-gradient steps (method='adam').
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


@dataclass(frozen=True)
class SolverConfig:
    # 'lbfgs': projected L-BFGS with a projected-Armijo step; 'adam':
    # projected Adam with a fixed step (solve_trajectory only).
    method: str = 'lbfgs'
    max_iters: int = 300
    tol: float = 1e-4
    # Adam options.
    learning_rate: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # L-BFGS history length.
    history: int = 8
    # Kept for the JAX config's field set; the single-candidate Armijo step
    # has no inner backtracking loop.
    max_backtracks: int = 20
    # Nonmonotone Armijo window (accept against the max of the last
    # `nonmonotone` accepted values); 0 = monotone.
    nonmonotone: int = 0
    # Relative objective noise for the noise-tolerant Armijo test; with
    # noise_rel > 0 a lane is done after `progress_window` iterations without
    # improvement beyond the noise, and the best iterate is returned.
    noise_rel: float = 0.0
    progress_window: int = 12
    # Projected steps along the normalized gradient after the main loop, the
    # step decaying by 2^(-1/4) each (solve_trajectory with Adam).
    polish_iters: int = 0

    def replace(self, **changes) -> 'SolverConfig':
        """A copy with `changes` applied (the JAX struct's `.replace`)."""
        return dataclasses.replace(self, **changes)


class SolveResult(NamedTuple):
    u: torch.Tensor          # (B, H, da); (H, da) from solve_trajectory
    cost: torch.Tensor       # (B,) or ()
    iters: torch.Tensor      # (B,) iterations each lane took, or ()
    pg_norm: torch.Tensor    # (B,) projected-gradient residual (inf-norm)
    # (B,) done before the cap; None from the Adam solver, as in JAX.
    converged: Optional[torch.Tensor] = None


def first_lane(res: SolveResult) -> SolveResult:
    """Lane 0 of a batched result, shaped as a single solve's."""
    return SolveResult(*(t[0] for t in res))


def _value_and_grad(objective_b, u_flat, shape):
    """f (B,) and its per-lane gradient (B, n): lanes are independent, so the
    gradient of the sum is the stack of the per-lane gradients."""
    u_var = u_flat.detach().requires_grad_(True)
    with torch.enable_grad():
        f = objective_b(u_var.reshape(shape))
        (g,) = torch.autograd.grad(f.sum(), u_var)
    return f.detach(), g


def _bdot(x, y):
    return torch.einsum('bn,bn->b', x, y)


def solve_trajectory_batched(objective_b: Optional[Callable[[torch.Tensor],
                                                             torch.Tensor]],
                             u_init: torch.Tensor, lb, ub,
                             config: SolverConfig = SolverConfig(),
                             val_and_grad: Optional[Callable] = None
                             ) -> SolveResult:
    """objective_b: (B, H, da) -> (B,) independent per-lane objectives,
    differentiable by autograd. lb/ub broadcast against u_init.

    val_and_grad, if given, replaces autograd of objective_b (which may then
    be None): an external (f, g) oracle taking u (B, H, da) and returning
    f (B,) and g (B, H, da), e.g. the collective program of
    parallel/model_sharded.py."""
    dt = u_init.dtype
    dev = u_init.device
    b = u_init.shape[0]
    shape = u_init.shape
    n = u_init[0].numel()
    mem = config.history
    lb_f = torch.as_tensor(lb, dtype=dt, device=dev).broadcast_to(shape).reshape(b, n)
    ub_f = torch.as_tensor(ub, dtype=dt, device=dev).broadcast_to(shape).reshape(b, n)
    zero = torch.zeros((), dtype=dt, device=dev)
    eps = torch.finfo(dt).eps

    if val_and_grad is None:
        def val_and_grad(u):
            return _value_and_grad(objective_b, u, shape)
    else:
        vg_ext = val_and_grad

        def val_and_grad(u):
            f, g = vg_ext(u.reshape(shape))
            return f.detach(), g.detach().reshape(b, n)

    def proj(u):
        return torch.minimum(torch.maximum(u, lb_f), ub_f)

    def pg_res(u, g):                                  # (B,)
        return torch.amax(torch.abs(u - proj(u - g)), dim=1)

    def two_loop(g, s_h, y_h, rho_h, hlen):
        q = g
        alphas = [None] * mem
        for k in range(mem - 1, -1, -1):
            valid = k >= mem - hlen                    # (B,)
            a = torch.where(valid, rho_h[:, k] * _bdot(s_h[:, k], q), zero)
            alphas[k] = a
            q = q - a[:, None] * y_h[:, k]
        sy = _bdot(s_h[:, mem - 1], y_h[:, mem - 1])
        yy = _bdot(y_h[:, mem - 1], y_h[:, mem - 1])
        scale = torch.where((hlen > 0) & (yy > 0.0),
                            sy / torch.clamp(yy, min=1e-30),
                            torch.ones_like(sy))
        r = scale[:, None] * q
        for k in range(mem):
            valid = k >= mem - hlen
            bk = torch.where(valid, rho_h[:, k] * _bdot(y_h[:, k], r), zero)
            r = r + (alphas[k] - bk)[:, None] * s_h[:, k]
        return r

    nm = config.nonmonotone
    noise = config.noise_rel
    eps_scale = (2.0 * noise) if noise > 0.0 else 16.0 * eps

    u = proj(u_init.reshape(b, n))
    f, g = val_and_grad(u)
    g = torch.where(torch.isfinite(g), g, zero)
    fhist = f[:, None].expand(b, max(nm, 1)).clone()
    t_ls = torch.ones((b,), dtype=dt, device=dev)
    s_h = torch.zeros((b, mem, n), dtype=dt, device=dev)
    y_h = torch.zeros_like(s_h)
    rho_h = torch.zeros((b, mem), dtype=dt, device=dev)
    hlen = torch.zeros((b,), dtype=torch.long, device=dev)
    resets = torch.zeros_like(hlen)
    f_best, u_best = f, u
    no_prog = torch.zeros_like(hlen)
    iters_b = torch.zeros_like(hlen)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)

    t = 0
    while t < config.max_iters and not bool(done.all()):
        live = ~done
        # Two-metric projection: the quasi-Newton direction sees only the
        # FREE gradient; bound-active coordinates take plain gradient steps.
        eps_act = 1e-6 * (1.0 + torch.abs(u))
        act = (((u <= lb_f + eps_act) & (g > 0.0))
               | ((u >= ub_f - eps_act) & (g < 0.0)))
        d = -two_loop(torch.where(act, zero, g), s_h, y_h, rho_h, hlen)
        d = torch.where(act, -g, d)
        d = torch.where((_bdot(g, d) < -1e-16)[:, None], d, -g)

        # ONE value_and_grad per iteration, at the candidate: on acceptance its
        # gradient is the next iterate's; on rejection the carried (u, f, g)
        # stay valid.
        c1 = 1e-4
        u_try = proj(u + t_ls[:, None] * d)
        f_try, g_try = val_and_grad(u_try)
        dec = _bdot(g, u_try - u)
        f_acc = f if nm == 0 else torch.amax(fhist, dim=1)
        eps_f = eps_scale * (1.0 + torch.abs(f))
        accepted = ((f_try <= f_acc + c1 * dec + eps_f) & (dec < 0.0)
                    & torch.isfinite(f_try) & live)
        u_new = torch.where(accepted[:, None], u_try, u)
        f_new = torch.where(accepted, f_try, f)
        if nm > 0:
            fhist = torch.where(accepted[:, None],
                                torch.cat([fhist[:, 1:], f_new[:, None]], 1),
                                fhist)
        # Step size: growth capped at 4; rejection backtracks by quadratic
        # interpolation of phi(t) = f(proj(u + t d)), clamped to [0.1, 0.5] t.
        denom = f_try - f - dec
        pos = denom > 0.0
        t_q = torch.where(pos, t_ls * (-0.5 * dec)
                          / torch.where(pos, denom, torch.ones_like(denom)),
                          0.5 * t_ls)
        t_down = torch.minimum(torch.maximum(t_q, 0.1 * t_ls), 0.5 * t_ls)
        t_ls = torch.where(done, t_ls,
                           torch.where(accepted,
                                       torch.clamp(2.0 * t_ls, max=4.0),
                                       t_down))

        g_try = torch.where(torch.isfinite(g_try), g_try, zero)
        g_new = torch.where(accepted[:, None], g_try, g)

        s = u_new - u
        y = g_new - g
        sy = _bdot(s, y)
        # Cosine curvature gate: noise-dominated (s, y) pairs stay out.
        sy_ok = sy > torch.clamp(
            1e-8 * torch.linalg.vector_norm(s, dim=1)
            * torch.linalg.vector_norm(y, dim=1), min=1e-12)
        keep = accepted & sy_ok
        s_h = torch.where(keep[:, None, None],
                          torch.cat([s_h[:, 1:], s[:, None]], 1), s_h)
        y_h = torch.where(keep[:, None, None],
                          torch.cat([y_h[:, 1:], y[:, None]], 1), y_h)
        rho_h = torch.where(
            keep[:, None],
            torch.cat([rho_h[:, 1:], (1.0 / torch.clamp(sy, min=1e-30))[:, None]],
                      1), rho_h)
        hlen = torch.where(keep, torch.clamp(hlen + 1, max=mem), hlen)

        # Step underflow: restart from steepest descent (at most twice); a
        # repeated underflow declares the lane stationary.
        underflow = t_ls < 1e-10
        restart = live & underflow & (resets < 2)
        hlen = torch.where(restart, torch.zeros_like(hlen), hlen)
        t_ls = torch.where(restart, torch.ones_like(t_ls), t_ls)
        resets = torch.where(restart, resets + 1, resets)
        newly_done = (pg_res(u_new, g_new) < config.tol) | (underflow & ~restart)
        if noise > 0.0:
            improved = f_new < f_best - noise * (1.0 + torch.abs(f_best))
            u_best = torch.where((f_new < f_best)[:, None], u_new, u_best)
            f_best = torch.minimum(f_best, f_new)
            no_prog = torch.where(improved, torch.zeros_like(no_prog),
                                  no_prog + 1)
            newly_done = newly_done | (no_prog >= config.progress_window)
        iters_b = torch.where(done, iters_b, torch.full_like(iters_b, t + 1))
        done = done | (newly_done & live)
        u, f, g = u_new, f_new, g_new
        t += 1

    if noise > 0.0:
        # Best-seen iterate; pg_norm belongs to the last iterate.
        return SolveResult(u=u_best.reshape(shape), cost=f_best, iters=iters_b,
                           pg_norm=pg_res(u, g), converged=done)
    return SolveResult(u=u.reshape(shape), cost=f, iters=iters_b,
                       pg_norm=pg_res(u, g), converged=done)


def solve_trajectory(objective: Callable[[torch.Tensor], torch.Tensor],
                     u_init: torch.Tensor, lb, ub,
                     config: SolverConfig = SolverConfig()) -> SolveResult:
    """Minimize objective(u) (u (H, da) -> scalar, differentiable by
    autograd) over the box [lb, ub] (broadcast against u)."""
    if config.method == 'lbfgs':
        return _solve_lbfgs(objective, u_init, lb, ub, config)
    if config.method == 'adam':
        return _solve_adam(objective, u_init, lb, ub, config)
    raise ValueError(f'unknown method {config.method!r}')


def _solve_lbfgs(objective, u_init, lb, ub, config: SolverConfig) -> SolveResult:
    """The lockstep solver at B = 1: the single JAX solve's acceptance, step
    size, history, restarts, stop and result, lane for lane."""
    return first_lane(solve_trajectory_batched(
        lambda u_b: objective(u_b[0])[None], u_init[None], lb, ub, config))


def _solve_adam(objective, u_init, lb, ub, config: SolverConfig) -> SolveResult:
    """Projected Adam, one gradient an iteration, stopped at the projected-
    gradient residual < tol or the cap; then `polish_iters` steps of
    lr 2^(-i/4) g / (max|g| + eps). Non-finite gradients count as 0 in the
    steps; the returned pg_norm reads the final gradient as it is (NaN where
    it is not finite), as JAX's does."""
    dt, dev = u_init.dtype, u_init.device
    lb = torch.as_tensor(lb, dtype=dt, device=dev).broadcast_to(u_init.shape)
    ub = torch.as_tensor(ub, dtype=dt, device=dev).broadcast_to(u_init.shape)
    lr = config.learning_rate

    def proj(u):
        return torch.minimum(torch.maximum(u, lb), ub)

    def grad(u, finite=True):
        u_var = u.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(objective(u_var), u_var)
        if not finite:
            return g
        return torch.where(torch.isfinite(g), g, torch.zeros_like(g))

    def pg_residual(u, g):
        return torch.amax(torch.abs(u - proj(u - g)))

    u = proj(u_init)
    g = grad(u)
    m = torch.zeros_like(u)
    v = torch.zeros_like(u)
    t = 0
    done = False
    while t < config.max_iters and not done:
        m = config.b1 * m + (1.0 - config.b1) * g
        v = config.b2 * v + (1.0 - config.b2) * g * g
        t += 1
        mhat = m / (1.0 - config.b1 ** t)
        vhat = v / (1.0 - config.b2 ** t)
        u = proj(u - lr * mhat / (torch.sqrt(vhat) + config.eps))
        g = grad(u)
        done = bool(pg_residual(u, g) < config.tol)
    for i in range(config.polish_iters):
        gp = grad(u)
        step = lr * 0.5 ** (i / 4.0)
        u = proj(u - step * gp / (torch.amax(torch.abs(gp)) + config.eps))
    with torch.no_grad():
        cost = objective(u)
    return SolveResult(u=u, cost=cost,
                       iters=torch.tensor(t, dtype=torch.int32, device=dev),
                       pg_norm=pg_residual(u, grad(u, finite=False)))
