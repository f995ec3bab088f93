"""Augmented-Lagrangian solver for generally-constrained NLPs (port of
gpmpc_tpu/mpc/constrained.py), held on hs071, the IPOPT test problem the
reference validates its solver layer with.

Problem form:
    minimize    f(u)
    subject to  c_eq(u) = 0,  c_in(u) >= 0,  lb <= u <= ub

Augmented Lagrangian (inequalities in the Rockafellar / Powell-Hestenes
form):
    L_mu(u) = f(u) + lam_eq . c_eq + (mu/2) |c_eq|^2
            + (1/(2 mu)) sum_i [ max(0, lam_in_i - mu c_in_i)^2 - lam_in_i^2 ]

Each outer iteration minimizes L_mu by the single-scenario projected L-BFGS
(mpc/solver.py, any shape of u) from the last iterate, then
    lam_eq <- lam_eq + mu c_eq(u),   lam_in <- max(0, lam_in - mu c_in(u)),
and mu grows by `mu_growth` whenever the violation failed to drop by a
factor of 4. The box stays with the inner projection. The outer loop runs
`outer_iters` times, as JAX's fori_loop does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gpmpc_tpu_torch.mpc.solver import SolverConfig, _solve_lbfgs


class ConstrainedResult(NamedTuple):
    u: torch.Tensor          # solution (same shape as u_init)
    cost: torch.Tensor       # () objective at u (not the AL value)
    eq_viol: torch.Tensor    # () ||c_eq(u)||_inf (0 without equalities)
    ineq_viol: torch.Tensor  # () ||min(c_in(u), 0)||_inf (0 without any)
    lam_eq: torch.Tensor     # final equality multipliers
    lam_in: torch.Tensor     # final inequality multipliers
    mu: torch.Tensor         # final penalty parameter


def solve_constrained(objective: Callable[[torch.Tensor], torch.Tensor],
                      u_init: torch.Tensor, lb, ub,
                      eq_con: Optional[Callable] = None,
                      ineq_con: Optional[Callable] = None,
                      config: SolverConfig = SolverConfig(max_iters=100,
                                                          tol=1e-8),
                      outer_iters: int = 12,
                      mu0: float = 10.0,
                      mu_growth: float = 10.0,
                      mu_max: float = 1e8) -> ConstrainedResult:
    """Minimize `objective` (differentiable by autograd) under equality and
    inequality constraints and a box, on u_init's device and dtype.

    eq_con:   u -> (m_eq,) residuals, feasible iff all zero (or None).
    ineq_con: u -> (m_in,) residuals, feasible iff all >= 0 (or None).
    config:   the inner projected-L-BFGS budget of each outer iteration."""
    dt, dev = u_init.dtype, u_init.device

    def _eq(u):
        return (eq_con(u) if eq_con is not None
                else torch.zeros((0,), dtype=dt, device=dev))

    def _in(u):
        return (ineq_con(u) if ineq_con is not None
                else torch.zeros((0,), dtype=dt, device=dev))

    with torch.no_grad():
        m_eq = _eq(u_init).shape[0]
        m_in = _in(u_init).shape[0]
    zero = torch.zeros((), dtype=dt, device=dev)

    def al(u, lam_eq, lam_in, mu):
        val = objective(u)
        if m_eq:
            c = _eq(u)
            val = val + torch.dot(lam_eq, c) + 0.5 * mu * torch.dot(c, c)
        if m_in:
            t = torch.clamp(lam_in - mu * _in(u), min=0.0)
            val = val + (torch.dot(t, t) - torch.dot(lam_in, lam_in)) / (2.0 * mu)
        return val

    def viol(u):
        v = zero
        if m_eq:
            v = torch.maximum(v, torch.amax(torch.abs(_eq(u))))
        if m_in:
            v = torch.maximum(v, torch.amax(-torch.clamp(_in(u), max=0.0)))
        return v

    u = u_init
    lam_eq = torch.zeros((m_eq,), dtype=dt, device=dev)
    lam_in = torch.zeros((m_in,), dtype=dt, device=dev)
    mu = torch.tensor(mu0, dtype=dt, device=dev)
    prev_v = torch.tensor(float('inf'), dtype=dt, device=dev)
    for _ in range(outer_iters):
        u = _solve_lbfgs(lambda w, le=lam_eq, li=lam_in, m=mu: al(w, le, li, m),
                         u, lb, ub, config).u.detach()
        with torch.no_grad():
            v = viol(u)
            if m_eq:
                lam_eq = lam_eq + mu * _eq(u)
            if m_in:
                lam_in = torch.clamp(lam_in - mu * _in(u), min=0.0)
            # Sufficient-progress test: grow mu only when the violation stalls.
            mu = torch.where(v > 0.25 * prev_v,
                             torch.clamp(mu * mu_growth, max=mu_max), mu)
            prev_v = v

    with torch.no_grad():
        eq_v = torch.amax(torch.abs(_eq(u))) if m_eq else zero
        in_v = torch.amax(-torch.clamp(_in(u), max=0.0)) if m_in else zero
        return ConstrainedResult(u=u, cost=objective(u), eq_viol=eq_v,
                                 ineq_viol=in_v, lam_eq=lam_eq, lam_in=lam_in,
                                 mu=mu)
