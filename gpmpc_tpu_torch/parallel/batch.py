"""Batched GP-MPC solves (port of gpmpc_tpu/parallel/batch.py: `solve_batch`
with its fused and per-scenario routes, the multistart recipes
`solve_batch_multistart` and `solve_batch_multistart_retired`,
`solve_batch_staged`, `solve_batch_sharded`, and `solve_batch_gp` over a
stack of GP draws, `stack_gps`).

The unit of work is one full trajectory optimization. Initial states and
per-lane cost parameters (a gamma sweep, say) fan out over a leading (B,)
axis; the rollout cache is built once and shared by every lane. The
per-scenario routes (`impl='vmap'`, any solver method and nominal models,
and `solve_batch_gp`, whose lanes each carry their own GP) are one lockstep
solve over all B lanes (mpc/solver.py's `solve_trajectory_batched`, by the
configured method) of `lanes_objective`,
the single-scenario rollout mapped over the lanes (dynamics.rollout_lanes),
as JAX's vmap of one solve is: each lane has its own line search (or Adam
moments), history and stop, and the variance runs no kernel (a lane's own
b_lam is nothing the shared-cache trace kernels serve). On CUDA the solve
is a kept program, as the fused route's, whose loop runs on the device
(mpc/solver.py `loop_form()`): a solve reads nothing on the host until its
caller reads the result.
`solve_batch_sharded` splits the lanes over the batch axis of a process mesh
(parallel/mesh.py): each rank solves its lanes against the replicated GP with
no collective inside the solve, and the results are gathered.

The multistart drivers keep their state (u, cost, iters, pg_norm, converged)
as tensors on the GP's device and do their gathers, scatters and sorts there;
they read a count to the host only where they branch on it: between their
phases' solves, never inside one. Every scatter
writes each lane once: chunks padded with a repeated lane are cut back to
their real lanes before the write. Work that needs no gradient runs under
`torch.no_grad()`; the solver turns autograd on for its own value-and-grad.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gpmpc_tpu_torch.device import ensure_true_f32
from gpmpc_tpu_torch.dynamics import (CACHE_TENSORS, RolloutCache,
                                      build_rollout_cache, cache_from,
                                      rollout_batched, rollout_lanes)
from gpmpc_tpu_torch.gp.state import GPState
from gpmpc_tpu_torch.mpc.cost import (CostParams, is_lane_leaf,
                                      params_from, params_key, params_tensors,
                                      risk_sensitive_cost)
from gpmpc_tpu_torch.mpc.solver import (Objective, SolverConfig, SolveResult,
                                        solve_trajectory_batched)
from gpmpc_tpu_torch.parallel.mesh import BATCH_AXIS, gather_lanes, lane_slice


def batch_objective(cache: RolloutCache, x0s: torch.Tensor,
                    params: CostParams, delta: bool = False,
                    full_cov: bool = False, mean_only: bool = False,
                    frozen_cov_diag: Optional[torch.Tensor] = None,
                    action_var: float = 1e-3,
                    init_state_var: float = 1e-3) -> Objective:
    """The per-lane objective J: (B, H, da) -> (B,), the uncertain rollout
    from x0s followed by the risk-sensitive cost. mean_only and
    frozen_cov_diag (B, H+1, ds) give the multistart recipe's cheap
    surrogates; action_var and init_state_var are the rollout's
    (dynamics.rollout_batched).

    An `Objective` (mpc/solver.py): its key holds the Python values the
    rollout and the cost read (the cache's dims, tied lengthscales and
    nominal model, the flags, the two variances, which cost leaves are
    None); its inputs are the rollout cache's tensors, x0s, frozen_cov_diag
    and the cost leaves, so a solve keeps its captured program and reuses
    it for later calls with other values. Called on u, it evaluates J."""
    static, p_key = cache.static_key(), params_key(params)
    n_c = len(CACHE_TENSORS)

    def build(*inputs):
        c = cache_from(static, inputs[:n_c])
        x0, cov_d = inputs[n_c:n_c + 2]
        p = params_from(p_key, inputs[n_c + 2:])

        def objective_b(u):
            means, covs = rollout_batched(
                c, x0, u, init_state_var=init_state_var,
                action_var=action_var, delta=delta, full_cov=full_cov,
                mean_only=mean_only, frozen_cov_diag=cov_d)
            return risk_sensitive_cost(p, means, covs, u)
        return objective_b

    key = ('batch_objective', static, delta, full_cov, mean_only,
           frozen_cov_diag is not None, action_var, init_state_var, p_key)
    return Objective(key, (*cache.tensors(), x0s, frozen_cov_diag,
                           *params_tensors(params, x0s.device)), build)


def _check_device(gp: GPState, x0s: torch.Tensor) -> None:
    """x0s on the GP's device, TF32 off."""
    if x0s.device != gp.x.device:
        raise ValueError(f'x0s lies on {x0s.device}, the GP on {gp.x.device}')
    ensure_true_f32()


def _setup(gp: GPState, x0s: torch.Tensor, state_dim: int,
           action_dim: int) -> RolloutCache:
    """The checks every batch solve makes (_check_device) and the
    rollout cache. A cache of one GP a lane (gp stacked) keeps its b_lam
    at the width the fit stored it: K1's grouped form reads each lane's
    slab at that width and widens it where it multiplies (no f64 copy)."""
    _check_device(gp, x0s)
    return build_rollout_cache(gp, state_dim, action_dim)


def lanes_objective(cache: RolloutCache, x0s: torch.Tensor,
                    params: CostParams, delta: bool = False,
                    full_cov: bool = False) -> Objective:
    """The per-lane objective J: (B, H, da) -> (B,) of the per-scenario
    routes: the single-scenario rollout of every lane from x0s
    (dynamics.rollout_lanes; any covariance, delta or nominal model, a
    shared cache or one GP a lane), then the risk-sensitive cost, whose
    per-lane leaves follow the rank rule (a per-lane gamma is a (B,) leaf).
    At B = 1 it is the objective of one single-scenario solve (the
    controller's route (c), the device episode).

    An `Objective` (mpc/solver.py): its key holds the cache's static key,
    delta, full_cov and which cost leaves are None; its inputs are the
    cache's tensors (stacked for one GP a lane: the inputs' shapes in the
    program key tell the two caches apart), x0s and the cost leaves, so a
    solve keeps its captured program and reuses it for later calls with
    other values. A nominal model is captured with the rest: one that reads
    a value on the host raises (under vmap, and in a capture); it never
    falls back to an eager loop."""
    static, p_key = cache.static_key(), params_key(params)
    n_c = len(CACHE_TENSORS)

    def build(*inputs):
        c = cache_from(static, inputs[:n_c])
        x0 = inputs[n_c]
        p = params_from(p_key, inputs[n_c + 1:])

        def objective_b(u):
            means, covs = rollout_lanes(c, x0, u, full_cov=full_cov,
                                        delta=delta)
            return risk_sensitive_cost(p, means, covs, u)
        return objective_b

    key = ('lanes_objective', static, delta, full_cov, p_key)
    return Objective(key, (*cache.tensors(), x0s,
                           *params_tensors(params, x0s.device)), build)


def solve_batch(gp: GPState, state_dim: int, action_dim: int,
                x0s: torch.Tensor,               # (B, ds)
                params: CostParams,              # gamma may be (B,)
                horizon: int, lb, ub,
                solver: SolverConfig = SolverConfig(),
                u_init: Optional[torch.Tensor] = None,   # (B, H, da)
                full_cov: bool = False,
                delta: bool = False,
                impl: str = 'auto') -> SolveResult:
    """B independent solves against one shared GP posterior, on the GP's
    device.

    impl: 'fused' runs the explicitly-batched rollout and the lockstep
    L-BFGS (the production path, through the variance-trace kernels);
    'vmap' runs one lockstep solve of every lane's single-scenario rollout
    (`lanes_objective`, by config.method: the oracle twin; any method,
    nominal models); 'auto' picks 'fused' for L-BFGS without a nominal
    model and 'vmap' otherwise. 'fused' with a method other than L-BFGS
    raises ValueError.

    On CUDA both routes run as kept programs (mpc/solver.py,
    `_run_graphed`): iterations after the first run one captured CUDA
    graph under the device loop's WHILE node, with a diagonal or a full
    covariance (whose PSD clip runs the sync-free eigensolver of
    ops/kernels/eigh_small.py), as do the multistart recipes and
    `solve_batch_staged` below."""
    if impl not in ('auto', 'fused', 'vmap'):
        raise ValueError(f'unknown impl {impl!r}')
    if impl == 'fused' and solver.method != 'lbfgs':
        raise ValueError(
            "impl='fused' runs under the lockstep L-BFGS solver; it cannot "
            f"honor solver.method={solver.method!r}. Use impl='vmap' (or "
            "'auto').")
    cache = _setup(gp, x0s, state_dim, action_dim)
    b = x0s.shape[0]
    if u_init is None:
        u_init = x0s.new_zeros((b, horizon, action_dim))
    if impl == 'auto':
        impl = ('fused' if solver.method == 'lbfgs' and cache.nominal_fn is None
                else 'vmap')

    if impl == 'fused':
        return solve_trajectory_batched(
            batch_objective(cache, x0s, params, delta, full_cov), u_init, lb,
            ub, solver)
    return solve_trajectory_batched(
        lanes_objective(cache, x0s, params, delta, full_cov), u_init, lb, ub,
        solver)


def _map_lane_leaves(params: CostParams, fn) -> CostParams:
    """`fn` applied to the per-lane leaves (cost.is_lane_leaf, the rank
    rule); shared leaves as they are."""
    return CostParams(**{name: fn(name, v) if is_lane_leaf(name, v) else v
                         for name, v in params._asdict().items()})


def shard_params(params: CostParams, lanes: slice, b: int) -> CostParams:
    """The per-lane leaves (cost.is_lane_leaf) cut to `lanes`; shared leaves
    as they are."""
    def cut(name, v):
        if v.shape[0] != b:
            raise ValueError(f'cost parameter {name} has {v.shape[0]} lanes, '
                             f'the batch {b}')
        return v[lanes]

    return _map_lane_leaves(params, cut)


def _tile_params(params: CostParams, k: int) -> CostParams:
    """The per-lane leaves repeated k times along the lane axis, for a batch
    of k stacked copies of the B lanes (jnp.tile); shared leaves pass
    through."""
    return _map_lane_leaves(
        params, lambda _, v: v.repeat(k, *([1] * (v.ndim - 1))))


def _gather_params(params: CostParams, idx) -> CostParams:
    """The per-lane leaves gathered at lanes `idx`; shared leaves pass
    through."""
    return _map_lane_leaves(params, lambda _, v: v[idx])


class _Fan(NamedTuple):
    """How k candidates of each of b lanes lie in one batch of k b
    scenarios: start-major (candidate c of lane l at c b + l; a shared
    GP), or lane-major (at l k + c; one GP a lane, whose rollout maps the
    lanes and whose K1 groups are a lane's candidates:
    dynamics.rollout_batched)."""
    b: int
    lane_major: bool

    def x0s(self, x0s, k):
        return x0s.repeat_interleave(k, 0) if self.lane_major else x0s.repeat(
            k, 1)

    def params(self, params, k):
        if self.lane_major:
            return _map_lane_leaves(params,
                                    lambda _, v: v.repeat_interleave(k, 0))
        return _tile_params(params, k)

    def split(self, v, k):
        """v (k b, ...) as (k, b, ...)."""
        if self.lane_major:
            return v.reshape(self.b, k, *v.shape[1:]).transpose(0, 1)
        return v.reshape(k, self.b, *v.shape[1:])

    def join(self, v):
        """v (k, b, ...) as (k b, ...)."""
        if self.lane_major:
            v = v.transpose(0, 1)
        return v.reshape(-1, *v.shape[2:])


def _finite(j: torch.Tensor) -> torch.Tensor:
    """Non-finite scores as +inf, so that any finite candidate beats them."""
    return torch.where(torch.isfinite(j), j, torch.full_like(j, np.inf))


def _cov_diag(cache, x0s, u, delta) -> torch.Tensor:
    """The state variances (B, H+1, ds) of a full rollout of u, detached:
    the covariance trajectory that a frozen-covariance objective holds."""
    _, covs = rollout_batched(cache, x0s, u, delta=delta)
    return torch.diagonal(covs, dim1=2, dim2=3).detach()


def _pad(idx: torch.Tensor, m: int) -> torch.Tensor:
    """idx (n,) padded to a multiple of m by repeating idx[0]."""
    return torch.cat([idx, idx[:1].expand((-idx.numel()) % m)])


def _continue_tail(res1: SolveResult, todo: torch.Tensor, chunk: int,
                   budget1: int, refine) -> SolveResult:
    """res1 with its lanes `todo` continued in chunks of `chunk` lanes
    (padded with todo[0]) by refine(idx) -> SolveResult of lanes idx; a
    continued lane's iters become budget1 + its chunk's own."""
    u, cost, iters, pg, conv = (t.clone() for t in res1)
    n_todo = todo.numel()
    todo_p = _pad(todo, chunk)
    for c0 in range(0, n_todo, chunk):
        idx = todo_p[c0:c0 + chunk]
        res2 = refine(idx)
        w, n = idx[:n_todo - c0], min(chunk, n_todo - c0)
        u[w], cost[w], pg[w], conv[w] = (t[:n] for t in (
            res2.u, res2.cost, res2.pg_norm, res2.converged))
        iters[w] = budget1 + res2.iters[:n]
    return SolveResult(u=u, cost=cost, iters=iters, pg_norm=pg,
                       converged=conv)


def _accept(u, cost, lanes, u_new, j_new) -> torch.Tensor:
    """Write u_new, j_new into the distinct `lanes` of u, cost where j_new
    is strictly lower; returns the number of lanes improved (a tensor)."""
    improve = j_new < cost[lanes]
    u[lanes] = torch.where(improve[:, None, None], u_new, u[lanes])
    cost[lanes] = torch.where(improve, j_new, cost[lanes])
    return improve.sum()


def _shift_u_batch(u: torch.Tensor, kk: int) -> torch.Tensor:
    """Whole-profile time shift of (..., H, da) trajectories: kk > 0 delays
    (first action repeated), kk < 0 advances (last action held)."""
    h = u.shape[-2]
    if kk > 0:
        return torch.cat([u[..., :1, :].expand(*u.shape[:-2], kk, u.shape[-1]),
                          u[..., :h - kk, :]], dim=-2)
    kk = -kk
    return torch.cat([u[..., kk:, :],
                      u[..., -1:, :].expand(*u.shape[:-2], kk, u.shape[-1])],
                     dim=-2)


def _box(lb, ub, horizon, action_dim, dtype, device):
    """lb, ub broadcast to (H, da) tensors."""
    return tuple(torch.as_tensor(v, dtype=dtype, device=device).broadcast_to(
        (horizon, action_dim)) for v in (lb, ub))


def _refine_frozen(cache, x0s, params, u0, lb, ub, solver, rounds, delta):
    """`rounds` cycles of [one full rollout to capture the covariance
    trajectory -> `solver` iterations on the frozen-covariance objective]."""
    for _ in range(rounds):
        cov_d = _cov_diag(cache, x0s, u0, delta)
        u0 = solve_trajectory_batched(
            batch_objective(cache, x0s, params, delta, frozen_cov_diag=cov_d),
            u0, lb, ub, solver).u
    return u0


def _multistart_starts(x0s: torch.Tensor, horizon: int, action_dim: int,
                       lb, ub, n_starts: int, n_zero_starts: int,
                       zero_jitter: float, start_scale: float, seed: int,
                       extra_starts=None) -> torch.Tensor:
    """The start set (K, B, H, da) of the multistart recipe, as the JAX
    package composes it: u = 0 (the cold start), then
    min(n_zero_starts, n_starts - 1) jittered zeros (zero_jitter x half the
    box x normal draws), then the rest of the n_starts as wide draws
    (uniform over start_scale of the box about its middle), then
    `extra_starts` (E, B, H, da). The draws come from a torch.Generator on
    x0s's device seeded by `seed`; they cannot match jax.random's bit for
    bit, only its counts and distributions."""
    b = x0s.shape[0]
    dt, dev = x0s.dtype, x0s.device
    lo, hi = _box(lb, ub, horizon, action_dim, dt, dev)
    mid, span = 0.5 * (lo + hi), 0.5 * (hi - lo)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = (b, horizon, action_dim)
    n_zero = min(n_zero_starts, n_starts - 1)
    parts = [x0s.new_zeros((1,) + shape)]
    if n_zero > 0:
        parts.append(zero_jitter * span * torch.randn(
            (n_zero,) + shape, generator=gen, dtype=dt, device=dev))
    n_wide = n_starts - 1 - n_zero
    if n_wide > 0:
        draws = 2.0 * torch.rand((n_wide,) + shape, generator=gen, dtype=dt,
                                 device=dev) - 1.0
        parts.append(mid + start_scale * span * draws)
    if extra_starts is not None:
        parts.append(torch.as_tensor(extra_starts, dtype=dt,
                                     device=dev).reshape((-1,) + shape))
    return torch.cat(parts)


@torch.no_grad()
def _multistart_phase0(cache: RolloutCache, x0s: torch.Tensor,
                       params: CostParams, horizon: int, action_dim: int,
                       lb, ub, surrogate: SolverConfig, surrogate_mode: str,
                       frozen_rounds: int, start_scale: float, seed: int,
                       delta: bool, n_zero_starts: int, zero_jitter: float,
                       prune_to: int, extra_starts, n_starts: int
                       ) -> torch.Tensor:
    """Global (basin-selection) phase of the multistart recipe: build the
    start set (`_multistart_starts`), surrogate-descend every candidate,
    optionally prune, score the survivors under the FULL objective
    (finite-guarded), and return the per-lane winner u0 (B, H, da).

    surrogate_mode 'mean' descends the mean-only rollout once; 'frozen'
    runs `frozen_rounds` cycles of one full rollout (the covariance
    trajectory, detached) and `surrogate` iterations on the frozen-covariance
    objective. With prune_to, after round 0 only the prune_to best
    candidates of each lane by surrogate cost go on."""
    if surrogate_mode not in ('mean', 'frozen'):
        raise ValueError(f'unknown surrogate_mode {surrogate_mode!r}')
    b = x0s.shape[0]
    dev = x0s.device
    shape = (b, horizon, action_dim)
    fan = _Fan(b, cache.x.ndim == 3)
    if fan.lane_major:
        # JAX's vmap of a one-lane call: every lane draws the starts of one
        # lane, the same draws for all, then its own extra starts.
        starts = _multistart_starts(x0s[:1], horizon, action_dim, lb, ub,
                                    n_starts, n_zero_starts, zero_jitter,
                                    start_scale, seed).expand(-1, b, -1, -1)
        if extra_starts is not None:
            starts = torch.cat([starts, torch.as_tensor(
                extra_starts, dtype=x0s.dtype, device=dev).reshape(
                    (-1,) + shape)])
    else:
        starts = _multistart_starts(x0s, horizon, action_dim, lb, ub,
                                    n_starts, n_zero_starts, zero_jitter,
                                    start_scale, seed, extra_starts)
    k = starts.shape[0]                                       # (K, B, H, da)
    lanes = torch.arange(b, device=dev)

    u_cand = fan.join(starts)
    k_live = k
    if surrogate_mode == 'mean':
        u_cand = solve_trajectory_batched(
            batch_objective(cache, fan.x0s(x0s, k), fan.params(params, k),
                            delta, mean_only=True), u_cand, lb, ub,
            surrogate).u
    for rnd in range(frozen_rounds if surrogate_mode == 'frozen' else 0):
        x0s_r, params_r = fan.x0s(x0s, k_live), fan.params(params, k_live)
        cov_d = _cov_diag(cache, x0s_r, u_cand, delta)
        res_f = solve_trajectory_batched(
            batch_objective(cache, x0s_r, params_r, delta,
                            frozen_cov_diag=cov_d), u_cand, lb, ub, surrogate)
        u_cand = res_f.u
        # Pruning after the first round: the surrogate's own costs rank the
        # starts; only the top prune_to pay the later rounds and the score.
        if rnd == 0 and prune_to and prune_to < k_live and frozen_rounds > 1:
            j_f = fan.split(_finite(res_f.cost), k_live)
            order = torch.argsort(j_f, dim=0, stable=True)[:prune_to]
            u_cand = fan.join(fan.split(u_cand, k_live)[order, lanes])
            k_live = prune_to
    j_full = batch_objective(cache, fan.x0s(x0s, k_live),
                             fan.params(params, k_live), delta)(u_cand)
    best = torch.argmin(fan.split(_finite(j_full), k_live), dim=0)
    return fan.split(u_cand, k_live)[best, lanes]


@torch.no_grad()
def solve_batch_multistart(gp: GPState, state_dim: int, action_dim: int,
                           x0s: torch.Tensor, params: CostParams,
                           horizon: int, lb, ub,
                           solver: SolverConfig = SolverConfig(),
                           n_starts: int = 4,
                           surrogate: Optional[SolverConfig] = None,
                           surrogate_mode: str = 'frozen',
                           frozen_rounds: int = 3,
                           start_scale: float = 0.6,
                           seed: int = 0,
                           delta: bool = False,
                           refine_frozen_rounds: int = 0,
                           refine_frozen_iters: int = 12,
                           n_zero_starts: int = 0,
                           zero_jitter: float = 0.02,
                           shift_set: tuple = (),
                           shift_iters: int = 40,
                           shift_prune: int = 0,
                           shift_prune_frozen_iters: int = 0,
                           prune_to: int = 0,
                           extra_starts=None) -> SolveResult:
    """Two-phase global-then-local batched solve: phase 0
    (`_multistart_phase0`) picks each lane's basin from n_starts starts on a
    cheap surrogate, optional frozen-covariance pre-refinement rounds
    (`refine_frozen_*`) polish the winner, and `solver` refines it on the
    full objective.

    shift_set: the refined incumbent and its whole-profile time shifts are
    refined `shift_iters` full iterations in lockstep and each lane keeps
    the best. shift_prune > 0 first scores the raw shifts (after
    `shift_prune_frozen_iters` frozen-covariance iterations, if > 0) by one
    full forward and refines only the top shift_prune of each lane. The
    pre-shift incumbent joins the final choice and wins ties.

    gp may be stacked over the B lanes (stack_gps), one GP a lane, as JAX's
    vmap of a one-lane call: every lane then starts from the starts one
    lane draws (the same for all), followed by its own extra_starts, and
    its candidates lie lane-major, so that the rollout's grouped K1 serves
    each lane's candidates with its own b_lam (dynamics.rollout_batched).
    Tied lengthscales and a diagonal covariance there."""
    cache = _setup(gp, x0s, state_dim, action_dim)
    b = x0s.shape[0]
    if surrogate is None:
        surrogate = solver.replace(
            max_iters=(16 if surrogate_mode == 'frozen' else 80), tol=1e-3)
    u0 = _multistart_phase0(cache, x0s, params, horizon, action_dim, lb, ub,
                            surrogate, surrogate_mode, frozen_rounds,
                            start_scale, seed, delta, n_zero_starts,
                            zero_jitter, prune_to, extra_starts, n_starts)
    u0 = _refine_frozen(cache, x0s, params, u0, lb, ub,
                        solver.replace(max_iters=refine_frozen_iters),
                        refine_frozen_rounds, delta)
    res = solve_trajectory_batched(batch_objective(cache, x0s, params, delta),
                                   u0, lb, ub, solver)
    if not shift_set:
        return res

    lanes = torch.arange(b, device=x0s.device)
    fan = _Fan(b, cache.x.ndim == 3)
    ks = 1 + len(shift_set)
    u_sh = fan.join(torch.stack([res.u] + [_shift_u_batch(res.u, kk)
                                           for kk in shift_set]))
    if shift_prune and shift_prune < ks:
        x0s_s, params_s = fan.x0s(x0s, ks), fan.params(params, ks)
        if shift_prune_frozen_iters > 0:
            u_sh = _refine_frozen(
                cache, x0s_s, params_s, u_sh, lb, ub,
                solver.replace(max_iters=shift_prune_frozen_iters), 1, delta)
        j_pre = _finite(batch_objective(cache, x0s_s, params_s, delta)(u_sh))
        order = torch.argsort(fan.split(j_pre, ks), dim=0,
                              stable=True)[:shift_prune]
        u_sh = fan.join(fan.split(u_sh, ks)[order, lanes])
        ks = shift_prune
    res_s = solve_trajectory_batched(
        batch_objective(cache, fan.x0s(x0s, ks), fan.params(params, ks),
                        delta),
        u_sh, lb, ub, solver.replace(max_iters=shift_iters))
    best_s = torch.argmin(fan.split(_finite(res_s.cost), ks), dim=0)

    def pick(v):
        return fan.split(v, ks)[best_s, lanes]

    j_shift = pick(res_s.cost)
    use_inc = _finite(res.cost) <= _finite(j_shift)

    def sel(a, bv):
        return torch.where(use_inc.reshape((b,) + (1,) * (a.ndim - 1)), a, bv)

    return SolveResult(u=sel(res.u, pick(res_s.u)),
                       cost=sel(res.cost, j_shift),
                       iters=res.iters + pick(res_s.iters),
                       pg_norm=sel(res.pg_norm, pick(res_s.pg_norm)),
                       converged=sel(res.converged, pick(res_s.converged)))


@torch.no_grad()
def _retired_phase_a(cache: RolloutCache, x0s, params, lb, ub, extra_starts,
                     solver1: SolverConfig, surrogate: SolverConfig,
                     start_scale, zero_jitter, action_dim: int, horizon: int,
                     surrogate_mode: str, frozen_rounds: int, n_starts: int,
                     prune_to: int, n_zero_starts: int, delta: bool,
                     seed: int, refine_frozen_rounds: int = 0,
                     refine_frozen_iters: int = 16) -> SolveResult:
    """Program A of the retired recipe: phase-0 basin selection, optional
    frozen-covariance pre-refinement rounds and the first
    `solver1.max_iters` full-objective iterations, all at full width B."""
    u0 = _multistart_phase0(cache, x0s, params, horizon, action_dim, lb, ub,
                            surrogate, surrogate_mode, frozen_rounds,
                            start_scale, seed, delta, n_zero_starts,
                            zero_jitter, prune_to, extra_starts, n_starts)
    u0 = _refine_frozen(cache, x0s, params, u0, lb, ub,
                        solver1.replace(max_iters=refine_frozen_iters),
                        refine_frozen_rounds, delta)
    return solve_trajectory_batched(batch_objective(cache, x0s, params, delta),
                                    u0, lb, ub, solver1)


@torch.no_grad()
def _refine_chunk(cache: RolloutCache, x0s_c, params_c, u_init_c, lb, ub,
                  solver_c: SolverConfig, delta: bool) -> SolveResult:
    """Warm-started full-objective refinement of a compacted lane chunk
    (programs B and D of the retired recipe, and its rescue and polish)."""
    return solve_trajectory_batched(
        batch_objective(cache, x0s_c, params_c, delta), u_init_c, lb, ub,
        solver_c)


def _candidates(u_inc, shift_set, extra_cands):
    """The incumbent (index 0), its time shifts and the extra candidates
    (Ke, B, H, da), stacked to (Ks * B, H, da); and Ks."""
    parts = [u_inc] + [_shift_u_batch(u_inc, kk) for kk in shift_set]
    if extra_cands is not None:
        parts.extend(extra_cands.unbind(0))
    return torch.cat(parts), len(parts)


@torch.no_grad()
def _frozen_pre_score(cache: RolloutCache, x0s, params, u_inc, delta: bool,
                      shift_set: tuple, extra_cands=None):
    """Program C0 of the retired recipe (the pre-gate): the candidates of
    `_shift_score`, raw, scored forward-only on the frozen-covariance
    objective, every candidate borrowing its lane incumbent's covariance
    trajectory (one full rollout at width B). Index 0's score is exact.

    Returns (u_cands (Ks, B, H, da), scores (Ks, B), finite-guarded)."""
    b = u_inc.shape[0]
    u_c, ks = _candidates(u_inc, shift_set, extra_cands)
    cov_t = _cov_diag(cache, x0s, u_inc, delta).repeat(ks, 1, 1)
    j = batch_objective(cache, x0s.repeat(ks, 1), _tile_params(params, ks),
                        delta, frozen_cov_diag=cov_t)(u_c)
    return u_c.reshape((ks,) + u_inc.shape), _finite(j).reshape(ks, b)


@torch.no_grad()
def _shift_score(cache: RolloutCache, x0s, params, u_inc, lb, ub,
                 smooth_solver: SolverConfig, delta: bool, shift_set: tuple,
                 smooth_iters: int, extra_cands=None):
    """Program C of the retired recipe: the incumbent's time shifts and the
    extra candidates (Ke, B, H, da), their seams smoothed by `smooth_iters`
    frozen-covariance iterations, all scored on the full objective.

    Returns (u_sh (Ks, B, H, da) with the incumbent at index 0, j_pre
    (Ks, B) finite-guarded full-objective scores)."""
    b = u_inc.shape[0]
    u_sh, ks = _candidates(u_inc, shift_set, extra_cands)
    x0s_s, params_s = x0s.repeat(ks, 1), _tile_params(params, ks)
    if smooth_iters > 0:
        u_sh = _refine_frozen(cache, x0s_s, params_s, u_sh, lb, ub,
                              smooth_solver.replace(max_iters=smooth_iters),
                              1, delta)
    j_pre = batch_objective(cache, x0s_s, params_s, delta)(u_sh)
    return u_sh.reshape((ks,) + u_inc.shape), _finite(j_pre).reshape(ks, b)


def _neighbours(x0s, params: CostParams, m: int) -> torch.Tensor:
    """(B, min(m, B - 1)) nearest other lanes of each lane in z-scored
    (x0, gamma) space (gamma when it is per-lane), in f64."""
    f = x0s.to(torch.float64)
    if is_lane_leaf('gamma', params.gamma):
        f = torch.cat([f, params.gamma.to(torch.float64)[:, None]], dim=1)
    f = (f - f.mean(0)) / (f.std(0, unbiased=False) + 1e-12)
    d2 = ((f[:, None] - f[None]) ** 2).sum(-1)
    d2.fill_diagonal_(np.inf)
    return torch.argsort(d2, dim=1, stable=True)[:, :min(m, f.shape[0] - 1)]


def _median(v: torch.Tensor) -> torch.Tensor:
    """np.median over the last axis: the mean of the two middle values of an
    even count."""
    s = torch.sort(v, dim=-1).values
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def _rescue_draws(seed, lb, ub, scale, n_starts, n_r, horizon, action_dim,
                  dtype) -> np.ndarray:
    """The rescue phase's wide draws (n_starts, n_r, H, da), made on the
    host exactly as the JAX package makes them (numpy's default_rng(seed +
    7919), its dtype promotions), so that they match bit for bit."""
    dt_np = torch.empty((), dtype=dtype).numpy().dtype
    host = [v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for v in (lb, ub)]
    lo, hi = (np.broadcast_to(np.asarray(v, dt_np), (horizon, action_dim))
              for v in host)
    mid, span = 0.5 * (lo + hi), 0.5 * (hi - lo)
    rng = np.random.default_rng(seed + 7919)
    return (mid + scale * span * rng.uniform(
        -1.0, 1.0, (n_starts, n_r, horizon, action_dim))).astype(dt_np)


@torch.no_grad()
def solve_batch_multistart_retired(
        gp: GPState, state_dim: int, action_dim: int,
        x0s: torch.Tensor, params: CostParams, horizon: int,
        lb, ub,
        solver: SolverConfig = SolverConfig(),
        n_starts: int = 8,
        prune_to: int = 4,
        surrogate: Optional[SolverConfig] = None,
        surrogate_mode: str = 'frozen',
        frozen_rounds: int = 3,
        start_scale: float = 0.6,
        seed: int = 0,
        delta: bool = False,
        n_zero_starts: int = 0,
        zero_jitter: float = 0.02,
        extra_starts=None,
        budget1: int = 24,
        tail_divisor: int = 4,
        shift_set: tuple = (1, -1, 2, -2),
        shift_iters: int = 32,
        shift_top: int = 2,
        shift_smooth_iters: int = 8,
        shift_margin: float = 0.005,
        shift_lanes_per_chunk: Optional[int] = None,
        shift_rounds: int = 1,
        shift_max_lanes: Optional[int] = None,
        neighbor_set: int = 0,
        neighbor_shifted: int = 0,
        propose_smoothed: bool = False,
        polish_lanes: int = 0,
        polish_iters: int = 96,
        refine_frozen_rounds: int = 0,
        refine_frozen_iters: int = 16,
        pregate: bool = True,
        prefilter: int = 4,
        rescue_lanes: int = 0,
        rescue_starts: int = 6,
        rescue_iters: int = 48,
        rescue_scale: float = 0.9,
        diag: Optional[dict] = None) -> SolveResult:
    """The multistart production recipe with converged-lane retirement.

      A. phase-0 basin selection + `budget1` full-objective iterations at
         full width B (`_retired_phase_a`);
      B. lanes not converged after budget1 continue, gathered into chunks
         of max(1, B // tail_divisor) lanes (padded with the first such
         lane), warm-started with fresh L-BFGS memory up to
         `solver.max_iters`;
      C. each lane's proposals: time shifts of its incumbent, the incumbents
         of its `neighbor_set` nearest lanes in z-scored (x0, gamma) space,
         the nearest `neighbor_shifted` of those shifted by +-1 step, and
         (`propose_smoothed`) its 3-tap smoothed incumbent, seam-smoothed by
         `shift_smooth_iters` frozen iterations and scored on the full
         objective (`_shift_score`); with `pregate`, first cut to the
         `prefilter` best of each lane by raw frozen scores
         (`_frozen_pre_score`);
      D. lanes where a proposal scores within `shift_margin` (relative to
         1 + |cost|) of the incumbent, from round 1 on only lanes whose own
         or a neighbour's incumbent moved last round, at most
         `shift_max_lanes` of them ranked by predicted gain, refine their
         `shift_top` best candidates `shift_iters` iterations in chunks.
         C and D repeat up to `shift_rounds` times and stop early when no
         lane improves;
      then `rescue_lanes` neighbourhood-cost outliers refine fresh wide draws
      (numpy's default_rng(seed + 7919), as in the JAX package), u = 0, the
      incumbent and the best two neighbours' incumbents; and the
      `polish_lanes` lanes with the largest projected gradient (unconverged
      first) get `polish_iters` more iterations.

    A lane's result is never worse than its phase-A/B incumbent: later
    phases replace it only on strict improvement. `diag`, if given,
    receives n_tail, n_shift_worthy, n_shift_worthy_r{r}, n_rescue and
    n_polish. iters: phase B sets budget1 + its own; D and rescue add the
    most any of a lane's candidates took; polish adds its own.

    Where the JAX package's driver has faults, this one does not copy them:
    pregate with prefilter < 1 raises ValueError here (an empty minimum
    there); a rescue lane padded with repeats of itself keeps the best of
    all its candidates (the last improving repeat wins there); and a padded
    lane is refined and counted once, never again in a later chunk."""
    if pregate and prefilter < 1:
        raise ValueError(f'pregate needs prefilter >= 1, got {prefilter}')
    cache = _setup(gp, x0s, state_dim, action_dim)
    b = x0s.shape[0]
    dev = x0s.device
    if surrogate is None:
        surrogate = solver.replace(
            max_iters=(16 if surrogate_mode == 'frozen' else 80), tol=1e-3)
    budget1 = min(budget1, solver.max_iters)

    res1 = _retired_phase_a(
        cache, x0s, params, lb, ub, extra_starts,
        solver.replace(max_iters=budget1), surrogate, start_scale,
        zero_jitter, action_dim, horizon, surrogate_mode, frozen_rounds,
        n_starts, prune_to, n_zero_starts, delta, seed, refine_frozen_rounds,
        refine_frozen_iters)

    def refine(idx, u_init, cfg):
        return _refine_chunk(cache, x0s[idx], _gather_params(params, idx),
                             u_init, lb, ub, cfg, delta)

    # B: compacted continuation of the unconverged tail.
    chunk = max(1, b // tail_divisor)
    todo = torch.nonzero(~res1.converged).flatten()
    if diag is not None:
        diag['n_tail'] = todo.numel()
    res = res1
    if todo.numel() and solver.max_iters > budget1:
        solver2 = solver.replace(max_iters=solver.max_iters - budget1)
        res = _continue_tail(res1, todo, chunk, budget1,
                             lambda idx: refine(idx, res1.u[idx], solver2))
    u, cost, iters, pg, conv = (t.clone() for t in res)

    nbr_idx = (_neighbours(x0s, params, neighbor_set)
               if neighbor_set > 0 and b > 1 else None)

    def proposals(u_now):
        """(Ke, B, H, da) extra candidates, or None."""
        parts = []
        if nbr_idx is not None:
            u_nbr = u_now[nbr_idx.T]                          # (M, B, H, da)
            parts.append(u_nbr)
            for m in range(min(neighbor_shifted, u_nbr.shape[0])):
                parts += [_shift_u_batch(u_nbr[m:m + 1], 1),
                          _shift_u_batch(u_nbr[m:m + 1], -1)]
        if propose_smoothed:
            pad = torch.cat([u_now[:, :1], u_now, u_now[:, -1:]], dim=1)
            parts.append(((pad[:, :-2] + pad[:, 1:-1] + pad[:, 2:]) / 3.0)[None])
        return torch.cat(parts) if parts else None

    n_extra = int(propose_smoothed)
    if nbr_idx is not None:
        n_extra += nbr_idx.shape[1] + 2 * min(neighbor_shifted,
                                              nbr_idx.shape[1])
    # With no proposal beyond the incumbent there is nothing to exchange.
    do_exchange = len(shift_set) + n_extra > 0
    shift_top = min(shift_top, 1 + len(shift_set) + n_extra)
    lanes_per_chunk = shift_lanes_per_chunk or max(1, chunk // shift_top)
    prev_u = None
    for rnd in range(shift_rounds if do_exchange else 0):
        extra = proposals(u)
        if pregate:
            u_all, j0 = _frozen_pre_score(cache, x0s, params, u, delta,
                                          tuple(shift_set), extra)
            order0 = torch.argsort(j0[1:], dim=0, stable=True)[:prefilter]
            cand = u_all[1:][order0, torch.arange(b, device=dev)]
            u_sh_all, j_all = _shift_score(cache, x0s, params, u, lb, ub,
                                           solver, delta, (),
                                           shift_smooth_iters, cand)
        else:
            u_sh_all, j_all = _shift_score(cache, x0s, params, u, lb, ub,
                                           solver, delta, tuple(shift_set),
                                           shift_smooth_iters, extra)
        # D-gate: some proposal within the margin of the incumbent, and from
        # round 1 on fresh evidence (the lane or a neighbour moved).
        best_prop = j_all[1:].amin(0)
        gate = best_prop < cost + shift_margin * (1.0 + cost.abs())
        if prev_u is not None:
            changed = ((u - prev_u).abs() > 1e-6).flatten(1).any(1)
            fresh = changed.clone()
            if nbr_idx is not None:
                fresh |= changed[nbr_idx].any(1)
            gate &= fresh
        prev_u = u.clone()
        worthy = torch.nonzero(gate).flatten()
        n_worthy = worthy.numel()
        if shift_max_lanes and n_worthy > shift_max_lanes:
            gain = (cost[worthy] - best_prop[worthy]) / (1.0 + cost[worthy].abs())
            worthy = worthy[torch.argsort(-gain, stable=True)[:shift_max_lanes]]
            n_worthy = shift_max_lanes
        if diag is not None:
            diag[f'n_shift_worthy_r{rnd}'] = n_worthy
            if rnd == 0:
                diag['n_shift_worthy'] = n_worthy
        if not n_worthy:
            break
        solver_d = solver.replace(max_iters=shift_iters)
        worthy_p = _pad(worthy, lanes_per_chunk)
        u_cands, j_cands = u_sh_all[:, worthy_p], j_all[:, worthy_p]
        top = min(shift_top, j_cands.shape[0])
        n_improved = 0
        for c0 in range(0, n_worthy, lanes_per_chunk):
            ch = worthy_p[c0:c0 + lanes_per_chunk]
            nl = ch.numel()
            loc = torch.arange(c0, c0 + nl, device=dev)
            order = torch.argsort(j_cands[:, loc], dim=0, stable=True)[:top]
            res_d = refine(ch.repeat(top),
                           u_cands[order, loc].reshape((top * nl,) + u.shape[1:]),
                           solver_d)
            j_d = _finite(res_d.cost).reshape(top, nl)
            best_t = torch.argmin(j_d, dim=0)
            ar = torch.arange(nl, device=dev)
            n = min(nl, n_worthy - c0)
            n_improved = n_improved + _accept(
                u, cost, ch[:n],
                res_d.u.reshape((top, nl) + u.shape[1:])[best_t, ar][:n],
                j_d[best_t, ar][:n])
            iters[ch[:n]] += res_d.iters.reshape(top, nl).amax(0)[:n]
        if int(n_improved) == 0:
            break

    # Tail rescue: the top neighbourhood-cost outliers refine fresh starts.
    if rescue_lanes > 0 and b > 1:
        nbr = nbr_idx if nbr_idx is not None else _neighbours(x0s, params, 6)
        proxy = (cost - _median(cost[nbr])) / (1.0 + cost.abs())
        n_r = min(rescue_lanes, b)
        sel = torch.argsort(-proxy, stable=True)[:n_r]
        sel = sel[proxy[sel] > 1e-4]           # only genuine outliers pay
        n_sel = sel.numel()
        if diag is not None:
            diag['n_rescue'] = n_sel
        if n_sel:
            sel_p = torch.cat([sel, sel[:1].expand(n_r - n_sel)])
            n_nb = min(2, nbr.shape[1])
            kr = rescue_starts + 2 + n_nb
            # Starts: incumbent, u = 0, the best n_nb neighbours' incumbents
            # (direct starts), wide draws.
            nb_rank = torch.argsort(cost[nbr[sel_p]], dim=1,
                                    stable=True)[:, :n_nb]
            nb_starts = u[nbr[sel_p].gather(1, nb_rank)]      # (nr, n_nb, ...)
            draws = torch.from_numpy(_rescue_draws(
                seed, lb, ub, rescue_scale, rescue_starts, n_r, horizon,
                action_dim, u.dtype)).to(dev)
            starts = torch.cat([u[sel_p][None], torch.zeros_like(u[sel_p])[None],
                                nb_starts.transpose(0, 1), draws])
            res_r = refine(sel_p.repeat(kr),
                           starts.reshape((kr * n_r,) + u.shape[1:]),
                           solver.replace(max_iters=rescue_iters))
            j_r = _finite(res_r.cost).reshape(kr, n_r)
            best_k = torch.argmin(j_r, dim=0)
            ar = torch.arange(n_r, device=dev)
            j_best = j_r[best_k, ar]
            u_best = res_r.u.reshape((kr, n_r) + u.shape[1:])[best_k, ar]
            it_r = res_r.iters.reshape(kr, n_r).amax(0)
            if n_sel < n_r:
                # The padding repeats sel[0] with other draws: its best
                # candidate over all its columns is kept (the first wins ties).
                cols = torch.cat([ar[:1], ar[n_sel:]])
                c = cols[torch.argmin(j_best[cols])]
                j_best[0], u_best[0] = j_best[c], u_best[c]
                it_r[0] = it_r[cols].amax()
            _accept(u, cost, sel, u_best[:n_sel], j_best[:n_sel])
            iters[sel] += it_r[:n_sel]

    # Final polish of the lanes with the largest projected gradient,
    # unconverged first.
    if polish_lanes > 0:
        rank = (torch.where(torch.isfinite(pg), pg, torch.zeros_like(pg))
                .double() + 1e6 * (~conv).double())
        sel = torch.argsort(-rank, stable=True)[:min(polish_lanes, b)]
        n_sel = sel.numel()
        if diag is not None:
            diag['n_polish'] = n_sel
        solver_p = solver.replace(max_iters=polish_iters)
        lanes_pc = shift_lanes_per_chunk or chunk
        sel_p = _pad(sel, lanes_pc)
        for c0 in range(0, n_sel, lanes_pc):
            ch = sel_p[c0:c0 + lanes_pc]
            res_p = refine(ch, u[ch], solver_p)
            w, n = ch[:n_sel - c0], min(lanes_pc, n_sel - c0)
            _accept(u, cost, w, res_p.u[:n], _finite(res_p.cost[:n]))
            pg[w], conv[w] = res_p.pg_norm[:n], res_p.converged[:n]
            iters[w] += res_p.iters[:n]

    return SolveResult(u=u, cost=cost, iters=iters, pg_norm=pg,
                       converged=conv)


@torch.no_grad()
def solve_batch_staged(gp: GPState, state_dim: int, action_dim: int,
                       x0s: torch.Tensor, params: CostParams, horizon: int,
                       lb, ub,
                       solver: SolverConfig = SolverConfig(),
                       budget1: int = 48,
                       budget_total: int = 320,
                       tail_divisor: int = 4,
                       full_cov: bool = False,
                       delta: bool = False) -> SolveResult:
    """Two-phase adaptive-budget batched solve: all B lanes run `budget1`
    iterations; the lanes not converged then continue in chunks of
    max(1, B // tail_divisor) lanes (padded with the first such lane),
    warm-started with fresh L-BFGS memory, up to `budget_total` iterations
    in all."""
    b = x0s.shape[0]
    chunk = max(1, b // tail_divisor)
    res1 = solve_batch(gp, state_dim, action_dim, x0s, params, horizon,
                       lb, ub, solver.replace(max_iters=budget1),
                       full_cov=full_cov, delta=delta)
    todo = torch.nonzero(~res1.converged).flatten()
    if todo.numel() == 0:
        return res1
    s2 = solver.replace(max_iters=budget_total - budget1)
    return _continue_tail(
        res1, todo, chunk, budget1,
        lambda idx: solve_batch(gp, state_dim, action_dim, x0s[idx],
                                _gather_params(params, idx), horizon, lb,
                                ub, s2, u_init=res1.u[idx], full_cov=full_cov,
                                delta=delta))


def gather_result(mesh, res: SolveResult, axis: str = BATCH_AXIS) -> SolveResult:
    """Every rank's lanes of a SolveResult, gathered over `axis` in order."""
    return SolveResult(*(gather_lanes(mesh, t, axis) for t in res))


def solve_batch_sharded(mesh, gp: GPState, state_dim: int, action_dim: int,
                        x0s: torch.Tensor, params: CostParams, horizon: int,
                        lb, ub, solver: SolverConfig = SolverConfig(),
                        full_cov: bool = False, delta: bool = False,
                        impl: str = 'auto',
                        axis: str = BATCH_AXIS) -> SolveResult:
    """Scenario fan-out over the mesh's `axis`: each rank runs `solve_batch`
    on its B / n lanes against the replicated GP posterior, with no
    collective inside the solve, and the results are all-gathered.

    Every rank passes the same global x0s (B, ds), params and GP; B must
    divide by the axis size. Per-lane cost leaves (rank rule) are split, the
    others shared. Returns the whole (B, ...) result on every rank."""
    b = x0s.shape[0]
    lanes = lane_slice(mesh, b, axis)
    res = solve_batch(gp, state_dim, action_dim, x0s[lanes],
                      shard_params(params, lanes, b), horizon, lb, ub, solver,
                      full_cov=full_cov, delta=delta, impl=impl)
    return gather_result(mesh, res, axis)


_GP_TENSORS = tuple(f.name for f in dataclasses.fields(GPState)
                    if f.name != 'config')


def stack_gps(gp_list: Sequence[GPState]) -> GPState:
    """GPStates of one config (same capacity, dims and flags) stacked into
    one with a leading (B,) axis on every tensor."""
    cfg = gp_list[0].config
    if any(g.config != cfg for g in gp_list):
        raise ValueError('stack_gps: the GP states differ in their config')
    return dataclasses.replace(gp_list[0], **{
        name: torch.stack([getattr(g, name) for g in gp_list])
        for name in _GP_TENSORS})


def solve_batch_gp(gps: GPState, state_dim: int, action_dim: int,
                   x0s: torch.Tensor, params: CostParams, horizon: int,
                   lb, ub, solver: SolverConfig = SolverConfig(),
                   full_cov: bool = False) -> SolveResult:
    """B solves, each against its own GP draw (gps has a leading (B,) axis
    on every tensor, see stack_gps): one lockstep solve, by config.method,
    over the lanes' single-scenario rollouts, each on its lane's rollout
    cache (built for all lanes at once). gamma may be (B,); the other cost
    leaves are shared. On CUDA a kept program, as solve_batch's."""
    _check_device(gps, x0s)
    b = x0s.shape[0]
    if gps.x.ndim != 3 or gps.x.shape[0] != b:
        raise ValueError(f'solve_batch_gp: {b} lanes take a GPState stacked '
                         f'over {b} draws, got x of shape '
                         f'{tuple(gps.x.shape)}')
    u_init = x0s.new_zeros((b, horizon, action_dim))
    gamma = torch.as_tensor(params.gamma)
    gamma_b = gamma if gamma.ndim == 1 else gamma.expand(b)
    cache = build_rollout_cache(gps, state_dim, action_dim)
    return solve_trajectory_batched(
        lanes_objective(cache, x0s, params._replace(gamma=gamma_b),
                        full_cov=full_cov), u_init, lb, ub, solver)
