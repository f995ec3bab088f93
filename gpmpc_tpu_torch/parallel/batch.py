"""Batched GP-MPC solves against one shared GP posterior
(port of `solve_batch`, fused branch, and `solve_batch_sharded`,
gpmpc_tpu/parallel/batch.py).

The unit of work is one full trajectory optimization. Initial states and
per-lane cost parameters (a gamma sweep, say) fan out over a leading (B,)
axis; the rollout cache is built once and shared by every lane.
`solve_batch_sharded` splits the lanes over the batch axis of a process mesh
(parallel/mesh.py): each rank solves its lanes against the replicated GP with
no collective inside the solve, and the results are gathered.
"""

from __future__ import annotations

from typing import Optional

import torch

from gpmpc_tpu_torch.device import ensure_true_f32
from gpmpc_tpu_torch.dynamics import (RolloutCache, build_rollout_cache,
                                      rollout_batched)
from gpmpc_tpu_torch.gp.state import GPState
from gpmpc_tpu_torch.mpc.cost import (CostParams, is_lane_leaf,
                                      risk_sensitive_cost)
from gpmpc_tpu_torch.mpc.solver import (SolverConfig, SolveResult,
                                        solve_trajectory_batched)
from gpmpc_tpu_torch.parallel.mesh import BATCH_AXIS, gather_lanes, lane_slice


def batch_objective(cache: RolloutCache, x0s: torch.Tensor,
                    params: CostParams, delta: bool = False,
                    full_cov: bool = False):
    """The per-lane objective J: (B, H, da) -> (B,), the uncertain rollout
    from x0s followed by the risk-sensitive cost."""
    def objective_b(u):
        means, covs = rollout_batched(cache, x0s, u, delta=delta,
                                      full_cov=full_cov)
        return risk_sensitive_cost(params, means, covs, u)

    return objective_b


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
    device: the explicitly-batched rollout and the lockstep L-BFGS.

    impl: 'auto' and 'fused' run the batched path; 'vmap' (the JAX package's
    per-scenario oracle twin) is not ported yet."""
    if impl == 'vmap':
        raise NotImplementedError(
            "solve_batch(impl='vmap') is not ported: the per-scenario solver "
            'is a later slice (ROADMAP section 1, item 11).')
    if impl not in ('auto', 'fused'):
        raise ValueError(f'unknown impl {impl!r}')
    if x0s.device != gp.x.device:
        raise ValueError(f'x0s lies on {x0s.device}, the GP on {gp.x.device}')
    ensure_true_f32()
    b = x0s.shape[0]
    cache = build_rollout_cache(gp, state_dim, action_dim)
    if u_init is None:
        u_init = x0s.new_zeros((b, horizon, action_dim))

    return solve_trajectory_batched(
        batch_objective(cache, x0s, params, delta, full_cov), u_init, lb, ub,
        solver)


def shard_params(params: CostParams, lanes: slice, b: int) -> CostParams:
    """The per-lane leaves (cost.is_lane_leaf) cut to `lanes`; shared leaves
    as they are."""
    out = {}
    for name, v in params._asdict().items():
        if is_lane_leaf(name, v):
            if v.shape[0] != b:
                raise ValueError(f'cost parameter {name} has {v.shape[0]} '
                                 f'lanes, the batch {b}')
            v = v[lanes]
        out[name] = v
    return CostParams(**out)


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
