"""Model-axis sharded GP-MPC solves over torch.distributed
(port of gpmpc_tpu/parallel/model_sharded.py).

The per-step variance contraction is the only O(N^2) work of a solve: the
(E, N, N) cache b_lam against per-scenario exp chains. The 'model' axis of
the mesh shards b_lam BY ROWS,

    t_e = sum_i d_i [ sum_j blam_e[i, j] e_ij d_j ]
        = sum over model ranks of ( sum_{i in the rank's rows} ... ),

so each rank contracts its (E, Nl, N) row block (stored transposed, (E, N, Nl),
the layout K3 reads) against the full (replicated, O(N d)) operands and the (B, E) partial traces are summed over the model
group with one all_reduce a step. Everything else in the step, and the
L-BFGS algebra, runs replicated on every rank of a model group, which stays
in lockstep: the all_reduce gives every rank the same sum, so f, g and the
solver's `done` agree to the bit. The batch axis splits the lanes; each batch
row of the mesh is an independent solve.

Autograd of the sum over the model axis is the Megatron pair of
autograd.Functions, not `torch.distributed.nn.functional.all_reduce` (whose
backward all-reduces the cotangent again, and every rank computes the same
cost from the summed trace, so the gradient would count n_model times):
  * `_SumOverGroup`: all_reduce forward, identity backward;
  * `_CopyToGroup`: identity forward, all_reduce backward, on the replicated
    inputs of the rank's partial (u and M2, or u and 1/hls untied), whose
    per-rank cotangents are partial and sum to the exact one.
The tied branch runs the row-block kernel K3
(ops/kernels/variance_trace.variance_trace_tied_block); the untied branch the
einsum form as torch ops.

The value-and-grad is a `ValueAndGrad` (mpc/solver.py): built on its inputs,
keyed by the mesh and the model group, so the solve is a kept program as
JAX's one compiled while_loop around the shard_map value-and-grad is. Over
NCCL on CUDA the step graph holds the rollout, K3's launches, the cost, the
backward and both all_reduces, and the loop runs on the card; over gloo
(whose all_reduce of a CUDA tensor goes through the host) and on the CPU
the loop runs eagerly (the solver's CAPTURED_BACKENDS). The ranks of a
model group stay in lockstep on a device loop too, since f, g and `done`
agree to the bit; there a divergence would hang a collective rather than
raise. A group's programs are released before the group is destroyed
(parallel/distributed.destroy_group).
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch
import torch.distributed as dist

from gpmpc_tpu_torch.device import ensure_true_f32
from gpmpc_tpu_torch.dynamics import (_MIN_VAR, CACHE_TENSORS, RolloutCache,
                                      build_rollout_cache, cache_from)
from gpmpc_tpu_torch.gp.state import GPState
from gpmpc_tpu_torch.mpc.cost import (CostParams, params_from, params_key,
                                      params_tensors, risk_sensitive_cost)
from gpmpc_tpu_torch.mpc.solver import (SolverConfig, SolveResult,
                                        ValueAndGrad,
                                        solve_trajectory_batched)
from gpmpc_tpu_torch.ops import moments
from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
from gpmpc_tpu_torch.parallel.batch import gather_result, shard_params
from gpmpc_tpu_torch.parallel.mesh import (BATCH_AXIS, MODEL_AXIS, lane_slice,
                                           row_block)


class _SumOverGroup(torch.autograd.Function):
    """Sum over the group's ranks; the cotangent passes through unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _CopyToGroup(torch.autograd.Function):
    """Identity on the value; the cotangent is summed over the group's
    ranks."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        dist.all_reduce(ct, group=ctx.group)
        return ct, None


def _variance_multi_batched_diag_rows(u, s_diag, x, blam_t_rows, row_off,
                                      log_lambdas, log_sigma_f, means, group,
                                      tied: bool = False):
    """Row-sharded twin of moments.variance_prop_multi_batched_diag.

    u (B, d); s_diag (B, d); x (N, d) replicated; blam_t_rows (E, N, Nl)
    THIS rank's rows [row_off, row_off + Nl) of b_lam, transposed
    (mesh.row_block); means (B, E) -> (B, E). The (B, E) partial traces are
    summed over `group` (the model axis).

    tied=True (GPConfig.tied_lambdas) runs the row-block kernel K3; untied
    runs the einsum form. Both take the trace's precision policy
    (ops/kernels/variance_trace.py): the operands enter the group in f64,
    the partials are summed in f64 (they cancel across ranks as the terms do
    within one), and only the sum is rounded to u's dtype; the cotangents of
    u and M2 are summed over the group in f64 too."""
    n_loc = blam_t_rows.shape[2]
    f64 = vt.TRACE_DTYPE
    hls = (torch.exp(log_lambdas) / 2.0)[None] + s_diag[:, None, :]  # (B, E, d)
    log_det_part = -0.5 * (torch.sum(torch.log(hls), dim=-1)
                           - torch.sum(log_lambdas - math.log(2.0),
                                       dim=-1)[None])         # (B, E)
    u_c = _CopyToGroup.apply(u.to(f64), group)
    if tied:
        x_blk = x[row_off:row_off + n_loc]
        # Lengthscale cotangents through the tied hypergrad guard (NaN);
        # s_diag gradients stay exact.
        lam0g = torch.mean(torch.exp(moments._tied_hypergrad_guard(log_lambdas)),
                           dim=0)
        m2s = torch.diag_embed(1.0 / ((lam0g / 2.0)[None] + s_diag))  # (B, d, d)
        t_loc = vt.variance_trace_tied_block(
            u_c, _CopyToGroup.apply(m2s.to(f64), group), x, x_blk, blam_t_rows)
    else:
        a = u_c[:, None, :] - x.to(f64)[None]                   # (B, N, d)
        inv_hls = _CopyToGroup.apply((1.0 / hls).to(f64), group)  # (B, E, d)
        g = a[:, None] * inv_hls[:, :, None, :]                 # (B, E, N, d)
        q = torch.sum(g * a[:, None], dim=-1)                   # (B, E, N)
        dv = torch.exp(-0.125 * q)                              # (B, E, N)
        rows = slice(row_off, row_off + n_loc)
        # p_loc[b, e, i, j] = g_rows[b, e, i, :] . a[b, j, :]   (B, E, Nl, N)
        p_loc = torch.einsum('beid,bjd->beij', g[:, :, rows], a)
        w = (blam_t_rows.transpose(1, 2).to(f64)[None]
             * torch.exp(-0.25 * p_loc))
        t_loc = torch.einsum('bei,beij,bej->be', dv[:, :, rows], w, dv)
    t = _SumOverGroup.apply(t_loc, group).to(u.dtype)
    return (torch.exp(2.0 * log_sigma_f)[None]
            - torch.exp(log_det_part) * t - means ** 2)


def _step_batched_rows(cache: RolloutCache, blam_t_rows, row_off, mean,
                       cov_diag, action, action_var: float, delta: bool,
                       group):
    """Model-sharded twin of dynamics._step_batched (diagonal path)."""
    ds, da = cache.state_dim, cache.action_dim
    b = mean.shape[0]
    joint_mean = torch.cat([mean, action], dim=1)
    joint_diag = torch.cat([cov_diag, cov_diag.new_full((b, da), action_var)],
                           dim=1)
    gp_mean, l = moments.mean_prop_batched_diag(
        joint_mean, joint_diag, cache.x, cache.beta, cache.log_lambdas,
        cache.log_sigma_f, cache.mask, tied=cache.tied_lambdas)
    gp_var = _variance_multi_batched_diag_rows(
        joint_mean, joint_diag, cache.x, blam_t_rows, row_off,
        cache.log_lambdas, cache.log_sigma_f, gp_mean, group,
        tied=cache.tied_lambdas)
    if delta:
        c_io = moments.input_output_cov_batched_diag(
            joint_mean, joint_diag, cache.x, cache.beta, l, cache.log_lambdas)
        c_state_diag = torch.diagonal(c_io[:, :, :ds], dim1=1, dim2=2)
        new_mean = mean + gp_mean
        new_var = cov_diag + gp_var + 2.0 * c_state_diag
    else:
        new_mean = gp_mean
        new_var = gp_var
    return new_mean, torch.clamp(new_var, min=_MIN_VAR)


def rollout_batched_rows(cache: RolloutCache, blam_t_rows, row_off, x0s,
                         actions, init_state_var: float = 1e-3,
                         action_var: float = 1e-3, delta: bool = False,
                         group=None):
    """Model-sharded batched rollout (diagonal covariance): matches
    dynamics.rollout_batched; `cache.b_lam` is not read, the rank's row block
    at row_off is, transposed: blam_t_rows (E, N, Nl). x0s (B, ds); actions
    (B, H, da) -> (means (B, H+1, ds), covs (B, H+1, ds, ds))."""
    ds = cache.state_dim
    b, horizon = actions.shape[:2]
    mean = x0s
    var = x0s.new_full((b, ds), init_state_var)
    means, variances = [mean], [var]
    for t in range(horizon):
        mean, var = _step_batched_rows(cache, blam_t_rows, row_off, mean, var,
                                       actions[:, t], action_var, delta, group)
        means.append(mean)
        variances.append(var)
    return (torch.stack(means, dim=1),
            torch.diag_embed(torch.stack(variances, dim=1)))


def sharded_value_and_grad(mesh, cache: RolloutCache, blam_t_rows, row_off,
                           x0s, params: CostParams,
                           delta: bool = False) -> ValueAndGrad:
    """The per-lane objective's (f, g) on this rank's lanes, its trace split
    over the mesh's model axis: u (B_l, H, da) -> (f (B_l,), g (B_l, H, da)).
    Every rank of a model group must call it with the same u.

    A `ValueAndGrad` (mpc/solver.py): its inputs are the cache's tensors
    (b_lam the placeholder of shard_problem), this rank's transposed row
    block, its lanes of x0s and its cost leaves; its key the mesh's shape,
    axis names and this rank's coordinates, the cache's static key, row_off,
    delta and which cost leaves are None; its group the model axis's (the
    solver adds the group's backend and serial number to the program's
    key). Everything derived from the inputs is computed inside the built
    oracle, so a kept program replayed on the next call's inputs reads
    them fresh. Called on u, it evaluates."""
    group = mesh.get_group(MODEL_AXIS)
    static, p_key = cache.static_key(), params_key(params)
    n_c = len(CACHE_TENSORS)

    def build(*inputs):
        c = cache_from(static, inputs[:n_c])
        rows, x0 = inputs[n_c:n_c + 2]
        p = params_from(p_key, inputs[n_c + 2:])

        def val_and_grad(u):
            u = u.detach().requires_grad_(True)
            with torch.enable_grad():
                means, covs = rollout_batched_rows(c, rows, row_off, x0, u,
                                                   delta=delta, group=group)
                f = risk_sensitive_cost(p, means, covs, u)
                (g,) = torch.autograd.grad(f.sum(), u)
            return f.detach(), g
        return val_and_grad

    key = ('sharded_value_and_grad', tuple(mesh.mesh.shape),
           tuple(mesh.mesh_dim_names), tuple(mesh.get_coordinate()), static,
           row_off, delta, p_key)
    return ValueAndGrad(key, (*cache.tensors(), blam_t_rows, x0s,
                              *params_tensors(params, x0s.device)),
                        build, group)


def shard_problem(mesh, gp: GPState, state_dim: int, action_dim: int,
                  x0s: torch.Tensor, params: CostParams):
    """This rank's part of a (batch, model) sharded problem: the rollout
    cache without b_lam (a (E, 1, 1) placeholder), its b_lam row block
    (transposed, mesh.row_block) and offset, its lanes of x0s and of the
    per-lane cost parameters."""
    cache = build_rollout_cache(gp, state_dim, action_dim)
    row_off, blam_t_rows = row_block(mesh, cache.b_lam)
    cache = replace(cache, b_lam=cache.b_lam.new_zeros(
        (cache.b_lam.shape[0], 1, 1)))
    lanes = lane_slice(mesh, x0s.shape[0])
    return (cache, blam_t_rows, row_off, x0s[lanes],
            shard_params(params, lanes, x0s.shape[0]))


def solve_batch_2d(mesh, gp: GPState, state_dim: int, action_dim: int,
                   x0s: torch.Tensor, params: CostParams, horizon: int,
                   lb, ub, solver: SolverConfig = SolverConfig(),
                   delta: bool = False) -> SolveResult:
    """B solves over a (batch, model) mesh: lanes split over the batch axis,
    each solve's O(N^2) trace split over the model axis with an all_reduce of
    the partial traces (diagonal covariance, lockstep L-BFGS).

    Every rank passes the same global x0s (B, ds), params and GP; each holds
    only its (E, cap / n_model, cap) row block of b_lam (stored transposed,
    mesh.row_block). B must divide by the
    batch-axis size and the GP capacity by the model-axis size. Returns the
    whole (B, ...) result on every rank, gathered over the batch axis after
    the solve (as JAX's out_specs gather).

    The solve is a kept program (sharded_value_and_grad is a ValueAndGrad):
    over NCCL on CUDA the first call of a key runs iteration 1 eagerly,
    which also creates the communicator, then captures the step, its
    all_reduces included, into the loop graph on the card; a later call is
    its init graph and one loop launch. Over gloo and on the CPU the loop
    runs eagerly, by the solver's rule (CAPTURED_BACKENDS)."""
    if x0s.device != gp.x.device:
        raise ValueError(f'x0s lies on {x0s.device}, the GP on {gp.x.device}')
    ensure_true_f32()
    cache, blam_t_rows, row_off, x0s_l, params_l = shard_problem(
        mesh, gp, state_dim, action_dim, x0s, params)
    u_init = x0s_l.new_zeros((x0s_l.shape[0], horizon, action_dim))
    vg = sharded_value_and_grad(mesh, cache, blam_t_rows, row_off, x0s_l,
                                params_l, delta)
    res = solve_trajectory_batched(None, u_init, lb, ub, solver,
                                   val_and_grad=vg)
    return gather_result(mesh, res, BATCH_AXIS)
