"""Scenario-batched uncertain rollout of GP dynamics, diagonal covariance
(port of the batched path of gpmpc_tpu/dynamics.py).

Conventions kept from the JAX package: the state covariance starts at
1e-3 I, the action block of the joint input covariance is 1e-3 I, the GP
bundle shares training inputs x = (state | action) with one output per state
dimension, and gradients flow to the actions only (the cache is detached).
The horizon recurrence is a Python loop over H.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gpmpc_tpu_torch.gp.state import GPState
from gpmpc_tpu_torch.ops import moments

_MIN_VAR = 1e-8


@dataclass(frozen=True)
class RolloutCache:
    """What the per-step moment matching needs, built once per solve from a
    GPState and constant w.r.t. the actions."""
    x: torch.Tensor            # (cap, D) training inputs, D = ds + da
    mask: torch.Tensor         # (cap,)
    beta: torch.Tensor         # (E, cap)
    b_lam: torch.Tensor        # (E, cap, cap) variance cache (ops.moments)
    log_lambdas: torch.Tensor  # (E, D)
    log_sigma_f: torch.Tensor  # (E,)
    state_dim: int
    action_dim: int
    tied_lambdas: bool = False


def build_rollout_cache(gp: GPState, state_dim: int,
                        action_dim: int) -> RolloutCache:
    x, beta = gp.x.detach(), gp.beta.detach()
    ll, lsf = gp.log_lambdas.detach(), gp.log_sigma_f.detach()
    b_lam = moments.make_variance_cache(x, beta, gp.kinv.detach(), ll, lsf,
                                        gp.mask)
    return RolloutCache(x=x, mask=gp.mask, beta=beta,
                        b_lam=b_lam.contiguous(), log_lambdas=ll,
                        log_sigma_f=lsf, state_dim=state_dim,
                        action_dim=action_dim,
                        tied_lambdas=bool(gp.config.tied_lambdas))


def _step_batched(cache: RolloutCache, mean, cov_diag, action,
                  action_var: float, delta: bool, mean_only: bool = False):
    """mean (B, ds); cov_diag (B, ds); action (B, da) ->
    (new_mean (B, ds), new_cov_diag (B, ds)).

    mean_only=True skips the O(N^2) variance contraction and carries the
    floor variance (the surrogate rollout of the multistart recipe)."""
    da = cache.action_dim
    b = mean.shape[0]
    joint_mean = torch.cat([mean, action], dim=1)                 # (B, D)
    joint_diag = torch.cat([cov_diag, cov_diag.new_full((b, da), action_var)],
                           dim=1)
    gp_mean, l = moments.mean_prop_batched_diag(
        joint_mean, joint_diag, cache.x, cache.beta, cache.log_lambdas,
        cache.log_sigma_f, cache.mask, tied=cache.tied_lambdas)

    if mean_only:
        floor = gp_mean.new_full((b, cache.beta.shape[0]), _MIN_VAR)
        return (mean + gp_mean if delta else gp_mean), floor

    gp_var = moments.variance_prop_multi_batched_diag(
        joint_mean, joint_diag, cache.x, cache.b_lam, cache.log_lambdas,
        cache.log_sigma_f, gp_mean, tied=cache.tied_lambdas)      # (B, E)
    if delta:
        c_io = moments.input_output_cov_batched_diag(
            joint_mean, joint_diag, cache.x, cache.beta, l, cache.log_lambdas)
        c_state_diag = torch.diagonal(c_io[:, :, :cache.state_dim],
                                      dim1=1, dim2=2)             # (B, ds)
        new_mean = mean + gp_mean
        new_var = cov_diag + gp_var + 2.0 * c_state_diag
    else:
        new_mean = gp_mean
        new_var = gp_var
    return new_mean, torch.clamp(new_var, min=_MIN_VAR)


def rollout_batched(cache: RolloutCache, x0s, actions,
                    init_state_var: float = 1e-3, action_var: float = 1e-3,
                    delta: bool = False, full_cov: bool = False,
                    mean_only: bool = False, frozen_cov_diag=None):
    """Batched H-step uncertain shooting rollout.

    x0s (B, ds); actions (B, H, da) -> (means (B, H+1, ds),
    covs (B, H+1, ds, ds)); index 0 is the initial state with covariance
    init_state_var * I. frozen_cov_diag (B, H+1, ds) replaces the carried
    variance by a given sequence and propagates the mean only."""
    if full_cov:
        raise NotImplementedError(
            'rollout_batched(full_cov=True) is not ported yet: the full '
            'covariance rollout is a later slice (ROADMAP section 1, item 9).')
    ds = cache.state_dim
    b, horizon = actions.shape[:2]
    mean = x0s
    var = x0s.new_full((b, ds), init_state_var)
    means, variances = [mean], [var]
    for t in range(horizon):
        if frozen_cov_diag is not None:
            mean, _ = _step_batched(cache, mean, frozen_cov_diag[:, t],
                                    actions[:, t], action_var, delta,
                                    mean_only=True)
        else:
            mean, var = _step_batched(cache, mean, var, actions[:, t],
                                      action_var, delta, mean_only=mean_only)
            variances.append(var)
        means.append(mean)
    means = torch.stack(means, dim=1)                             # (B, H+1, ds)
    if frozen_cov_diag is not None:
        return means, torch.diag_embed(frozen_cov_diag)
    return means, torch.diag_embed(torch.stack(variances, dim=1))
