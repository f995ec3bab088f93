"""Uncertain rollouts of GP dynamics (port of gpmpc_tpu/dynamics.py): the
single-scenario `rollout` and the scenario-batched `rollout_batched`, with a
diagonal or (full_cov=True) a full state covariance.

Conventions kept from the JAX package: the state covariance starts at
1e-3 I, the action block of the joint input covariance is 1e-3 I, the GP
bundle shares training inputs x = (state | action) with one output per state
dimension, and gradients flow to the actions only (the cache is detached).
The horizon recurrence is a Python loop over H. A full covariance carries the
exact eq.-A14 cross-output terms, is symmetrised, keeps the exact
predictive variances on its diagonal and is projected onto the PSD cone by
an eigenvalue clip at 1e-8. Its eigenvalues come from the small-d Jacobi
eigensolver of ops/kernels/eigh_small.py (one kernel launch a step on CUDA,
no host read, so that a full-covariance step can be captured in a CUDA
graph); the clamp and the product stay torch ops, JAX's expression.

`rollout_lanes` is `rollout` mapped over B lanes by torch.func.vmap, JAX's
vmap of the single-scenario rollout: `_step` stays the one place where a
lane's arithmetic lives, and every op runs once for all lanes (no op of the
step takes functorch's per-lane fallback). Its cache is shared by the lanes,
or carries a leading (B,) axis on every tensor: one GP a lane
(`build_rollout_cache` of a stacked GPState), told apart by the rank of x.
As in the batched rollouts, each step's variance trace is evaluated in f64
whatever the dtype of the rollout (ops/moments.py `_single_trace`, the
precision policy); the rest of the step runs in that dtype.

A GP with a nominal mean model (GPConfig.nominal_fn: (n, D) -> (n, E)) fits
the residual; `rollout` and `rollout_lanes` add the nominal part back by
first-order (EKF) propagation, exact for an affine model. Under vmap the
model sees batched tensors: it must read no value on the host (such a
model raises there). `rollout_batched` raises on one, as the JAX package
does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from gpmpc_tpu_torch.gp.state import GPState
from gpmpc_tpu_torch.ops import moments
from gpmpc_tpu_torch.ops.kernels import eigh_small

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
    # The GP's nominal mean model (GPConfig.nominal_fn), or None.
    nominal_fn: Optional[Callable] = None

    def tensors(self) -> tuple:
        """The tensor fields, in CACHE_TENSORS order."""
        return tuple(getattr(self, k) for k in CACHE_TENSORS)

    def static_key(self) -> tuple:
        """The fields that are not tensors (hashable): with tensors() they
        rebuild the cache (`cache_from`)."""
        return (self.state_dim, self.action_dim, self.tied_lambdas,
                self.nominal_fn)


CACHE_TENSORS = ('x', 'mask', 'beta', 'b_lam', 'log_lambdas', 'log_sigma_f')


def cache_from(static_key: tuple, tensors) -> RolloutCache:
    """The RolloutCache of RolloutCache.static_key() and tensors()."""
    return RolloutCache(*tensors, *static_key)


def build_rollout_cache(gp: GPState, state_dim: int,
                        action_dim: int) -> RolloutCache:
    """The rollout cache of gp. A GPState stacked over B lanes
    (parallel.batch.stack_gps: a leading (B,) axis on every tensor, x of
    rank 3) gives every cache tensor that axis, the lanes' variance caches
    made in one batched call; the fields that are not tensors come from the
    shared config."""
    x, beta = gp.x.detach(), gp.beta.detach()
    ll, lsf = gp.log_lambdas.detach(), gp.log_sigma_f.detach()
    make = (torch.func.vmap(moments.make_variance_cache) if x.ndim == 3
            else moments.make_variance_cache)
    b_lam = make(x, beta, gp.kinv.detach(), ll, lsf, gp.mask)
    return RolloutCache(x=x, mask=gp.mask, beta=beta,
                        b_lam=b_lam.contiguous(), log_lambdas=ll,
                        log_sigma_f=lsf, state_dim=state_dim,
                        action_dim=action_dim,
                        tied_lambdas=bool(gp.config.tied_lambdas),
                        nominal_fn=gp.config.nominal_fn)


def _psd_clip(cov):
    """The PSD projection of symmetric (..., d, d) matrices: eigenvalues
    clipped at _MIN_VAR."""
    w, v = eigh_small.eigh(cov)
    return torch.einsum('...ik,...k,...jk->...ij', v,
                        torch.clamp(w, min=_MIN_VAR), v)


def _step(cache: RolloutCache, mean, cov, action, action_var: float,
          full_cov: bool, delta: bool):
    """One moment-matching step of one scenario: mean (ds,); cov (ds, ds);
    action (da,) -> (next mean (ds,), next cov (ds, ds)).

    delta=True treats the GP outputs as state increments and adds the exact
    input-output covariance terms. A nominal model adds
    mean += f_nom(m), cov += J S J^T + J cov(x*, f_gp) + (.)^T with
    J = df_nom/dx at m (torch.func.jacrev)."""
    ds, da = cache.state_dim, cache.action_dim
    e = cache.beta.shape[0]
    joint_mean = torch.cat([mean, action])
    joint_cov = torch.block_diag(
        cov, action_var * torch.eye(da, dtype=mean.dtype, device=mean.device))
    mean_l = [moments.mean_prop(joint_mean, joint_cov, cache.x, cache.beta[k],
                                cache.log_lambdas[k], cache.log_sigma_f[k],
                                cache.mask) for k in range(e)]
    gp_mean = torch.stack([m for m, _ in mean_l])               # (E,)
    gp_var = moments.variance_prop_multi(joint_mean, joint_cov, cache.x,
                                         cache.b_lam, cache.log_lambdas,
                                         cache.log_sigma_f, gp_mean)

    def io_cov():                                               # (E, D)
        return torch.stack([moments.input_output_cov(
            joint_mean, joint_cov, cache.x, cache.beta[k], mean_l[k][1],
            cache.log_lambdas[k]) for k in range(e)])

    has_nom = cache.nominal_fn is not None
    if has_nom and delta:
        raise ValueError(
            'delta dynamics and a nominal mean model are mutually exclusive: '
            'nominal models predict the next state (the GP fits the '
            'residual), while delta mode treats GP outputs as increments.')
    if has_nom:
        def nom(z):                                             # (D,) -> (E,)
            return cache.nominal_fn(z[None])[0]
        j_nom = torch.func.jacrev(nom)(joint_mean)              # (E, D)
        nom_cov = j_nom @ joint_cov @ j_nom.T                   # (E, E)
        cross_nom = j_nom @ io_cov().T                          # (E, E)
        new_mean = nom(joint_mean) + gp_mean
    elif delta:
        c_state = io_cov()[:, :ds].T                            # (ds, E)
        new_mean = mean + gp_mean
    else:
        new_mean = gp_mean

    if not full_cov:
        if delta:
            new_var = torch.diagonal(cov) + gp_var + 2.0 * torch.diagonal(c_state)
        elif has_nom:
            new_var = (gp_var + torch.diagonal(nom_cov)
                       + 2.0 * torch.diagonal(cross_nom))
        else:
            new_var = gp_var
        return new_mean, torch.diag(torch.clamp(new_var, min=_MIN_VAR))

    # Eq. A14 off the diagonal, symmetrised; the exact variances on it.
    cov_mat = torch.stack([torch.stack([moments.covariance_prop(
        joint_mean, joint_cov, cache.x, cache.beta[i], cache.beta[j],
        cache.log_lambdas[i], cache.log_lambdas[j], cache.log_sigma_f[i],
        cache.log_sigma_f[j], cache.mask, gp_mean[i], gp_mean[j])
        for j in range(ds)]) for i in range(ds)])
    cov_mat = 0.5 * (cov_mat + cov_mat.T)
    cov_mat = cov_mat - torch.diag(torch.diagonal(cov_mat)) + torch.diag(gp_var)
    if delta:
        cov_mat = cov + cov_mat + c_state + c_state.T
    elif has_nom:
        cov_mat = cov_mat + nom_cov + cross_nom + cross_nom.T
    return new_mean, _psd_clip(cov_mat)


def rollout(cache: RolloutCache, x0, actions, init_state_var: float = 1e-3,
            action_var: float = 1e-3, full_cov: bool = False,
            delta: bool = False):
    """H-step uncertain shooting rollout of one scenario: x0 (ds,);
    actions (H, da) -> (means (H+1, ds), covs (H+1, ds, ds)); index 0 is the
    initial state with covariance init_state_var * I."""
    mean = x0
    cov = init_state_var * torch.eye(cache.state_dim, dtype=x0.dtype,
                                     device=x0.device)
    means, covs = [mean], [cov]
    for t in range(actions.shape[0]):
        mean, cov = _step(cache, mean, cov, actions[t], action_var, full_cov,
                          delta)
        means.append(mean)
        covs.append(cov)
    return torch.stack(means), torch.stack(covs)


def rollout_lanes(cache: RolloutCache, x0s, actions, full_cov: bool = False,
                  delta: bool = False):
    """`rollout` of B lanes at once: x0s (B, ds); actions (B, H, da) ->
    (means (B, H+1, ds), covs (B, H+1, ds, ds)), lane b equal to
    rollout(cache_b, x0s[b], actions[b]) (rollout's default variances). The cache is shared (x of rank
    2), or its every tensor carries the lanes' (B,) axis (x of rank 3: one
    GP a lane; another lane count raises ValueError). torch.func.vmap of
    `rollout`: each op of the step runs once over all lanes."""
    b = x0s.shape[0]
    lane_cache = cache.x.ndim == 3
    if lane_cache and cache.x.shape[0] != b:
        raise ValueError(f'rollout_lanes of {b} lanes takes a cache of one '
                         f'GP a lane or a shared one, got x of shape '
                         f'{tuple(cache.x.shape)}')
    static = cache.static_key()

    def one(tensors, x0, u):
        return rollout(cache_from(static, tensors), x0, u, full_cov=full_cov,
                       delta=delta)

    return torch.func.vmap(one, in_dims=(0 if lane_cache else None, 0, 0))(
        cache.tensors(), x0s, actions)


def rollout_from_gp(gp: GPState, state_dim: int, action_dim: int, x0,
                    actions, **kw):
    """Build the cache and roll out in one call."""
    return rollout(build_rollout_cache(gp, state_dim, action_dim), x0,
                   actions, **kw)


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


def _step_batched_full(cache: RolloutCache, mean, cov, action,
                       action_var: float, delta: bool):
    """Full-covariance batched step: mean (B, ds); cov (B, ds, ds);
    action (B, da) -> (new_mean (B, ds), new_cov (B, ds, ds)). The variance
    runs the trace kernels with a non-diagonal M2; tied lengthscales share
    one (N, N) exp chain for the whole (E, E) cross-output block."""
    ds, da = cache.state_dim, cache.action_dim
    b = mean.shape[0]
    joint_mean = torch.cat([mean, action], dim=1)                 # (B, D)
    joint_cov = torch.zeros((b, ds + da, ds + da), dtype=mean.dtype,
                            device=mean.device)
    joint_cov[:, :ds, :ds] = cov
    joint_cov[:, ds:, ds:] = action_var * torch.eye(da, dtype=mean.dtype,
                                                    device=mean.device)
    tied = cache.tied_lambdas
    gp_mean, l = moments.mean_prop_batched(
        joint_mean, joint_cov, cache.x, cache.beta, cache.log_lambdas,
        cache.log_sigma_f, cache.mask, tied=tied)                 # (B, E)
    gp_var = moments.variance_prop_multi_batched(
        joint_mean, joint_cov, cache.x, cache.b_lam, cache.log_lambdas,
        cache.log_sigma_f, gp_mean, tied=tied)                    # (B, E)
    cov_mat = moments.covariance_prop_multi_batched(
        joint_mean, joint_cov, cache.x, cache.beta, cache.log_lambdas,
        cache.log_sigma_f, gp_mean, cache.mask, tied=tied)        # (B, E, E)
    cov_mat = 0.5 * (cov_mat + cov_mat.transpose(1, 2))
    # Off-diagonal from eq. A14; diagonal is the exact predictive variance.
    eye = torch.eye(ds, dtype=mean.dtype, device=mean.device)
    cov_mat = cov_mat * (1.0 - eye)[None] + gp_var[..., None] * eye[None]
    if delta:
        c_io = moments.input_output_cov_batched(
            joint_mean, joint_cov, cache.x, cache.beta, l,
            cache.log_lambdas)                                    # (B, E, D)
        c_state = c_io[:, :, :ds].transpose(1, 2)                 # (B, ds, E)
        new_mean = mean + gp_mean
        cov_mat = cov + cov_mat + c_state + c_state.transpose(1, 2)
    else:
        new_mean = gp_mean
    return new_mean, _psd_clip(cov_mat)


def rollout_batched(cache: RolloutCache, x0s, actions,
                    init_state_var: float = 1e-3, action_var: float = 1e-3,
                    delta: bool = False, full_cov: bool = False,
                    mean_only: bool = False, frozen_cov_diag=None):
    """Batched H-step uncertain shooting rollout.

    x0s (B, ds); actions (B, H, da) -> (means (B, H+1, ds),
    covs (B, H+1, ds, ds)); index 0 is the initial state with covariance
    init_state_var * I. full_cov=True carries the full cross-output state
    covariance (and then ignores mean_only and frozen_cov_diag, as the JAX
    package does). frozen_cov_diag (B, H+1, ds) replaces the carried
    variance by a given sequence and propagates the mean only.

    A cache of one GP a lane (x of rank 3, G lanes: `build_rollout_cache` of
    a stacked GPState) takes B = G K scenarios lane-major, K a lane
    (scenario b on lane b // K): the rollout is mapped over the lanes by
    torch.func.vmap, JAX's vmap of a K-scenario batched rollout, and its
    variance trace runs K1's grouped form (ops/kernels/variance_trace.py,
    the trace's rule under vmap), each lane's K scenarios against its own
    b_lam. Diagonal covariance and tied lengthscales only there."""
    if cache.nominal_fn is not None:
        raise NotImplementedError(
            'rollout_batched does not support nominal mean models; roll each '
            'scenario out with dynamics.rollout.')
    if cache.x.ndim == 3:
        return _rollout_batched_lanes(cache, x0s, actions, init_state_var,
                                      action_var, delta, full_cov, mean_only,
                                      frozen_cov_diag)
    ds = cache.state_dim
    b, horizon = actions.shape[:2]
    mean = x0s
    if full_cov:
        cov = init_state_var * torch.eye(
            ds, dtype=x0s.dtype, device=x0s.device).expand(b, ds, ds)
        means, covs = [mean], [cov]
        for t in range(horizon):
            mean, cov = _step_batched_full(cache, mean, cov, actions[:, t],
                                           action_var, delta)
            means.append(mean)
            covs.append(cov)
        return torch.stack(means, dim=1), torch.stack(covs, dim=1)
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


def _rollout_batched_lanes(cache: RolloutCache, x0s, actions, init_state_var,
                           action_var, delta, full_cov, mean_only,
                           frozen_cov_diag):
    """`rollout_batched` over a cache of one GP a lane (see there)."""
    g, b = cache.x.shape[0], x0s.shape[0]
    if b % g:
        raise ValueError(f'{b} scenarios do not split over {g} lanes')
    if full_cov or not (cache.tied_lambdas or mean_only
                        or frozen_cov_diag is not None):
        raise ValueError('a batched rollout of one GP a lane takes a '
                         'diagonal covariance and tied lengthscales (the '
                         "grouped trace is K1's); use rollout_lanes")
    k = b // g
    static = cache.static_key()

    def one(tensors, x0, u, cov_d):
        return rollout_batched(cache_from(static, tensors), x0, u,
                               init_state_var, action_var, delta,
                               mean_only=mean_only, frozen_cov_diag=cov_d)

    def lanes(v):
        return None if v is None else v.reshape(g, k, *v.shape[1:])

    means, covs = torch.func.vmap(
        one, in_dims=(0, 0, 0, None if frozen_cov_diag is None else 0))(
            cache.tensors(), lanes(x0s), lanes(actions),
            lanes(frozen_cov_diag))
    return means.reshape(b, *means.shape[2:]), covs.reshape(b, *covs.shape[2:])
