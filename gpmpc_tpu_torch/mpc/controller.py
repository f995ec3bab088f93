"""RiskSensitiveMPC: the stateful single-plant controller over the functional
core (port of gpmpc_tpu/mpc/controller.py).

The reference controller's surface: the constructor, `set_ub/set_lb/
set_xref/set_uref`, a `dynamics` handle with `append_train_data`, the zero
trajectory while the GP has no data, and the `last_traj` buffer whose first
action seeds the R_delta rate cost. NumPy in and out at this layer; below it
the GP, the rollouts and the solve run in torch on the controller's device
(CUDA unless device='cpu').

`_solve` routes a solve as the JAX package does, in its order:
  (a) solver_recipe='multistart' (L-BFGS, diagonal covariance, no nominal
      model): `parallel.batch.solve_batch_multistart` at B = 1 with the
      shifted last trajectory as an extra start;
  (b) L-BFGS without a nominal model: the batched rollout and the lockstep
      solver at B = 1, whose variance trace runs K1 (tied lengthscales) or
      K2 (untied, e.g. after `train_gp`);
  (c) otherwise (Adam, or a nominal model) the single-scenario rollout
      and the lockstep solver of the configured method at B = 1
      (`parallel.batch.lanes_objective`, `solver.solve_trajectory_batched`).
JAX jits `_solve` and keeps the compiled program for every later step.
Here routes (b) and (c), with a diagonal or a full covariance, solve
through the solver's kept program (mpc/solver.py, `_run_graphed`): the
first step captures it and every later step with the same key replays it.
`append` changes the GP's values, not its shapes, so the steps between two
`train_gp` / `set_gp_hyperparams` calls that flip the tied lengthscales, or
two `grow` calls, share one program. Route (a)'s solves keep theirs inside
`solve_batch_multistart`. A nominal model is captured like the rest of the
step: one that reads a value on the host raises; the step never falls back
to an eager loop.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.dynamics import build_rollout_cache
from gpmpc_tpu_torch.gp import state as gp_state
from gpmpc_tpu_torch.mpc.cost import CostParams, risk_sensitive_cost
from gpmpc_tpu_torch.mpc.solver import (SolverConfig, SolveResult,
                                        first_lane, solve_trajectory_batched)


def single_cost(params: CostParams, means, covs, u) -> torch.Tensor:
    """The risk-sensitive cost of one trajectory: means (H+1, ds),
    covs (H+1, ds, ds), u (H, da) -> ()."""
    return risk_sensitive_cost(params, means[None], covs[None], u[None])[0]


def _solve(gp, state_dim, action_dim, x0, u_init, lb, ub, params: CostParams,
           solver_config: SolverConfig, full_cov: bool, delta_dynamics: bool,
           solver_recipe: str = 'single', n_starts: int = 4,
           recipe_kwargs=()) -> SolveResult:
    """One solve from x0 (ds,) with start u_init (H, da), by route (a), (b)
    or (c) of the module docstring. params.u_prev is (da,)."""
    cache = build_rollout_cache(gp, state_dim, action_dim)
    lbfgs = solver_config.method == 'lbfgs'
    if (solver_recipe == 'multistart' and cache.nominal_fn is None
            and not full_cov and lbfgs):
        from gpmpc_tpu_torch.parallel.batch import solve_batch_multistart
        # u_prev gets an explicit (B = 1, da) lane axis (the rank rule).
        params_b = (params._replace(u_prev=params.u_prev[None])
                    if params.u_prev is not None else params)
        return first_lane(solve_batch_multistart(
            gp, state_dim, action_dim, x0[None], params_b, u_init.shape[0],
            lb, ub, solver_config, n_starts=n_starts, delta=delta_dynamics,
            extra_starts=u_init[None, None], **dict(recipe_kwargs)))

    from gpmpc_tpu_torch.parallel.batch import batch_objective, lanes_objective
    if cache.nominal_fn is None and lbfgs:
        return first_lane(solve_trajectory_batched(
            batch_objective(cache, x0[None], params, delta_dynamics,
                            full_cov), u_init[None], lb, ub, solver_config))
    return first_lane(solve_trajectory_batched(
        lanes_objective(cache, x0[None], params, delta_dynamics, full_cov),
        u_init[None], lb, ub, solver_config))


class _DynamicsHandle:
    """The reference's `mpc.dynamics` surface."""

    def __init__(self, owner: 'RiskSensitiveMPC'):
        self._owner = owner

    @property
    def gp(self) -> gp_state.GPState:
        return self._owner.gp

    def append_train_data(self, state, action, next_state):
        """state (ds,) | (n, ds), action (da,) | (n, da) | (n,), next_state
        as state; array-likes or tensors. In delta-dynamics mode the stored
        target is next_state - state. The rows go to the GP's device and the
        GP refits there."""
        o = self._owner
        dev = o.gp.x.device

        def f64(v):
            if isinstance(v, torch.Tensor):
                return v.to(device=dev, dtype=torch.float64)
            return torch.tensor(np.asarray(v, np.float64), device=dev)

        state = torch.atleast_2d(f64(state))
        next_state = torch.atleast_2d(f64(next_state))
        action = f64(action)
        if action.ndim == 1 and state.shape[0] > 1:
            action = action[:, None]
        action = torch.atleast_2d(action)
        x = torch.cat([state, action], dim=1)
        y = next_state - state if o.delta_dynamics else next_state
        o.gp = gp_state.append(o.gp, x, y)


class RiskSensitiveMPC:
    def __init__(self, gamma, horizon, state_dim, input_dim, Q, R,
                 R_delta=None, capacity: int = 512,
                 solver: Optional[SolverConfig] = None,
                 full_cov: bool = False, dtype=torch.float32,
                 jitter: float = 0.0, delta_dynamics: bool = False,
                 solver_recipe: str = 'single', n_starts: int = 4,
                 recipe_kwargs: dict = None, device=None):
        """delta_dynamics=True learns state increments (x' = x + f(x, u))
        and propagates the exact input-output covariance.
        solver_recipe='multistart' runs every solve through
        `solve_batch_multistart` with `n_starts` starts (and
        `recipe_kwargs`); it needs L-BFGS, a diagonal covariance and no
        nominal model, else the solve takes route (b) or (c). `device`
        defaults to CUDA."""
        self.device = resolve_device(device)
        self.gamma = float(gamma)
        self.horizon = int(horizon)
        self.state_dim = int(state_dim)
        self.input_dim = int(input_dim)
        self.dtype = dtype
        self.full_cov = bool(full_cov)
        self.delta_dynamics = bool(delta_dynamics)
        self.solver_config = solver or SolverConfig()
        self.solver_recipe = solver_recipe
        self.n_starts = int(n_starts)
        self.recipe_kwargs = tuple(sorted((recipe_kwargs or {}).items()))

        self.Q = self._t(Q).reshape(state_dim, state_dim)
        self.R = self._t(R).reshape(input_dim, input_dim)
        self.R_delta = (None if R_delta is None
                        else self._t(R_delta).reshape(input_dim, input_dim))
        self.x_ref = self._t(np.zeros(state_dim))
        self.u_ref = self._t(np.zeros(input_dim))
        self.ub = np.full((input_dim,), 1e16)
        self.lb = np.full((input_dim,), -1e16)

        cfg = gp_state.GPConfig(capacity=capacity,
                                x_dim=state_dim + input_dim,
                                out_dim=state_dim, jitter=jitter)
        self.gp = gp_state.make_gp(cfg, dtype=dtype, device=self.device)
        self.dynamics = _DynamicsHandle(self)
        # The last solved trajectory; its first action seeds the du cost.
        self.last_traj = np.zeros((self.horizon, self.input_dim))
        self.last_result: Optional[SolveResult] = None

    def _t(self, v) -> torch.Tensor:
        """An array-like as a tensor of the controller's dtype and device."""
        return torch.tensor(np.asarray(v, np.float64), dtype=self.dtype,
                            device=self.device)

    # -- the reference's setters --------------------------------------------
    def set_ub(self, ub: Sequence[float]):
        assert len(ub) == self.input_dim
        self.ub = np.asarray(ub, np.float64)

    def set_lb(self, lb: Sequence[float]):
        assert len(lb) == self.input_dim
        self.lb = np.asarray(lb, np.float64)

    def set_xref(self, x_ref):
        assert len(x_ref) == self.state_dim
        self.x_ref = self._t(x_ref)

    def set_uref(self, u_ref):
        assert len(u_ref) == self.input_dim
        self.u_ref = self._t(u_ref)

    # ------------------------------------------------------------------------
    def set_gp_hyperparams(self, lambdas=None, sigma_f=None, sigma_n=None):
        """Set the GP's hyperparameters (natural space) and refit."""
        self.gp = gp_state.set_hyperparams(self.gp, lambdas, sigma_f, sigma_n)

    def train_gp(self, num_iters: int = 1000, lr: float = 0.1,
                 min_sigma_n: Optional[float] = None, **kw):
        """Marginal-likelihood training of the GP's hyperparameters
        (gp/train.py). The noise floor defaults to 1e-2 for an f32
        controller, 0 for f64."""
        from gpmpc_tpu_torch.gp.train import train_hyperparams
        if min_sigma_n is None:
            min_sigma_n = 1e-2 if self.dtype == torch.float32 else 0.0
        res = train_hyperparams(self.gp, num_iters=num_iters, lr=lr,
                                min_sigma_n=min_sigma_n, **kw)
        self.gp = res.state
        return res

    def _params(self, x_ref=None, u_ref=None) -> CostParams:
        return CostParams(
            Q=self.Q, R=self.R, gamma=self._t(self.gamma),
            x_ref=self.x_ref if x_ref is None else self._t(x_ref),
            u_ref=self.u_ref if u_ref is None else self._t(u_ref),
            R_delta=self.R_delta, u_prev=self._t(self.last_traj[0]))

    def cost(self, means, u, covs, x_ref=None, u_ref=None) -> float:
        """The risk-sensitive cost of a given trajectory: means (H+1, ds),
        u (H, da), covs (H+1, ds, ds)."""
        with torch.no_grad():
            return float(single_cost(self._params(x_ref, u_ref),
                                     self._t(means), self._t(covs),
                                     self._t(u)))

    def get_optimal_trajectory(self, curr_state) -> np.ndarray:
        """The optimal (horizon, input_dim) action trajectory from
        `curr_state`, as numpy f64; zeros until the GP has data. Under
        multistart the last trajectory, shifted one step (last action held),
        joins the starts; otherwise the solve starts cold at u = 0."""
        if int(self.gp.count) == 0:
            return np.zeros((self.horizon, self.input_dim))
        if self.solver_recipe == 'multistart':
            u_init = self._t(np.concatenate([self.last_traj[1:],
                                             self.last_traj[-1:]], 0))
        else:
            u_init = self._t(np.zeros((self.horizon, self.input_dim)))
        result = _solve(
            self.gp, self.state_dim, self.input_dim,
            self._t(curr_state).reshape(self.state_dim), u_init,
            self._t(self.lb), self._t(self.ub), self._params(),
            self.solver_config, self.full_cov, self.delta_dynamics,
            self.solver_recipe, self.n_starts, self.recipe_kwargs)
        self.last_result = result
        u = result.u.detach().cpu().numpy().astype(np.float64)
        self.last_traj = u
        return u
