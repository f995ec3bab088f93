"""Compatibility facades with the reference's class API (port of
gpmpc_tpu/compat.py): `GaussianProcessRegression` (the reference's gpr.py)
and `Dynamics` (its dynamics.py), NumPy in and NumPy out, on the port's
GP state, exact posterior, training and rollout. The MPC and the simulator
are mpc/controller.py and sim/simulator.py.

As in the JAX package: setters refit at once (the reference needs a manual
`build_Ky_inv_mat()`, kept here as an explicit refit); factorizations are
Cholesky or eigh, never an explicit inverse or determinant; the training
buffer has a capacity (default 1024) and grows by repadding. The facades
run on CUDA unless device='cpu'.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.dynamics import build_rollout_cache, rollout
from gpmpc_tpu_torch.gp import state as gs
from gpmpc_tpu_torch.gp.exact import log_marginal_likelihood, predict
from gpmpc_tpu_torch.gp.kernels import se_gram, se_kernel
from gpmpc_tpu_torch.gp.train import train_hyperparams


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _append(state: gs.GPState, x, y) -> gs.GPState:
    """Append rows, growing the capacity (to max(needed, 2 x)) first when
    they would not fit."""
    n_new = int(state.count) + x.shape[0]
    if n_new > state.config.capacity:
        state = gs.grow(state, max(n_new, 2 * state.config.capacity))
    return gs.append(state, x, y)


class GaussianProcessRegression:
    """The reference's single-output exact GP (gpr.py): ARD-SE kernel and an
    optional nominal mean model f(xs (n, x_dim)) -> (n,)."""

    def __init__(self, x_dim: int, nominal_model: Optional[Callable] = None,
                 capacity: int = 1024, dtype=torch.float64, device=None):
        self.x_dim = int(x_dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        nominal_fn = None
        if nominal_model is not None:
            def nominal_fn(xs):
                return torch.reshape(nominal_model(xs), (-1, 1))
        self._cfg = gs.GPConfig(capacity=capacity, x_dim=x_dim, out_dim=1,
                                nominal_fn=nominal_fn)
        self.state = gs.make_gp(self._cfg, dtype=dtype, device=self.device)
        self.f_nom = nominal_model

    def _t(self, v) -> torch.Tensor:
        return torch.tensor(np.asarray(v, np.float64), dtype=self.dtype,
                            device=self.device)

    # -- data ------------------------------------------------------------
    @property
    def num_train(self) -> int:
        return int(self.state.count)

    @property
    def X_train(self) -> np.ndarray:
        return _np(self.state.x[:self.num_train])

    @property
    def y_train(self) -> np.ndarray:
        return _np(self.state.y[0, :self.num_train])[:, None]

    def append_train_data(self, x, y):
        """x: (x_dim,) or (n, x_dim); y: scalar or (n,)."""
        y = np.asarray(y, np.float64).reshape(-1, 1)
        x = np.asarray(x, np.float64).reshape(-1, self.x_dim)
        self.state = _append(self.state, x, y)

    # -- hyperparameters -------------------------------------------------
    def set_lambdas(self, lambdas):
        self.state = gs.set_hyperparams(self.state,
                                        lambdas=np.asarray(lambdas))

    def get_lambdas(self) -> np.ndarray:
        return _np(self.state.lambdas[0])

    def set_sigma_f(self, sigma_f: float):
        self.state = gs.set_hyperparams(self.state, sigma_f=float(sigma_f))

    def get_sigma_f(self) -> float:
        return float(self.state.sigma_f[0])

    def set_sigma_n(self, sigma_n: float):
        self.state = gs.set_hyperparams(self.state, sigma_n=float(sigma_n))

    def get_sigma_n(self) -> float:
        return float(self.state.sigma_n[0])

    # -- kernel matrices (the reference keeps them as attributes) --------
    @property
    def Kf(self) -> np.ndarray:
        n = self.num_train
        return _np(se_gram(self.state.x[:n], self.state.x[:n],
                           self.state.log_lambdas[0],
                           self.state.log_sigma_f[0]))

    @property
    def Ky(self) -> np.ndarray:
        n = self.num_train
        return self.Kf + float(self.state.sigma_n[0]) ** 2 * np.eye(n)

    @property
    def Ky_inv(self) -> np.ndarray:
        n = self.num_train
        return _np(self.state.kinv[0, :n, :n])

    def build_Ky_inv_mat(self):
        """Explicit refit (the setters already refit)."""
        self.state = gs.fit(self.state)

    def se_kernel(self, x1, x2) -> float:
        return float(se_kernel(self._t(x1).ravel(), self._t(x2).ravel(),
                               self.state.log_lambdas[0],
                               self.state.log_sigma_f[0]))

    # -- inference -------------------------------------------------------
    def compute_marginal_likelihood(self) -> float:
        return float(log_marginal_likelihood(self.state)[0])

    def compute_pred_train_covariance(self, X_pred) -> np.ndarray:
        xp = np.asarray(X_pred, np.float64)
        single = xp.ndim == 1
        k = _np(se_gram(self._t(np.atleast_2d(xp)), self.state.x,
                        self.state.log_lambdas[0],
                        self.state.log_sigma_f[0]))[:, :self.num_train]
        return k[0] if single else k

    def predict_latent_vars(self, X_pred, covar: bool = False,
                            targets: bool = False):
        xp = np.asarray(X_pred, np.float64)
        single = xp.ndim == 1
        with torch.no_grad():
            mean, cov = predict(self.state, self._t(np.atleast_2d(xp)),
                                full_cov=True, include_noise=targets)
        mean = _np(mean)[:, 0]
        if single:
            mean = mean[0]
        if not covar:
            return mean, None
        cov = _np(cov)[0]
        if single:
            cov = cov[0, 0]
        return mean, cov

    # -- training --------------------------------------------------------
    def update_hyperparams(self, num_iters: int = 1000, verbose: bool = False):
        res = train_hyperparams(self.state, num_iters=num_iters, lr=0.1,
                                tol=1e-5)
        self.state = res.state
        if verbose:
            print('iters:', res.iters, 'ml:', float(res.log_ml[0]),
                  'lambdas:', self.get_lambdas(),
                  'sigma_f:', self.get_sigma_f(),
                  'sigma_n:', self.get_sigma_n())
        return res


class _GPRView:
    """Per-output view into the shared multi-output GPState, so that
    reference-style code like `dynamics.gpr_err[i].set_sigma_n(1e-5)` works."""

    def __init__(self, owner: 'Dynamics', idx: int):
        self._owner = owner
        self._idx = idx

    def _hp(self, name: str, value):
        """Set output idx's hyperparameter `name` (natural space) and
        refit; a per-output lengthscale unties the rows."""
        s = self._owner.state
        field = 'log_' + name
        new = getattr(s, field).clone()
        new[self._idx] = torch.log(torch.as_tensor(
            np.asarray(value, np.float64), dtype=new.dtype, device=new.device))
        s = replace(s, **{field: new})
        if name == 'lambdas':
            s = replace(s, config=replace(s.config, tied_lambdas=False))
        self._owner.state = gs.fit(s)

    def set_lambdas(self, lambdas):
        self._hp('lambdas', lambdas)

    def set_sigma_f(self, sigma_f):
        self._hp('sigma_f', sigma_f)

    def set_sigma_n(self, sigma_n):
        self._hp('sigma_n', sigma_n)

    def get_lambdas(self):
        return _np(self._owner.state.lambdas[self._idx])

    def get_sigma_f(self):
        return float(self._owner.state.sigma_f[self._idx])

    def get_sigma_n(self):
        return float(self._owner.state.sigma_n[self._idx])

    @property
    def num_train(self):
        return int(self._owner.state.count)

    @property
    def X_train(self):
        return _np(self._owner.state.x[:self.num_train])

    @property
    def y_train(self):
        return _np(self._owner.state.y[self._idx, :self.num_train])[:, None]


class Dynamics:
    """The reference's dynamics.py: per-state-dimension GPs over
    x = (state | action), with the multi-step uncertain rollout.
    nominal_models: one f(s (n, ds), a (n, da)) -> (n,) per output."""

    def __init__(self, state_dim: int, action_dim: int,
                 nominal_models: Optional[Sequence[Callable]] = None,
                 capacity: int = 1024, dtype=torch.float64, device=None):
        self.state_dim = int(state_dim)
        self.action_dim = int(action_dim)
        self.device = resolve_device(device)
        nominal_fn = None
        if nominal_models is not None:
            models = list(nominal_models)

            def nominal_fn(xs):
                s, a = xs[:, :state_dim], xs[:, state_dim:]
                return torch.stack([m(s, a) for m in models], dim=1)

        self._cfg = gs.GPConfig(capacity=capacity,
                                x_dim=state_dim + action_dim,
                                out_dim=state_dim, nominal_fn=nominal_fn)
        self.state = gs.make_gp(self._cfg, dtype=dtype, device=self.device)
        self.gpr_err: List[_GPRView] = [_GPRView(self, i)
                                        for i in range(state_dim)]
        self.nominal_models = nominal_models

    def append_train_data(self, state, action, next_state):
        """Single or batched observations (the reference's semantics)."""
        state = np.atleast_2d(np.asarray(state, np.float64))
        action = np.asarray(action, np.float64)
        if action.ndim == 1 and state.shape[0] > 1:
            action = action[:, None]
        action = np.atleast_2d(action)
        next_state = np.atleast_2d(np.asarray(next_state, np.float64))
        self.state = _append(self.state,
                             np.concatenate([state, action], axis=1),
                             next_state)

    def forward_propagate(self, horizon: int, curr_state, actions):
        """H-step uncertain rollout: (state_means (H+1, ds), state_covars
        (H+1, ds, ds)) as NumPy."""
        cache = build_rollout_cache(self.state, self.state_dim,
                                    self.action_dim)
        dt, dev = self.state.x.dtype, self.state.x.device
        with torch.no_grad():
            means, covs = rollout(
                cache, torch.as_tensor(np.asarray(curr_state, np.float64),
                                       dtype=dt, device=dev),
                torch.as_tensor(np.asarray(actions, np.float64), dtype=dt,
                                device=dev).reshape(horizon, self.action_dim))
        return _np(means), _np(covs)

    # The reference keeps NumPy and torch twins; here there is one path.
    forward_propagate_torch = forward_propagate
