"""Checkpoint and resume of GP-MPC state (port of
gpmpc_tpu/utils/checkpoint.py), in the JAX package's .npz format: the
GPState's arrays under their field names (_ARRAY_FIELDS) and the static
config as the `__meta__` JSON string; a controller adds `<path>.ctrl.npz`
with its warm-start buffer and cost setup. A checkpoint written by either
package loads into the other.

nominal_fn is code, not data: it is not saved, and loading a checkpoint that
used one needs it passed in. The format has no `tied_lambdas`; load_gp
detects it from the lengthscale rows (it selects a kernel, never a result).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.gp.state import GPConfig, GPState, _rows_tied

_ARRAY_FIELDS = ('x', 'y', 'mask', 'count', 'log_lambdas', 'log_sigma_f',
                 'log_sigma_n', 'kinv', 'beta', 'logdet', 'jitter_used')


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_gp(path: str, state: GPState) -> None:
    """Write a GPState to `path` (.npz)."""
    cfg = state.config
    meta = dict(capacity=cfg.capacity, x_dim=cfg.x_dim, out_dim=cfg.out_dim,
                jitter=cfg.jitter, solve_backend=cfg.solve_backend,
                has_nominal=cfg.nominal_fn is not None)
    arrays = {f: _np(getattr(state, f)) for f in _ARRAY_FIELDS}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load_gp(path: str, nominal_fn=None, dtype=None, device=None) -> GPState:
    """Load a GPState onto `device` (CUDA unless given), in `dtype` (the
    file's float dtype unless given). A checkpoint saved with a nominal
    model needs the same callable as nominal_fn."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data['__meta__']))
        arrays = {f: data[f] for f in _ARRAY_FIELDS}
    if meta.pop('has_nominal') and nominal_fn is None:
        raise ValueError('checkpoint used a nominal model; pass nominal_fn=')

    def conv(name, arr):
        if name == 'mask':
            return torch.tensor(arr, dtype=torch.bool, device=dev)
        if name == 'count':
            return torch.tensor(arr, dtype=torch.int32, device=dev)
        return torch.tensor(arr, dtype=dtype, device=dev)

    cfg = GPConfig(nominal_fn=nominal_fn,
                   tied_lambdas=_rows_tied(arrays['log_lambdas']), **meta)
    return GPState(config=cfg, **{f: conv(f, a) for f, a in arrays.items()})


def save_controller(path: str, mpc) -> None:
    """Checkpoint a RiskSensitiveMPC: the GP state (<path>.gp.npz), the
    warm-start buffer and the cost setup (<path>.ctrl.npz), enough to resume
    a receding-horizon run exactly."""
    save_gp(path + '.gp.npz', mpc.gp)
    np.savez(path + '.ctrl.npz',
             last_traj=mpc.last_traj, Q=_np(mpc.Q), R=_np(mpc.R),
             R_delta=(_np(mpc.R_delta) if mpc.R_delta is not None
                      else np.zeros(0)),
             x_ref=_np(mpc.x_ref), u_ref=_np(mpc.u_ref), lb=mpc.lb, ub=mpc.ub,
             meta=json.dumps(dict(gamma=mpc.gamma, horizon=mpc.horizon,
                                  state_dim=mpc.state_dim,
                                  input_dim=mpc.input_dim,
                                  full_cov=mpc.full_cov,
                                  delta_dynamics=mpc.delta_dynamics)))


def load_controller(path: str, nominal_fn=None, device=None):
    """Rebuild a RiskSensitiveMPC from save_controller's files, on `device`
    (CUDA unless given), in the GP's dtype."""
    from gpmpc_tpu_torch.mpc.controller import RiskSensitiveMPC
    gp = load_gp(path + '.gp.npz', nominal_fn=nominal_fn, device=device)
    with np.load(path + '.ctrl.npz', allow_pickle=False) as d:
        meta = json.loads(str(d['meta']))
        r_delta = d['R_delta'] if d['R_delta'].size else None
        mpc = RiskSensitiveMPC(
            gamma=meta['gamma'], horizon=meta['horizon'],
            state_dim=meta['state_dim'], input_dim=meta['input_dim'],
            Q=d['Q'], R=d['R'], R_delta=r_delta,
            capacity=gp.config.capacity, full_cov=meta['full_cov'],
            delta_dynamics=meta['delta_dynamics'], dtype=gp.x.dtype,
            device=gp.x.device)
        mpc.gp = gp
        mpc.last_traj = d['last_traj']
        mpc.set_xref(d['x_ref'])
        mpc.set_uref(d['u_ref'])
        mpc.set_lb(d['lb'])
        mpc.set_ub(d['ub'])
    return mpc
