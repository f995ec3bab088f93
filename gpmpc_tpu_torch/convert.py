"""Carry a fitted GP across from the JAX package.

`gp_state_from_numpy` builds the port's GPState from the arrays of a JAX
GPState taken as numpy (`{name: np.asarray(getattr(state, name))}`), so both
packages compute on the same posterior. No refit happens.
"""

from __future__ import annotations

import numpy as np
import torch

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.gp.state import GPConfig, GPState

FIELDS = ('x', 'y', 'mask', 'count', 'log_lambdas', 'log_sigma_f',
          'log_sigma_n', 'kinv', 'beta', 'logdet', 'jitter_used')


def gp_state_from_numpy(fields: dict[str, np.ndarray], *, tied_lambdas: bool,
                        device=None, dtype=torch.float32) -> GPState:
    """fields: x (cap, D), y (E, cap), mask (cap,), count (), log_lambdas
    (E, D), log_sigma_f (E,), log_sigma_n (E,), kinv (E, cap, cap),
    beta (E, cap), logdet (E,), jitter_used (E,)."""
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise KeyError(f'gp_state_from_numpy: missing fields {missing}')
    dev = resolve_device(device)
    e, cap = np.shape(fields['y'])
    cfg = GPConfig(capacity=cap, x_dim=np.shape(fields['x'])[1], out_dim=e,
                   tied_lambdas=tied_lambdas)

    def t(name, dt=dtype):
        return torch.tensor(np.asarray(fields[name]), dtype=dt, device=dev)

    return GPState(config=cfg, x=t('x'), y=t('y'), mask=t('mask', torch.bool),
                   count=t('count', torch.int32),
                   log_lambdas=t('log_lambdas'), log_sigma_f=t('log_sigma_f'),
                   log_sigma_n=t('log_sigma_n'), kinv=t('kinv'), beta=t('beta'),
                   logdet=t('logdet'), jitter_used=t('jitter_used'))
