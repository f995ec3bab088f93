"""Device default and the f32 precision policy.

The port runs on a CUDA card unless the caller asks for the CPU. It never
falls back to the CPU on its own: asking for CUDA where there is none raises.

f32 matrix products stay true f32. TF32 keeps about three decimal digits,
which the GP linear algebra and the cancellation-heavy variance trace cannot
afford; this is the counterpart of the JAX package's `f32_matmul_precision`.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = 'cuda'


def ensure_true_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN, and check that it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError('TF32 could not be turned off; the port needs true '
                           'f32 matrix products')


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says otherwise.
    Raises when CUDA is asked for (explicitly or by default) but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'gpmpc_tpu_torch runs on a CUDA device by default, but '
            "torch.cuda.is_available() is False; pass device='cpu' to run on "
            'the CPU.')
    ensure_true_f32()
    return dev
