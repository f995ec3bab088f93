"""Analytic pendulum model pair, nominal (frictionless) and true (viscous
friction) (port of gpmpc_tpu/models/pendulum.py): m = 1, l = 1, b = 0.5,
g = 9.8, dt = 0.1.

The functions take batched x (N, 2+) with columns (theta, omega, ...) and u
(N,) or (N, 1), or a single x (2,) and u; the nominal models serve as
GPConfig.nominal_fn (the GP then fits the residual).
"""

from __future__ import annotations

import torch

m = 1.0
l = 1.0
b = 0.5
g = 9.8
delta_t = 0.1


def _cols(x, u):
    if x.ndim == 2:
        return x[:, 0], x[:, 1], torch.reshape(u, (-1,))
    return x[0], x[1], torch.reshape(u, ())


def nom_model_th(x, u):
    """theta_{k+1} = theta_k + omega_k dt."""
    th, om, _ = _cols(x, u)
    return th + om * delta_t


def nom_model_om(x, u):
    """Frictionless omega update."""
    th, om, uu = _cols(x, u)
    return -g / l * torch.sin(th) * delta_t + om + 1.0 / (m * l ** 2) * uu * delta_t


def true_model_th(x, u):
    """The nominal kinematics."""
    return nom_model_th(x, u)


def true_model_om(x, u):
    """The nominal omega update plus viscous friction -b/m omega dt."""
    th, om, uu = _cols(x, u)
    return (-b / m * om * delta_t - g / l * torch.sin(th) * delta_t + om
            + 1.0 / (m * l ** 2) * uu * delta_t)


def nominal_residual_fn(xu):
    """GPConfig.nominal_fn adapter: xu (N, 3) = (theta, omega, u) -> (N, 2),
    the nominal next state."""
    x, u = xu[:, :2], xu[:, 2]
    return torch.stack([nom_model_th(x, u), nom_model_om(x, u)], dim=1)
