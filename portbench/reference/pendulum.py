"""The pendulum plant of the episode configuration, from its published
equations (the classic-control pendulum, with the configuration's gravity,
mass, length, time step, speed limit and torque limit):

  u       <- clip(u, -max_torque, max_torque)
  thdot'  <- clip(thdot + (3 g / (2 l) sin th + 3 / (m l^2) u) dt,
                  -max_speed, max_speed)
  th'     <- th + thdot' dt
"""

from __future__ import annotations

import torch


def step(plant: dict, x, u):
    """x (..., 2) states, u (..., 1) actions -> the next states, in the
    inputs' dtype."""
    th, thdot = x[..., 0], x[..., 1]
    u = torch.clamp(u[..., 0], -plant['max_torque'], plant['max_torque'])
    acc = (3.0 * plant['g'] / (2.0 * plant['l']) * torch.sin(th)
           + 3.0 / (plant['m'] * plant['l'] ** 2) * u)
    thdot = torch.clamp(thdot + acc * plant['dt'], -plant['max_speed'],
                        plant['max_speed'])
    return torch.stack([th + thdot * plant['dt'], thdot], dim=-1)
