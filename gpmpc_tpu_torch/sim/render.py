"""Episode rendering and recording (port of gpmpc_tpu/sim/render.py).

Frame functions `state -> (H, W, 3) uint8` for the pendulum and the
cartpole, drawn on offscreen pygame surfaces (no display needed), and an
`EpisodeRecorder` that collects frames and writes an animated GIF
(imageio) or PNG frames (PIL). States and actions may be tensors on any
device; a frame reads them to the host. pygame is imported when a renderer
is made, never at import time.

Wire-up: `Simulator(..., renderer=pendulum_renderer(params),
video_path='episode.gif')` (sim/simulator.py).
"""

from __future__ import annotations

import math
import os
from typing import Callable

import numpy as np
import torch


def _host(v) -> np.ndarray:
    """A state or action as a flat numpy array (tensors read to the host)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v).ravel()


def _require_pygame():
    os.environ.setdefault('SDL_VIDEODRIVER', 'dummy')
    os.environ.setdefault('PYGAME_HIDE_SUPPORT_PROMPT', '1')
    import pygame
    return pygame


def pendulum_renderer(params=None, size: int = 400) -> Callable:
    """Frame renderer for the pendulum plant (state = (theta, theta_dot),
    theta = 0 upright): rod, axle and tip bob, and given the action a signed
    torque bar at the bottom."""
    pygame = _require_pygame()
    rod_len = 0.38 * size

    def render(state, action=None) -> np.ndarray:
        th = float(_host(state)[0])
        surf = pygame.Surface((size, size))
        surf.fill((255, 255, 255))
        cx = cy = size // 2
        # theta measured from upright, positive counterclockwise
        tip = (cx + rod_len * math.sin(th), cy - rod_len * math.cos(th))
        pygame.draw.line(surf, (204, 77, 77), (cx, cy), tip, width=8)
        pygame.draw.circle(surf, (204, 77, 77), (int(tip[0]), int(tip[1])), 14)
        pygame.draw.circle(surf, (0, 0, 0), (cx, cy), 6)
        if action is not None:
            u = float(_host(action)[0])
            # torque indicator: horizontal bar at the bottom, signed length
            half = int(0.25 * size * max(-1.0, min(1.0, u / 5.0)))
            pygame.draw.line(surf, (60, 60, 200), (cx, int(0.92 * size)),
                             (cx + half, int(0.92 * size)), width=6)
        return np.transpose(pygame.surfarray.array3d(surf), (1, 0, 2))

    return render


def cartpole_renderer(params=None, width: int = 600,
                      height: int = 400) -> Callable:
    """Frame renderer for the cartpole plant (state = (x, xdot, th, thdot)):
    track, cart, pole and axle."""
    pygame = _require_pygame()
    world_width = 4.8
    scale = width / world_width
    carty = int(0.75 * height)
    pole_len = scale * 1.0
    cart_w, cart_h = int(0.4 * scale), int(0.25 * scale)

    def render(state, action=None) -> np.ndarray:
        s = _host(state)
        x, th = float(s[0]), float(s[2])
        surf = pygame.Surface((width, height))
        surf.fill((255, 255, 255))
        pygame.draw.line(surf, (0, 0, 0), (0, carty), (width, carty), width=2)
        cartx = int(x * scale + width / 2.0)
        rect = pygame.Rect(cartx - cart_w // 2, carty - cart_h // 2,
                           cart_w, cart_h)
        pygame.draw.rect(surf, (50, 50, 50), rect)
        tip = (cartx + pole_len * math.sin(th),
               carty - cart_h // 4 - pole_len * math.cos(th))
        pygame.draw.line(surf, (202, 152, 101),
                         (cartx, carty - cart_h // 4),
                         (int(tip[0]), int(tip[1])), width=10)
        pygame.draw.circle(surf, (120, 120, 200),
                           (cartx, carty - cart_h // 4), 6)
        return np.transpose(pygame.surfarray.array3d(surf), (1, 0, 2))

    return render


class EpisodeRecorder:
    """Collects per-step frames and writes an animated GIF (and optionally
    PNG frames)."""

    def __init__(self, renderer: Callable, fps: int = 20):
        self.renderer = renderer
        self.fps = fps
        self.frames: list = []

    def capture(self, state, action=None):
        self.frames.append(self.renderer(state, action))

    def save(self, path: str) -> str:
        """Write the episode as an animated GIF; creates parent dirs.
        Returns the path."""
        if not self.frames:
            raise ValueError('no frames captured')
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        import imageio.v3 as iio
        iio.imwrite(path, np.stack(self.frames),
                    duration=1000.0 / self.fps, loop=0)
        return path

    def save_frames(self, directory: str) -> int:
        os.makedirs(directory, exist_ok=True)
        from PIL import Image
        for i, fr in enumerate(self.frames):
            Image.fromarray(fr).save(os.path.join(directory, f'{i:05d}.png'))
        return len(self.frames)
