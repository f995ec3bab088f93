"""gpmpc_tpu_torch.sim.render against gpmpc_tpu's (the counterparts of
tests/test_render.py): the pendulum and cartpole frames equal the JAX
package's pixel for pixel, from numpy and from tensor states, and the
recorder writes a GIF and PNG frames."""

import os

import numpy as np
import torch

from gpmpc_tpu.sim import render as jrender
from gpmpc_tpu_torch.sim.render import (EpisodeRecorder, cartpole_renderer,
                                        pendulum_renderer)


def test_pendulum_frame():
    render = pendulum_renderer(size=200)
    f0 = render(np.array([0.0, 0.0]))
    f1 = render(torch.tensor([2.0, 0.0], dtype=torch.float64),
                action=torch.tensor([3.0]))
    assert f0.shape == (200, 200, 3) and f0.dtype == np.uint8
    assert not np.array_equal(f0, f1)
    jr = jrender.pendulum_renderer(size=200)
    np.testing.assert_array_equal(f0, jr(np.array([0.0, 0.0])))
    np.testing.assert_array_equal(f1, jr(np.array([2.0, 0.0]),
                                         action=np.array([3.0])))


def test_cartpole_frame():
    render = cartpole_renderer(width=300, height=200)
    f0 = render(np.array([0.0, 0.0, 0.0, 0.0]))
    f1 = render(torch.tensor([1.0, 0.0, 0.6, 0.0]))
    assert f0.shape == (200, 300, 3) and f0.dtype == np.uint8
    assert not np.array_equal(f0, f1)
    np.testing.assert_array_equal(
        f1, jrender.cartpole_renderer(width=300, height=200)(
            np.array([1.0, 0.0, 0.6, 0.0])))


def test_recorder_writes_gif(tmp_path):
    rec = EpisodeRecorder(pendulum_renderer(size=120), fps=10)
    for th in np.linspace(0, np.pi, 6):
        rec.capture(np.array([th, 0.0]))
    path = rec.save(str(tmp_path / 'ep.gif'))
    assert os.path.getsize(path) > 500
    assert rec.save_frames(str(tmp_path / 'frames')) == 6
    assert len(os.listdir(tmp_path / 'frames')) == 6
