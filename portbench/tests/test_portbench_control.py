"""The control on the card has to make a run of each cell come out not
correct: the sweeps' every variance trace in f32 (the program's own
lower-precision path), the episode's reference in f32 put in the program's
place. At the cells' 256 lanes, one batch or two, or one episode; the
benchmark's own runs never run it. Needs an NVIDIA GPU: skips without
one."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from portbench.tests.conftest import ROOT, run_cell

CELLS = ('pendulum_headline.recipe_b256', 'pendulum_headline.gpdraws_b256',
         'pendulum_episode.multistart_b256')


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the control runs the kernels)')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(tmp_path, cell):
    _card()
    root = str(tmp_path / 'checkout')
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), root)
    shutil.copytree(os.path.join(ROOT, 'portbench'),
                    os.path.join(root, 'portbench'),
                    ignore=shutil.ignore_patterns('_cache', '__pycache__',
                                                  'tests'))
    path = os.path.join(root, 'portbench', 'workloads', f'{cell}.json')
    wl = json.load(open(path))
    wl.update(warmup_batches=1, warmup_episodes=1)
    json.dump(wl, open(path, 'w'))
    from portbench import control

    def runner(argv, root, require_cuda, out, err):
        import contextlib
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            return control.main(argv[:-2], root=root)

    rc, line, _ = run_cell(root, cell, seed=2024, runner=runner,
                           seconds=0.5)
    assert rc == 0 and line['correct'] is False, line['compared']
