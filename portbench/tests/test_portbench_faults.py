"""Runs of the harness on the CPU with the timed path broken underneath:
each fault a cell can have has to come out not correct. A sound run beside
them has to come out correct."""

from __future__ import annotations

import pytest
import torch

from portbench import run as _run
from portbench.tests.conftest import run_cell

_ENTRY_CLASS = _run.Cell.entry_class

CELLS = ('pendulum_headline.recipe_b256', 'pendulum_headline.gpdraws_b256')
EPISODE = 'pendulum_episode.multistart_b256'


def _unchanged(res, x0s, entry):
    """A solver step that returns its state unchanged: the solve gives back
    its initial controls (zeros) and their cost."""
    del res
    u = torch.zeros_like(entry.last.u)
    return entry.last._replace(u=u, cost=entry.cost_of(x0s, u))


def _half(res, x0s, entry):
    """Half of the batch left out: the second half's answers are the first
    half's."""
    h = res.u.shape[0] // 2
    return res._replace(u=torch.cat([res.u[:h], res.u[:h]]),
                        cost=torch.cat([res.cost[:h], res.cost[:h]]))


def _altered(res, x0s, entry):
    """An answer altered where it is produced: the controls moved by 0.5
    (inside the box)."""
    return res._replace(u=torch.clamp(res.u + 0.5, -5.0, 5.0))


def _broken(fault):
    """A runner whose entries' solves pass through `fault`."""
    from portbench import run

    def runner(argv, **kw):
        orig = run.Cell.entry_class

        def entry_class(cell):
            base = orig(cell)

            class Broken(base):
                def solve(self, x0s):
                    res = base.solve(self, x0s)
                    self.last = res
                    return fault(res, x0s, self) if self.broken else res

                def setup(self):
                    self.broken = False
                    base.setup(self)
                    self.broken = True

                def cost_of(self, x0s, u):
                    from gpmpc_tpu_torch.dynamics import build_rollout_cache
                    from gpmpc_tpu_torch.parallel.batch import (
                        batch_objective, lanes_objective)
                    cfg = self.cfg
                    cache = build_rollout_cache(self.gp, cfg['state_dim'],
                                                cfg['action_dim'])
                    fn = (lanes_objective if self.gp.x.ndim == 3
                          else batch_objective)
                    with torch.no_grad():
                        return fn(cache, x0s, self.cost_params)(u)

            return Broken

        run.Cell.entry_class = entry_class
        try:
            return run.run(argv, **kw)
        finally:
            run.Cell.entry_class = orig

    return runner


def _wrong_draw(cell):
    """Each lane served its neighbour's GP draw: the program's stacked GP
    fitted from the draws rolled by one lane."""
    import numpy as np
    base = _orig_entry_class(cell)

    class Wrong(base):
        def make_gp(self):
            data = base.data
            self.data = lambda: tuple(np.roll(a, 1, axis=0)
                                      for a in data(self))
            try:
                return base.make_gp(self)
            finally:
                del self.data

    return Wrong


def _episode_fault(kind):
    """The episode's faults: a step that leaves the plant's state unchanged;
    half of the lanes served the other half's plans; each plan altered by
    0.5 where the solve returns it."""

    def entry_class(cell):
        base = _orig_entry_class(cell)

        class Broken(base):
            def solve(self, *args, **kw):
                res = base.solve(self, *args, **kw)
                if kind == 'half':
                    h = res.u.shape[0] // 2
                    return res._replace(
                        u=torch.cat([res.u[:h], res.u[:h]]),
                        cost=torch.cat([res.cost[:h], res.cost[:h]]))
                if kind == 'altered':
                    return res._replace(u=torch.clamp(res.u + 0.5, -5.0,
                                                      5.0))
                return res

            def plant(self, st, u):
                nxt, reward = base.plant(self, st, u)
                return (st, reward) if kind == 'unchanged' else (nxt, reward)

        return Broken

    return entry_class


def _with_entry(entry_class):
    from portbench import run

    def runner(argv, **kw):
        run.Cell.entry_class = entry_class
        try:
            return run.run(argv, **kw)
        finally:
            run.Cell.entry_class = _orig_entry_class

    return runner


def _orig_entry_class(cell):
    return _ENTRY_CLASS(cell)


@pytest.mark.parametrize('cell', CELLS + (EPISODE,))
def test_sound_run_is_correct(tiny_root, cell):
    rc, line, _ = run_cell(tiny_root, cell)
    assert rc == 0 and line['correct'] is True, line['compared']


@pytest.mark.parametrize('fault', [_unchanged, _half, _altered],
                         ids=['unchanged', 'half', 'altered'])
@pytest.mark.parametrize('cell', CELLS)
def test_fault_is_not_correct(tiny_root, cell, fault):
    rc, line, _ = run_cell(tiny_root, cell, runner=_broken(fault))
    assert rc == 0 and line['correct'] is False, line['compared']


def test_wrong_draw_is_not_correct(tiny_root):
    rc, line, _ = run_cell(tiny_root, CELLS[1],
                           runner=_with_entry(_wrong_draw))
    assert rc == 0 and line['correct'] is False, line['compared']


@pytest.mark.parametrize('kind', ['unchanged', 'half', 'altered'])
def test_episode_fault_is_not_correct(tiny_root, kind):
    rc, line, _ = run_cell(tiny_root, EPISODE,
                           runner=_with_entry(_episode_fault(kind)))
    assert rc == 0 and line['correct'] is False, line['compared']
