"""Shared fixtures of the benchmark's tests: a copy of the benchmark in a
temporary checkout, cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The sizes a test run holds: the headline problem at N = 20 in 32, H = 4,
# 8 lanes, a few iterations a phase.
TINY_CONFIG = dict(n_train=20, capacity=32, horizon=4)
TINY_RECIPE = dict(n_starts=2, prune_to=2, budget1=4, shift_iters=3,
                   shift_smooth_iters=2, shift_lanes_per_chunk=4,
                   shift_max_lanes=4, polish_lanes=2, polish_iters=3,
                   neighbor_set=2)

# The tiny runs' own limits: on seeds 1-3 their sound runs read pg_median
# 3e-5-0.026, a solve's controls left at zero pg_median 1.35-5.0.
TINY_LIMITS = dict(stalled_share=0.25, bad_lanes=0)
# The GP-draw cell's: its sound tiny runs read pg_p10 below 1e-3.
TINY_LIMITS_GP = dict(pg_p10=0.05, no_descent_share=0.0, gap_share=0.01,
                      bad_lanes=0)
# The episode at N = 20 (+ 3) in 32, H = 4, 3 steps an episode.
TINY_EPISODE = dict(n_pretrain=20, capacity=32, horizon=4, steps=3)
TINY_LIMITS_EPISODE = dict(pg_p90=0.002, bad_lanes=0)


def copy_checkout(dst: str, lanes: int = 8) -> str:
    """BENCHMARK.json and portbench/ copied under dst, the headline
    configuration and the cells cut to the tiny sizes."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), dst)
    shutil.copytree(os.path.join(ROOT, 'portbench'),
                    os.path.join(dst, 'portbench'),
                    ignore=shutil.ignore_patterns('_cache', '__pycache__',
                                                  'tests'))
    bench = json.load(open(os.path.join(dst, 'BENCHMARK.json')))
    for c in bench['configs']:
        path = os.path.join(dst, c['file'])
        cfg = json.load(open(path))
        if 'n_pretrain' in cfg:
            cfg.update(TINY_EPISODE)
            cfg['solver'].update(max_iters=30)
            json.dump(cfg, open(path, 'w'))
            continue
        cfg.update(TINY_CONFIG)
        if 'recipe' in cfg:
            cfg['recipe'].update(TINY_RECIPE)
            cfg['refine'].update(max_iters=30)
            cfg['gp_draw_solver'].update(max_iters=30)
        json.dump(cfg, open(path, 'w'))
    for w in bench['workloads']:
        path = os.path.join(dst, 'portbench', 'workloads',
                            f'{w["name"]}.json')
        wl = json.load(open(path))
        wl.update(lanes=lanes, warmup_batches=1,
                  limits=(TINY_LIMITS_EPISODE if wl['entry'] == 'episode'
                          else TINY_LIMITS_GP if 'pg_p10' in wl['limits']
                          else TINY_LIMITS))
        json.dump(wl, open(path, 'w'))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return copy_checkout(str(tmp_path / 'checkout'))


def run_cell(root, cell, seed=12345, trace=0, runner=None, seconds=0.01):
    """One run of `cell` on the CPU: (exit code, the result line as a dict,
    standard error)."""
    import io
    from portbench import run
    out, err = io.StringIO(), io.StringIO()
    rc = (runner or run.run)(['--workload', cell, '--seed', str(seed),
                              '--seconds', str(seconds), '--trace',
                              str(trace)], root=root, require_cuda=False,
                             out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
