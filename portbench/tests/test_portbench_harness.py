"""The harness: every piece found by name from its own file, a cell added
from new files alone, the result line, the frozen bounds, the work count."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import pytest

from portbench.tests.conftest import ROOT, run_cell

BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
CELLS = [w['name'] for w in BENCH['workloads']]
METRICS = [m['name'] for m in BENCH['per_layer']]


@pytest.mark.parametrize('cell', CELLS)
def test_cell_found_by_name(cell):
    from portbench.run import Cell
    c = Cell(cell)
    assert c.config_entry['file'].startswith('portbench/configs/')
    assert callable(c.entry_class())
    assert hasattr(c.work(), 'least_seconds')
    assert c.workload['rate_metric'] in {m['name'] for m in c.end_to_end}
    assert 'setup_s' in {m['name'] for m in c.end_to_end}
    assert c.per_layer, 'every cell reports a per-layer metric'
    for m in c.per_layer:
        assert m['moves'] in {e['name'] for e in c.end_to_end}


@pytest.mark.parametrize('metric', METRICS)
def test_metric_reader_found_by_name(metric):
    from portbench.run import Cell
    mod = Cell(CELLS[0]).metric(metric)
    assert callable(mod.read)


@pytest.mark.parametrize('config', [c['name'] for c in BENCH['configs']])
def test_config_file_states_precision_and_cuts(config):
    entry = next(c for c in BENCH['configs'] if c['name'] == config)
    cfg = json.load(open(os.path.join(ROOT, entry['file'])))
    assert cfg['name'] == config and cfg['source'] == entry['source']
    assert cfg['reduced'] == entry['reduced']
    assert 'assumed' in cfg
    assert cfg['precision']['storage'] in ('float32', 'float64')
    assert {k: v for k, v in cfg['precision'].items() if k != 'storage'} \
        == dict(gp_fit='float64', variance_trace='float64', tf32=False)


def _tree_hashes(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, 'rb').read()).hexdigest()
    return out


def test_new_cell_from_new_files_only(tiny_root):
    """A configuration, a cell and a per-layer metric added as new files and
    new entries run, and no file that was there changes."""
    pb = os.path.join(tiny_root, 'portbench')
    before = _tree_hashes(pb)
    cfg = json.load(open(os.path.join(pb, 'configs',
                                      'pendulum_headline.json')))
    cfg.update(name='pendulum_small', n_train=16)
    json.dump(cfg, open(os.path.join(pb, 'configs', 'pendulum_small.json'),
                        'w'))
    shutil.copy(os.path.join(pb, 'work', 'pendulum_headline.py'),
                os.path.join(pb, 'work', 'pendulum_small.py'))
    wl = json.load(open(os.path.join(
        pb, 'workloads', 'pendulum_headline.recipe_b256.json')))
    wl.update(lanes=4)
    json.dump(wl, open(os.path.join(pb, 'workloads',
                                    'pendulum_small.recipe_b4.json'), 'w'))
    with open(os.path.join(pb, 'metrics', 'lanes_per_unit.sweep.py'),
              'w') as f:
        f.write('def read(ctx):\n'
                '    return ctx["work"] / len(ctx["records"])\n')
    bench = json.load(open(os.path.join(tiny_root, 'BENCHMARK.json')))
    bench['configs'].append(dict(bench['configs'][0], name='pendulum_small',
                                 file='portbench/configs/'
                                      'pendulum_small.json'))
    bench['workloads'].append(dict(bench['workloads'][-1],
                                   name='pendulum_small.recipe_b4',
                                   config='pendulum_small',
                                   traffic='recipe_b4'))
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'workloads' in m:
            m['workloads'].append('pendulum_small.recipe_b4')
    bench['per_layer'].append(dict(bench['per_layer'][1],
                                   name='lanes_per_unit.sweep',
                                   unit='lanes',
                                   workloads=['pendulum_small.recipe_b4']))
    json.dump(bench, open(os.path.join(tiny_root, 'BENCHMARK.json'), 'w'))
    rc, line, _ = run_cell(tiny_root, 'pendulum_small.recipe_b4', trace=1)
    assert rc == 0 and line['correct'] is True
    assert line['metrics']['lanes_per_unit.sweep']['value'] == 4.0
    after = _tree_hashes(pb)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize('trace', [0, 1])
def test_last_line_keys(tiny_root, trace):
    rc, line, err = run_cell(tiny_root, 'pendulum_headline.recipe_b256',
                             trace=trace)
    assert rc == 0
    assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                              'device']
    assert list(line)[-1] == 'compared'
    assert set(line['device']) >= {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}
    for k, v in line['compared'].items():
        assert set(v) == {'value', 'limit'}
    want = {'solves_per_s', 'setup_s'} if not trace else {
        'iters_per_lane.sweep', 'captures_in_window.sweep'}
    assert want <= set(line['metrics'])
    tail = err.strip().splitlines()[-len(line['compared']):]
    assert [t.split()[0] for t in tail] == list(line['compared'])


@pytest.mark.parametrize('shape,want', [
    ((256, 256, 256, 3, 2, 1), 0.0178),
    ((3584, 256, 256, 3, 2, 1), 0.2498),
])
def test_bound_ms_against_perf_table(shape, want):
    from portbench.bounds import bound_ms
    ms, what = bound_ms(*shape, f64=True)
    assert what == 'operations' and round(ms, 4) == want


def test_bound_ms_grouped_against_perf_table():
    from portbench.bounds import bound_ms
    ms, what = bound_ms(1280, 512, 512, 3, 2, 1, f64=True, groups=256,
                        blam_bytes=4)
    assert what == 'operations' and round(ms, 4) == 0.3569
    ms, what = bound_ms(256, 512, 512, 3, 2, 1, f64=True, groups=256,
                        blam_bytes=4)
    assert what == 'bytes' and round(ms, 4) == 0.1662


def test_work_count_by_hand():
    """Two lanes of 3 and 5 iterations, H = 2, N = 4, D = 3, E = 2: 16
    iterations x 2 steps x 16 pairs, each pair 1 + 22 + 2 flops on the
    vector pipe and 6 + 16 on the tensor cores."""
    import torch
    from portbench.run import Cell
    work = Cell(CELLS[0]).work()
    ctx = dict(config=dict(n_train=4, state_dim=2, action_dim=1, horizon=2),
               records=[dict(iters=torch.tensor([3, 5])),
                        dict(iters=torch.tensor([8]))])
    pairs = 16 * 2 * 16
    want = pairs * 25 / 34e12 + pairs * 22 / 67e12
    assert work.least_seconds(ctx) == pytest.approx(want, rel=1e-12)


def test_episode_work_count_by_hand():
    """One episode of two lanes and two steps, H = 2, D = 3, E = 2, four
    pretrain points: step 0 (N = 4) iterations 3 + 5, step 1 (N = 5) 1 + 2,
    each x 2 steps of N^2 pairs at 1 + 22 + 2 flops on the vector pipe and
    6 + 16 on the tensor cores; and a Cholesky a lane a step, 2 N^3 / 3
    flops on the tensor cores."""
    import torch
    from portbench.run import Cell
    work = Cell('pendulum_episode.multistart_b256').work()
    ctx = dict(config=dict(n_pretrain=4, state_dim=2, action_dim=1,
                           horizon=2),
               records=[dict(steps=2, lanes=2,
                             iters=torch.tensor([[3, 1], [5, 2]]))])
    want = 0.0
    for iters, n in ((8, 4), (3, 5)):
        pairs = iters * 2 * n * n
        want += pairs * 25 / 34e12 + pairs * 22 / 67e12
        want += 2 * (2 * n ** 3 / 3) / 67e12
    assert work.least_seconds(ctx) == pytest.approx(want, rel=1e-12)
