"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (kernels built into the program's in-checkout cache, inputs made
from the seed, the GPs fitted, this cell's shapes warmed up), then the
window: units of the cell's work (a batch, an episode) back to back until
`--seconds` have passed, each ending in a synchronisation; then, with
--trace 1, one more unit (or the entry's shorter `traced` one) under the
profiler; then the program's state is
freed and the reference judges every unit of the window. The last line of
standard output is one JSON object: correct, attempted, failed, metrics
(--trace 0: the cell's end-to-end metrics, --trace 1: its per-layer ones),
device, with --trace 1 breakdown, and last `compared`: each number the
judgement compared, with its limit. The same numbers and limits are the
last lines of standard error.

Everything the cell is made of is found by name under portbench/:
configs/<config>.json, workloads/<cell>.json (the entry it drives, its
lanes, its limits), entries/<entry>.py, metrics/<metric>.py and
work/<config>.py. BENCHMARK.json at the checkout's root lists the cells and
metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level modules a run may not hold once its window has closed: JAX, and
# the JAX package the port was made from (compared whole: gpmpc_tpu_torch
# is the program).
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'gpmpc_tpu')


def load(path: str, name: str):
    """The module of a file, loaded by path (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's pieces, found by name from BENCHMARK.json under `root`."""

    def __init__(self, name: str, root: str = ROOT):
        bench = read_json(os.path.join(root, 'BENCHMARK.json'))
        cells = {w['name']: w for w in bench['workloads']}
        if name not in cells:
            raise KeyError(f'no cell {name!r} in BENCHMARK.json')
        self.entry = cells[name]
        configs = {c['name']: c for c in bench['configs']}
        self.config_entry = configs[self.entry['config']]
        self.config = read_json(os.path.join(root,
                                             self.config_entry['file']))
        self.base = os.path.join(root, 'portbench')
        self.workload = read_json(os.path.join(self.base, 'workloads',
                                               f'{name}.json'))
        self.end_to_end = [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in bench['per_layer']
                          if name in m.get('workloads', [name])]

    def module(self, *parts: str):
        path = os.path.join(self.base, *parts[:-1], parts[-1] + '.py')
        return load(path, 'portbench_' + '_'.join(parts).replace('.', '_'))

    def entry_class(self):
        return self.module('entries', self.workload['entry']).Entry

    def metric(self, name: str):
        return self.module('metrics', name)

    def work(self):
        return self.module('work', self.entry['config'])


def forbidden_modules() -> list:
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program builds its own into gpmpc_tpu_torch/_build/)."""
    cache = os.path.join(root, 'portbench', '_cache')
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = os.path.join(cache, sub)
    os.environ['USE_FLAX'] = '0'


def device_of(torch, chips: int, require_cuda: bool):
    if not require_cuda:
        return torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    if not torch.cuda.is_available():
        raise SystemExit('portbench: torch.cuda.is_available() is false')
    if torch.cuda.device_count() < chips:
        raise SystemExit(f'portbench: the cell needs {chips} cards, '
                         f'{torch.cuda.device_count()} visible')
    return torch.device('cuda', 0)


def sync(torch, dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def run(argv=None, root: str = ROOT, require_cuda: bool = True,
        t_start: float = T_START, out=None, err=None,
        config_tweak=None) -> int:
    """One run of a cell; returns the exit code. `root` is the checkout
    (tests pass one of their own); require_cuda=False lets the tests drive
    a run on the CPU; config_tweak(config) switches the control's path on
    (control.py)."""
    out, err = out or sys.stdout, err or sys.stderr
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, root)
    if config_tweak is not None:
        config_tweak(cell.config)
    cache_dirs(root)
    import torch
    dev = device_of(torch, int(cell.entry['chips']), require_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench.counters import Recorder
    from portbench import trace as tr

    needs = set()
    if args.trace:
        for m in cell.per_layer:
            needs.update(getattr(cell.metric(m['name']), 'NEEDS', ()))
    recorder = Recorder(shapes='k1_shapes' in needs)
    entry = cell.entry_class()(cell.config, cell.workload, args.seed, dev)
    traced = getattr(entry, 'traced', entry.unit)
    try:
        entry.setup()
        sync(torch, dev)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        captures0 = recorder.captures
        records = []
        sampling = args.trace and dev.type == 'cuda'
        with (tr.NvmlSampler() if sampling
              else contextlib.nullcontext()) as sampler:
            while True:
                records.append(entry.unit(len(records)))
                sync(torch, dev)
                if time.perf_counter() - t0 >= args.seconds:
                    break
        window_s = time.perf_counter() - t0
        note(err, f'set-up {setup_s:.3f} s; window {len(records)} units in '
                  f'{window_s:.3f} s')
        ctx = dict(cell=cell, config=cell.config, records=records,
                   window_s=window_s, work=entry.work(records),
                   captures_in_window=recorder.captures - captures0,
                   nvml=sampler.samples if sampling else None,
                   programs=program_census(), profile=None)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == 'cuda' else 0)
        if args.trace and dev.type == 'cuda':
            # One more unit under the profiler, on the host-read loop: the
            # profiler loses most records of a conditional node's body, so
            # the device loop's trace cannot be read (PERF.md). Its
            # programs are captured by a unit run first.
            from gpmpc_tpu_torch.mpc import solver
            with solver._host_read_loop():
                traced(-101)
                since = recorder.snapshot()
                prof = tr.profile(lambda: traced(-102),
                                  lambda: sync(torch, dev))
                prof['k1_launches'] = recorder.launches(since)
            ctx['profile'] = prof
            note(err, f'profile: {len(prof["records"])} device records, '
                      f'busy {prof["busy_s"]:.4f} of {prof["window_s"]:.4f} '
                      f's, read in {prof["read_s"]:.2f} s')
        entry.release()
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        compared = entry.check(records)
        note(err, f'judged in {time.perf_counter() - t_check:.3f} s; read '
                  f'beside (not compared): '
                  f'{getattr(entry, "diagnostics", {})}')
    finally:
        recorder.remove()
        getattr(entry, 'restore', lambda: None)()
    limits = cell.workload['limits']
    correct = all(math.isfinite(compared[k]) and compared[k] <= limits[k]
                  for k in limits)
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.metric(m['name']).read(ctx)
            if v is not None:
                metrics[m['name']] = dict(value=float(v), unit=m['unit'])
    else:
        values = dict(setup_s=setup_s)
        values[cell.workload['rate_metric']] = ctx['work'] / window_s
        metrics = {m['name']: dict(value=float(values[m['name']]),
                                   unit=m['unit'])
                   for m in cell.end_to_end}
    device = dict(platform='gpu' if dev.type == 'cuda' else dev.type,
                  kind=(torch.cuda.get_device_name(dev)
                        if dev.type == 'cuda' else 'cpu'),
                  count=int(cell.entry['chips']), memory_peak_bytes=int(peak))
    line = dict(correct=bool(correct), attempted=int(ctx['work']),
                failed=int(compared.get('bad_lanes', 0)), metrics=metrics,
                device=device)
    if args.trace and ctx['profile'] is not None:
        device['busy_s'] = ctx['profile']['busy_s']
        device['window_s'] = ctx['profile']['window_s']
        line['breakdown'] = ctx['profile']['breakdown']
    line['compared'] = {k: dict(value=compared[k], limit=limits[k])
                        for k in limits}
    bad = forbidden_modules()
    if bad:
        print(f'portbench: the run loaded {bad}', file=err)
        return 3
    for k in limits:
        print(f'{k} {compared[k]!r} limit {limits[k]!r}', file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0


def note(err, msg: str) -> None:
    print(f'portbench: {msg}', file=err, flush=True)


def program_census() -> dict:
    """The solver's kept programs: their count, bytes, and the kernel nodes
    of each one's step graph."""
    from gpmpc_tpu_torch.mpc import solver
    stats = solver.program_stats()
    stats['step_kernels'] = [sum(p.step_counts.names.values())
                             for p in solver._PROGRAMS.values()]
    return stats


def main() -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return run()


if __name__ == '__main__':
    sys.exit(main())
