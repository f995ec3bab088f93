"""Chain-slope timing of a kernel on the card.

The method of the TPU probes (benchmarks/kernel_ablate.py:166-179, 195-219
and benchmarks/kernel_probe.py:109-143): a chain applies one step L times,

    a = u - x,  g = a M2,  q = sum(g a),  dv = exp(-q / 8),  ao = [1 | a],
    rw = kernel(g, dv, a, ao dv, blam),  t = sum_i rw[..., i, 0],
    u <- u + 1e-4 pad(t),

at L = 24 and L = 96; the slope (T96 - T24) / 72 is one step's time with the
fixed costs of a run cancelled. On CUDA each run is captured once as a CUDA
graph (`torch.cuda.graph`), so the host's enqueue is not in the time; the
replays are timed with CUDA events, a fresh u0 copied in before each (and
outside the timed span), interleaved across the programs, over ROUNDS
rounds, and the fastest replay of each (program, L) is kept. The
kernel-only mode captures L launches of the kernel alone on fixed inputs,
which gives the kernel's device time without the prep.

Launch counters count host calls, and a replay calls no wrapper: each
program reports the wrapper calls made while it was captured and the
launches its replays ran (captured calls x replays).

Off CUDA the programs run eagerly on the host clock. That keeps the path
testable on the CPU; those times say nothing about a card.
"""

from __future__ import annotations

import subprocess
import time

import torch
import torch.nn.functional as F

from gpmpc_tpu_torch.ops.kernels import variance_trace as vt

LENGTHS = (24, 96)
# Timed replays of each (program, L), interleaved: the K1-K4 rows of
# chip_smoke.py and the probes alike.
ROUNDS = 5


def kernel_args(u, m2, x, blam):
    """K1's arguments (g, dv, a, aod, blam) at u (B, d), as the tied trace
    preps them: m2 (B, d, d), or one (d, d) for every scenario; x (N, d),
    blam (E, N, N)."""
    if m2.dim() == 2:
        m2 = m2.expand(u.shape[0], *m2.shape)
    a, g, dv = vt._prep_tied(u, m2, x)
    aod = vt._aug(a) * dv[..., None]
    return [t.contiguous() for t in (g, dv, a, aod, blam)]


def chain_step(rw_fn, x, m2, blam):
    """One step of the probes' chain: u (B, d) -> u + 1e-4 pad(t(u)), with
    rw_fn(g, dv, a, aod, blam) -> rw (B, E, N, 1+d) the kernel under test;
    x (N, d), m2 (d, d), blam (E, N, N)."""
    d, e = x.shape[1], blam.shape[0]

    def step(u):
        rw = rw_fn(*kernel_args(u, m2, x, blam))
        t = torch.sum(rw[..., 0], dim=-1)                  # (B, E)
        return u + 1e-4 * F.pad(t, (0, d - e))
    return step


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _capture(run, counter):
    """A CUDA graph of run(), after two warm-up calls on a side stream, and
    the wrapper calls counted while it was captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = counter()
    with torch.cuda.graph(graph):
        run()
    torch.cuda.synchronize()
    return graph, counter() - before


def _measure(runs, device, refresh, counter):
    """{key: [ms per run]} over ROUNDS interleaved rounds, and {key: wrapper
    calls captured}. runs: {key: zero-arg callable}; refresh(key) fills the
    run's inputs before each timed run."""
    times = {key: [] for key in runs}
    if device.type != 'cuda':
        for _ in range(ROUNDS):
            for key, run in runs.items():
                refresh(key)
                t0 = time.perf_counter()
                run()
                times[key].append(1e3 * (time.perf_counter() - t0))
        return times, {key: 0 for key in runs}
    graphs, captured = {}, {}
    for key, run in runs.items():
        graphs[key], captured[key] = _capture(run, counter)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(ROUNDS):
        for key, graph in graphs.items():
            refresh(key)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
    return times, captured


def _slopes(names, times, captured, device):
    lo, hi = LENGTHS
    out = {}
    for name in names:
        best = {n: min(times[(name, n)]) for n in LENGTHS}
        out[name] = dict(
            us=1e3 * (best[hi] - best[lo]) / (hi - lo),
            min_ms={str(n): best[n] for n in LENGTHS},
            calls_captured={str(n): captured[(name, n)] for n in LENGTHS},
            launches=sum(captured[(name, n)] * ROUNDS for n in LENGTHS))
    return dict(timer=('CUDA graph replays, CUDA events'
                       if device.type == 'cuda'
                       else 'eager on the host clock: not a device time'),
                rounds=ROUNDS, results=out)


def chain_slopes(rw_fns, x, m2, blam, u0_pool, counter=lambda: 0):
    """Microseconds per chain step for each kernel of rw_fns ({name:
    rw_fn}), by the slope between L = 24 and 96. u0_pool (K, B, d) on the
    device holds the fresh starting points, one per timed run (K >= ROUNDS x
    2 x len(rw_fns)); counter() reads the wrappers' launch count."""
    device = x.device
    steps = {name: chain_step(fn, x, m2, blam) for name, fn in rw_fns.items()}
    inputs = {(name, n): torch.empty_like(u0_pool[0])
              for name in rw_fns for n in LENGTHS}
    feed = iter(range(len(u0_pool)))

    def program(name, n):
        def run():
            u = inputs[(name, n)]
            for _ in range(n):
                u = steps[name](u)
            return u
        return run

    def refresh(key):
        inputs[key].copy_(u0_pool[next(feed)])

    for key in inputs:
        inputs[key].copy_(u0_pool[0])
    runs = {(name, n): program(name, n) for name in rw_fns for n in LENGTHS}
    times, captured = _measure(runs, device, refresh, counter)
    return _slopes(list(rw_fns), times, captured, device)


def kernel_slopes(launches, device, counter=lambda: 0):
    """Microseconds per launch for each zero-arg callable of launches ({name:
    fn}, the kernel alone on fixed inputs), by the slope between L = 24 and
    96 back-to-back calls."""
    def program(fn, n):
        def run():
            for _ in range(n):
                fn()
        return run

    runs = {(name, n): program(fn, n) for name, fn in launches.items()
            for n in LENGTHS}
    times, captured = _measure(runs, torch.device(device), lambda key: None,
                               counter)
    return _slopes(list(launches), times, captured, torch.device(device))
