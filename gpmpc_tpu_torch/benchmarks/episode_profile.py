"""Where one step of the batched multistart episode spends the card's time.

Runs chip_smoke.py's phase 9c episode (chip_smoke.episode_problem: the
pendulum GP of 300 pretrain points in capacity 512, H = 8, 256 x0s, the
multistart route, 100 iterations), its solves on the host-read loop
(solver's `_host_read_loop`, the loop a profile can count: torch.profiler
loses most kernel records of a conditional node's body; the fit's jitter
search stays a device loop, since the step's capture launches it), for
`--steps` steps, and traces
step `--step` (after the first, whose captures it does not want) under
torch.profiler. From the trace: the step's wall (host clock, synchronized),
the device busy time (the sum of its kernels' durations; kernels do not
overlap on one stream), the busy share, and the kernels' time by name and
launch shape (grid, block: K1's grouped form at its two shapes tells apart
by them), largest first. The kernel nodes the step's graph replays ran are
counted beside the trace's (utils/replay_counts.replays_run), so a trace
that lost records says so.

Run on the card's machine from the root of the repository:

    python -m gpmpc_tpu_torch.benchmarks.episode_profile --out DIR

(~3-5 min on one H100.) It prints the summary and writes
DIR/episode_profile.json; the trace itself stays in a temporary file. On
the CPU (`--device cpu --lanes 4`) it runs the same steps with the CPU's
activities only, as a rehearsal; its numbers are no device metric.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from collections import Counter, defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    return name.split('(')[0].split('<')[0].strip()


def kernel_table(trace_path: str) -> list:
    """The trace's device kernels summed by (name, grid, block): a list of
    dicts, largest total first."""
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    total, count, full = defaultdict(float), Counter(), {}
    for ev in events:
        if ev.get('cat') != 'kernel':
            continue
        args = ev.get('args', {})
        key = (_short(ev['name']), tuple(args.get('grid', ())),
               tuple(args.get('block', ())))
        total[key] += float(ev.get('dur', 0.0))
        count[key] += 1
        full.setdefault(key, ev['name'])
    rows = [dict(name=k[0], grid=list(k[1]), block=list(k[2]),
                 launches=count[k], us=total[k], full_name=full[k])
            for k in total]
    return sorted(rows, key=lambda r: -r['us'])


def profile_step(lanes: int, steps: int, step: int, device: str) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from gpmpc_tpu_torch.gp import state as gp_state
    from gpmpc_tpu_torch.mpc import solver
    from gpmpc_tpu_torch.sim import simulator
    from gpmpc_tpu_torch.utils import replay_counts
    dev = torch.device(device)
    cs.EPISODE_LANES = lanes
    problem = cs.episode_problem(dev)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == 'cuda' else [])
    trace = tempfile.NamedTemporaryFile(suffix='.json', delete=False).name
    out = {}
    orig = simulator._Clock.step

    @contextlib.contextmanager
    def traced(self, t, guard):
        if t != step:
            with orig(self, t, guard):
                yield
            return
        cs.sync(dev)
        before = replay_counts.replays_run()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with orig(self, t, guard):
                yield
            cs.sync(dev)
            out['wall_s'] = time.perf_counter() - t0
        out['replayed'] = cs.replayed_nodes(before,
                                            replay_counts.replays_run())
        prof.export_chrome_trace(trace)

    # The solves take the host-read loop; the fit's jitter search stays the
    # device's kept loop graph, which the step's capture launches between
    # its graphs (a host-read search cannot be captured).
    device_loop = gp_state._device_loop
    simulator._Clock.step = traced
    gp_state._device_loop = lambda d: (d.type == 'cuda'
                                       and solver.loop_form() == 'while')
    try:
        with solver._host_read_loop():
            cs.run_batched(problem, steps, 'multistart', guard=False)
        cs.sync(dev)
    finally:
        simulator._Clock.step = orig
        gp_state._device_loop = device_loop
    rows = kernel_table(trace)
    os.unlink(trace)
    busy_us = sum(r['us'] for r in rows)
    seen = Counter()
    for r in rows:
        seen[r['full_name']] += r['launches']
    replayed = out.pop('replayed')
    lost = sum(max(0, n - seen.get(k, 0)) for k, n in replayed.items())
    for r in rows:
        r['full_name'] = r['full_name'][:300]
    grouped = [r for r in rows if 'rw_tied' in r['name']]
    out.update(
        lanes=lanes, steps=steps, step=step, device=str(dev),
        kernels=sum(r['launches'] for r in rows), busy_ms=busy_us / 1e3,
        busy_share=busy_us / 1e6 / out['wall_s'],
        replayed_nodes=sum(replayed.values()), lost_records=lost,
        k1=[dict(r, share_of_busy=r['us'] / busy_us if busy_us else 0.0)
            for r in grouped],
        top=[dict(r, share_of_busy=r['us'] / busy_us if busy_us else 0.0)
             for r in rows[:25]])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--lanes', type=int, default=256)
    ap.add_argument('--steps', type=int, default=2)
    ap.add_argument('--step', type=int, default=1,
                    help='the step traced (0 is the first, with the captures)')
    args = ap.parse_args()
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('episode_profile: no CUDA device', file=sys.stderr)
        return 2
    card = None
    if args.device == 'cuda':
        from gpmpc_tpu_torch.benchmarks.chain import card_line
        card = card_line()
    res = dict(card=card, **profile_step(args.lanes, args.steps, args.step,
                                         args.device))
    print(f'card: {card}; step {args.step} of {args.steps} at {args.lanes} '
          f'lanes: wall {res["wall_s"]:.4f} s, device busy '
          f'{res["busy_ms"]:.2f} ms ({100 * res["busy_share"]:.1f} %), '
          f'{res["kernels"]} kernels ({res["replayed_nodes"]} graph nodes '
          f'replayed, {res["lost_records"]} records lost)', flush=True)
    for r in res['top']:
        print(f'  {r["us"] / 1e3:10.3f} ms {100 * r["share_of_busy"]:5.1f} % '
              f'x{r["launches"]:6d} {r["name"]} grid {r["grid"]} block '
              f'{r["block"]}', flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, 'episode_profile.json'), 'w') as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
