"""What a traced run reads beside the window: NVML's utilization of the card
sampled while the window runs, and a torch.profiler trace of one more unit
of the cell's work after it (busy seconds, the top device operations, the
longest idle gaps, each kernel's recorded times).

The profiler loses most records of a CUDA graph's conditional body, so its
busy time is a lower bound on the device's (PERF.md).
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Optional


class NvmlSampler:
    """`nvidia-smi` printing the card's utilization.gpu every ~100 ms while
    the block runs; `samples` the readings (%). No reading leaves it empty."""

    def __init__(self, index: int = 0, period_ms: int = 100):
        self.cmd = ['nvidia-smi', '-i', str(index),
                    '--query-gpu=utilization.gpu',
                    '--format=csv,noheader,nounits', f'-lms={period_ms}']
        self.samples: list = []
        self.proc: Optional[subprocess.Popen] = None
        self.reader: Optional[threading.Thread] = None

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
            return self
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            line = line.strip()
            if line.isdigit():
                self.samples.append(float(line))

    def __exit__(self, *exc):
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)
        return False


def _attr(e, *names):
    for n in names:
        f = getattr(e, n, None)
        if f is not None:
            return f()
    raise AttributeError(names)


def device_records(prof) -> list:
    """(name, start s, end s) of every device record of a finished
    torch.profiler.profile, read from kineto's own events (the profiler's
    tree of function events is never built: it costs ~1 s a thousand)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = _attr(e, 'start_ns', 'start_us')
        dur = _attr(e, 'duration_ns', 'duration_us')
        scale = 1e-9 if hasattr(e, 'start_ns') else 1e-6
        out.append((e.name(), start * scale, (start + dur) * scale))
    return out


def busy_and_gaps(records, t0: float, t1: float):
    """(busy seconds: the union of the records' intervals within [t0, t1];
    the gaps between them, (seconds, label) longest first, each labelled by
    the operation that ended before it)."""
    busy, gaps = 0.0, []
    end, last = t0, 'window start'
    for name, s, e in sorted(records, key=lambda r: r[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > end:
            gaps.append((s - end, f'after {last}'))
        if e > end:
            busy += e - max(s, end)
            end = e
            last = name
    if t1 > end:
        gaps.append((t1 - end, f'after {last}'))
    gaps.sort(key=lambda g: -g[0])
    return busy, gaps


def top_ops(records, n: int = 10) -> list:
    """[[name, total seconds]] of the n device operations that took most."""
    tot: dict = {}
    for name, s, e in records:
        tot[name] = tot.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def profile(unit, sync) -> dict:
    """Run unit() once under torch.profiler (device activity only) between
    two synchronisations. Returns the records, the traced window's seconds
    and its busy seconds and breakdown."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    sync()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        w0 = time.perf_counter()
        out = unit()
        sync()
        window = time.perf_counter() - w0
    t_read = time.perf_counter()
    records = device_records(prof)
    if records:
        t0 = min(r[1] for r in records)
        t1 = max(t0 + window, max(r[2] for r in records))
    else:
        t0 = t1 = 0.0
    busy, gaps = busy_and_gaps(records, t0, t1)
    return dict(records=records, window_s=max(window, t1 - t0), busy_s=busy,
                read_s=time.perf_counter() - t_read, out=out,
                breakdown=dict(device_ops=top_ops(records),
                               idle_gaps=[[label, s] for s, label
                                          in gaps[:10]]))
