"""The per-layer metrics' readings, shared by the metric files of cells
that report different end-to-end metrics (metrics/<name>.py imports one as
its `read`). Each takes the run's context and returns a number, or None
where it finds nothing to read."""

from __future__ import annotations

from portbench.bounds import bound_ms


def mfu_pct(ctx):
    """The window's share of the card's peak: the least seconds of the work
    the algorithm needed (work/<config>.py) over the window's seconds."""
    least = ctx['cell'].work().least_seconds(ctx)
    if least <= 0:
        return None
    return 100.0 * least / ctx['window_s']


def iters_per_lane(ctx):
    """The mean over the window's lanes of the iterations their solve
    results report (SolveResult.iters, summed over the recipe's phases)."""
    recs = ctx['records']
    lanes = sum(r['lanes'] for r in recs)
    if not lanes:
        return None
    return sum(float(r['iters'].double().sum()) for r in recs) / lanes


def captures_in_window(ctx):
    """CUDA-graph captures the solver made inside the window
    (counters.Recorder wraps mpc/solver.py's _capture): 0 when every
    program was kept."""
    return ctx['captures_in_window']


def host_reads(ctx):
    """The host reads of the window's episodes after each one's first step
    (simulator.LAST_EPISODE['host_reads_after_first'], summed)."""
    recs = [r for r in ctx['records'] if 'host_reads' in r]
    return sum(r['host_reads'] for r in recs) if recs else None


def graph_kernels_per_step(ctx):
    """The kernel nodes of a step graph (one value-and-grad and an
    iteration), the mean over the solver's kept programs, each counted once
    (utils/replay_counts' count of the graph's nodes)."""
    k = ctx['programs']['step_kernels']
    return sum(k) / len(k) if k else None


def device_idle_pct(ctx):
    """100 less the mean of NVML's utilization.gpu, sampled every ~100 ms
    while the traced run's window ran (unprofiled, on the timed path).
    Nothing where NVML gave no reading."""
    s = ctx['nvml']
    if not s:
        return None
    return 100.0 - sum(s) / len(s)


def k1_roofline_pct(ctx):
    """K1's share of its roofline over the traced run's profiled batch (on
    the host-read loop: the profiler loses a conditional body's records):
    the sum over its launches of bounds.bound_ms at each launch's shape,
    over the launches times the mean device time of a recorded K1 launch.
    Launches and shapes come from counters.Recorder (K1 calls by shape, in
    each captured graph and its replays); the metric's file sets
    NEEDS = ('k1_shapes',)."""
    prof = ctx.get('profile')
    if not prof:
        return None
    times = [e - s for name, s, e in prof['records'] if 'rw_tied' in name]
    launches = prof['k1_launches']
    n = sum(launches.values())
    if not times or not n:
        return None
    bound = 0.0
    for (b, n_out, n_c, d, e, groups, nbytes), k in launches.items():
        ms, _ = bound_ms(b, n_out, n_c, d, e, 1, f64=True, groups=groups,
                         blam_bytes=nbytes if groups > 1 else None)
        bound += k * ms / 1e3
    return 100.0 * bound / (n * sum(times) / len(times))
