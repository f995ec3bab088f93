"""Counters the benchmark records from its own files around the program's
calls: the solver's captures (mpc/solver.py's `_capture`, wrapped as
chip_smoke.py's `capture_walls` does), the variance trace's K1 launches by
shape (ops/kernels/variance_trace.py's `rw_tied`, as chip_smoke.py's
`record_launch_shapes`), the graphs each capture recorded them in, and the
replays of those graphs (utils/replay_counts.replays_run)."""

from __future__ import annotations

from collections import Counter


class Recorder:
    """Installed for a run: counts every capture, and, with `shapes`, every
    K1 call on CUDA tensors by (B, Nout, Nc, d, E, groups, blam bytes),
    and which of them each captured graph holds (its Replays object)."""

    def __init__(self, shapes: bool):
        from gpmpc_tpu_torch.mpc import solver
        from gpmpc_tpu_torch.ops.kernels import variance_trace as vt
        self.solver, self.vt = solver, vt
        self.captures = 0
        self.eager = Counter()
        self.captured = None
        self.graph_calls: dict = {}
        self._capture = solver._capture
        self._rw = vt.rw_tied
        solver._capture = self.capture
        if shapes:
            vt.rw_tied = self.rw_tied

    def capture(self, record, s, pool=None, loop_iters=None):
        outer, self.captured = self.captured, Counter()
        try:
            graph, counts = self._capture(record, s, pool,
                                          loop_iters=loop_iters)
        finally:
            calls, self.captured = self.captured, outer
        self.captures += 1
        self.graph_calls[counts] = calls
        return graph, counts

    def rw_tied(self, g_out, dv_out, a, aod, blam):
        if g_out.is_cuda:
            grouped = blam.ndim == 4
            shape = (g_out.shape[0], g_out.shape[-2], a.shape[-2],
                     g_out.shape[-1], blam.shape[-3],
                     blam.shape[0] if grouped else 1, blam.element_size())
            (self.eager if self.captured is None else self.captured)[
                shape] += 1
        return self._rw(g_out, dv_out, a, aod, blam)

    def snapshot(self):
        """What `launches` counts from."""
        from gpmpc_tpu_torch.utils import replay_counts
        return dict(replay_counts.replays_run()), Counter(self.eager)

    def launches(self, since) -> Counter:
        """K1 launches by shape since a snapshot: those the host made
        outside captures and those the captured graphs' replays ran."""
        from gpmpc_tpu_torch.utils import replay_counts
        replays_before, eager_before = since
        out = Counter(self.eager)
        out.subtract(eager_before)
        for counts, n in replay_counts.replays_run().items():
            times = n - replays_before.get(counts, 0)
            for shape, k in self.graph_calls.get(counts, {}).items():
                out[shape] += k * times
        return +out

    def remove(self):
        self.solver._capture = self._capture
        self.vt.rw_tied = self._rw
