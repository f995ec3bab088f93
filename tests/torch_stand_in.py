"""Stand-ins for the CUDA graphs of gpmpc_tpu_torch's kept solve programs
(mpc/solver.py), so that the programs' control flow runs on the CPU. It
imports torch and the port only (no JAX): the test files use it through
torch_port_common, the ranks of torch_dist_worker.py directly.
"""

import contextlib

import torch

# ------------------------------------------- stand-in CUDA graphs (CPU) --
# What the solver's programs (gpmpc_tpu_torch/mpc/solver.py) ask of a CUDA
# graph, a stream and the caching allocator, on the CPU: a capture runs the
# recorded code's host calls once on a copy of the static state (it changes
# no buffer, and its counts are taken back as a real capture's are); each
# replay runs the recorded code on the static buffers with REPLAYING set, so
# that a counter can skip it as a real replay runs no Python.
REPLAYING = [False]


class StandInGraph:
    def __init__(self, record, s):
        self.record, self.s, self.resets = record, s, 0

    def replay(self):
        REPLAYING[0] = True
        try:
            self.record(self.s)
        finally:
            REPLAYING[0] = False

    def reset(self):
        self.resets += 1


class StandInLoop(StandInGraph):
    """A device loop's loop graph (ops/kernels/loop_cond.DeviceLoop): a
    launch replays the step while the condition's plain version holds."""

    def __init__(self, record, s, max_iters):
        super().__init__(record, s)
        self.max_iters = max_iters

    def launch(self):
        from gpmpc_tpu_torch.ops.kernels import loop_cond
        while bool(loop_cond.go_on_reference(self.s.t, self.s.done,
                                             self.max_iters)):
            self.replay()


def stand_in_capture(record, s, pool=None, loop_iters=None):
    from gpmpc_tpu_torch.utils import replay_counts
    before = replay_counts.snapshot()
    record(type(s)(*(x.clone() for x in s)))
    graph = (StandInGraph(record, s) if loop_iters is None
             else StandInLoop(record, s, loop_iters))
    return graph, replay_counts.Replays(before, replay_counts.snapshot(), [])


class _FakeStream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


def use_stand_in_graphs(monkeypatch):
    """The solver's graphed route on CPU tensors, through stand-in graphs;
    the program cache starts empty and is emptied after the test."""
    from gpmpc_tpu_torch.mpc import solver
    solver.clear_programs()
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, 'Stream', lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, 'stream',
                        lambda st: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', lambda: None)
    monkeypatch.setattr(torch.cuda, 'memory_reserved', lambda device=None: 0)
    monkeypatch.setattr(solver, '_capture', stand_in_capture)
    monkeypatch.setattr(solver, '_can_graph', lambda device: True)
    monkeypatch.setattr(solver, '_PROGRAMS', type(solver._PROGRAMS)())


def capture_gloo(monkeypatch):
    """With the stand-in graphs, let a program capture a gloo group's
    collectives on the CPU (the solver's CAPTURED_BACKENDS): a stand-in
    replay runs the recorded Python, collectives included, so a program
    over gloo runs the control flow of one over NCCL on the card."""
    from gpmpc_tpu_torch.mpc import solver
    monkeypatch.setitem(solver.CAPTURED_BACKENDS, 'cpu', ('gloo',))
