"""Host counters that see the replays of a captured CUDA graph.

A wrapper counts a kernel launch in Python, where it enqueues the launch. A
replay of a captured graph runs the kernels again without that Python, so a
counter sees a captured call once, at capture, where it launched nothing.

Who captures and replays a graph (mpc/solver.py's programs) therefore
counts for the wrappers. It snapshots every registered counter before and
after the capture, reads what the graph itself will launch, and builds a
`Replays`. That object takes back what the capture counted, checks the
graph against it, and adds the graph's launches once per replay.

- Kernel counters (`register_kernels`: the wrappers' launch counts). The
  graph's kernel nodes are read through the CUDA driver
  (`graph_kernel_names`), and each node's function name is sorted into
  the counters it counts in. That count must equal what the wrappers
  counted during the capture, as a node sees it (`as_nodes`: two wrappers
  that launch one kernel function, K1 and K3, count apart, their nodes
  alike), or the capture raises: a launch that left no node, or a node
  that no wrapper counted. A replay then adds what the wrappers counted.
- Tallies (`register`: a script's own counts of Python calls, e.g. of the
  rollouts a solve runs). A replay runs no Python, so for them the
  capture's difference is what each replay repeats.

Each graph's replays are also counted by graph (`replays_run`), and each
`Replays` keeps its graph's kernel names: what replays ran over a span,
by kernel name, is what a profiler's trace of that span must hold at
least.

A graph may outlive the block that captured it (mpc/solver.py keeps a
solve's init and step graphs and replays them on later calls). Its replays
count in the counters registered at its capture that are still registered;
a tally registered after the capture sees none of them, so a script that
registers one drops the kept graphs first (solver.clear_programs()).

A solve's loop on the device (ops/kernels/loop_cond.py) runs its step as
often as its WHILE node says, which the host learns only by reading the
device. So each program that runs such a loop sums its passes on the device
(one scalar, added to after each loop) and is `watch`ed: `settle()` reads
every watched sum and counts its passes, once, and keeps nothing a solve.
Whatever reads the counters settles first: `snapshot`, `replays_run`,
`unregister`, and the scripts' own reads of the kernels' LAUNCHES
(chip_smoke.read_counts). That read waits for the device; it is the
counters', not the solve's.

`HOST_READS` counts the solver loop's own reads of a value on the host
(`host_read()`: the host-read loop's `all(done)`, once an iteration): 0 a
solve whose loop runs on the device.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref
from collections import Counter
from typing import Callable, Dict, Hashable, List, NamedTuple, Optional

Counts = Dict[Hashable, int]


class _Source(NamedTuple):
    read: Callable[[], Counts]
    add: Callable[[Counts], None]
    # Kernel counters: a kernel's function name -> the keys its launch
    # counts in (() for a kernel the source does not count).
    classify: Optional[Callable[[str], tuple]]
    # Kernel counters: the wrappers' counts -> the same launches as
    # `classify` counts them from the nodes.
    as_nodes: Optional[Callable[[Counts], Counts]] = None


_SOURCES: List[_Source] = []
# The programs whose device loops count at settle() (gone with them).
_LOOPS: 'weakref.WeakSet' = weakref.WeakSet()
HOST_READS = 0


def host_read() -> None:
    """Count one read of a value on the host by a solver loop."""
    global HOST_READS
    HOST_READS += 1


def watch(loop) -> None:
    """Have settle() call loop.settle(), which counts what loop's device
    loops ran since its last settle (mpc/solver.py's programs)."""
    _LOOPS.add(loop)


def settle() -> None:
    """Count the passes of every watched device loop."""
    for loop in list(_LOOPS):
        loop.settle()


# Replays run, by graph (its Replays; gone with it).
_REPLAYS_RUN: 'weakref.WeakKeyDictionary[Replays, int]' = (
    weakref.WeakKeyDictionary())


def register(read: Callable[[], Counts], add: Callable[[Counts], None]):
    """Make a tally visible to replays: read() returns its counts {key: n};
    add({key: n}) adds to them (n may be negative). Returns the entry that
    `unregister` takes."""
    entry = _Source(read, add, None)
    _SOURCES.append(entry)
    return entry


def register_kernels(read: Callable[[], Counts], add: Callable[[Counts], None],
                     classify: Callable[[str], tuple],
                     as_nodes: Callable[[Counts], Counts] = dict):
    """Make kernel launch counters visible to replays: read and add as in
    `register`; classify(name) gives the keys that a launch of the kernel
    named `name` (mangled or not) counts in; as_nodes(counts) gives the
    wrappers' counts as classify counts the same launches (by default
    themselves)."""
    entry = _Source(read, add, classify, as_nodes)
    _SOURCES.append(entry)
    return entry


def unregister(entry) -> None:
    settle()
    _SOURCES.remove(entry)


@contextlib.contextmanager
def registered(read: Callable[[], Counts], add: Callable[[Counts], None]):
    """`register` for the duration of a block."""
    entry = register(read, add)
    try:
        yield
    finally:
        unregister(entry)


def snapshot() -> list:
    """Every registered counter's counts now (device loops settled)."""
    settle()
    return [(entry, dict(entry.read())) for entry in _SOURCES]


def _delta(before: Counts, after: Counts) -> Counts:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class Replays:
    """The counts of one captured graph. Built from the snapshots before and
    after its capture and the function names of its kernel nodes: takes
    back what the capture counted (it launched nothing), after checking
    that the graph's kernel nodes are the launches the kernel counters saw.
    `replayed()` then counts one replay: what the capture counted."""

    def __init__(self, before: list, after: list, kernel_names: List[str]):
        if [e for e, _ in before] != [e for e, _ in after]:
            raise RuntimeError('a counter was registered or removed during a '
                               'capture')
        self.per_replay = []
        self.names = Counter(kernel_names)
        for (entry, b), (_, a) in zip(before, after):
            captured = _delta(b, a)
            each = captured
            if entry.classify is not None:
                nodes = Counter()
                for name in kernel_names:
                    nodes.update(entry.classify(name))
                seen = {k: n for k, n in nodes.items() if n}
                want = {k: n for k, n in entry.as_nodes(captured).items()
                        if n}
                if seen != want:
                    raise RuntimeError(
                        f'the captured graph holds kernel launches {seen}, '
                        f'the wrappers launched {captured} during its '
                        f'capture ({want} as its nodes count them)')
            if captured:
                entry.add({k: -n for k, n in captured.items()})
            self.per_replay.append((entry, each))

    @property
    def launches(self) -> Counts:
        """The kernel launches of one replay, by counter, read from the
        graph's nodes."""
        out = {}
        for entry, each in self.per_replay:
            if entry.classify is not None:
                out.update(each)
        return out

    def replayed(self, n: int = 1) -> None:
        """Count n replays of the graph, in the counters still registered,
        and in `replays_run`."""
        if n == 0:
            return
        _REPLAYS_RUN[self] = _REPLAYS_RUN.get(self, 0) + n
        for entry, each in self.per_replay:
            if each and entry in _SOURCES:
                entry.add({k: n * v for k, v in each.items()})


def replays_run() -> Dict['Replays', int]:
    """The replays counted so far, by graph (of the graphs still alive):
    {Replays: n}, whose `names` are the graph's kernel nodes (mangled)."""
    settle()
    return dict(_REPLAYS_RUN)


# ------------------------------------------- a graph's nodes, by the driver --
# CUgraphNodeType of cuda.h, in its order (CU_GRAPH_NODE_TYPE_KERNEL = 0,
# ..._GRAPH = 4, ..._EMPTY = 5, ..._CONDITIONAL = 13).
NODE_TYPES = ('kernel', 'memcpy', 'memset', 'host', 'graph', 'empty',
              'wait_event', 'event_record', 'ext_semas_signal',
              'ext_semas_wait', 'mem_alloc', 'mem_free', 'batch_mem_op',
              'conditional')
_CU_GRAPH_NODE_TYPE_KERNEL = NODE_TYPES.index('kernel')
_CU_GRAPH_NODE_TYPE_GRAPH = NODE_TYPES.index('graph')


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""
    _fields_ = [('func', ctypes.c_void_p), ('grid', ctypes.c_uint * 3),
                ('block', ctypes.c_uint * 3), ('shared_mem', ctypes.c_uint),
                ('kernel_params', ctypes.c_void_p),
                ('extra', ctypes.c_void_p), ('kern', ctypes.c_void_p),
                ('ctx', ctypes.c_void_p)]


_driver: list = []


def _cu():
    """The CUDA driver library (loaded at first use)."""
    if not _driver:
        _driver.append(ctypes.CDLL('libcuda.so.1'))
    return _driver[0]


def _check(err: int, call: str) -> None:
    if err != 0:
        raise RuntimeError(f'{call} failed: CUresult {err}')


def _graph_nodes(graph: int):
    """(node, CUgraphNodeType) of every node of a CUDA graph (a
    cudaGraph_t), each child graph's nodes after its own node."""
    cu = _cu()
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n)),
           'cuGraphGetNodes')
    if not n.value:
        return
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(ctypes.c_void_p(graph), nodes, ctypes.byref(n)),
           'cuGraphGetNodes')
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
               'cuGraphNodeGetType')
        yield node, kind.value
        if kind.value == _CU_GRAPH_NODE_TYPE_GRAPH:
            child = ctypes.c_void_p()
            _check(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                   'cuGraphChildGraphNodeGetGraph')
            yield from _graph_nodes(child.value)


def graph_node_types(graph: int) -> Counter:
    """The nodes of a CUDA graph (a cudaGraph_t), child graphs included, by
    type (NODE_TYPES' names)."""
    return Counter(NODE_TYPES[k] if 0 <= k < len(NODE_TYPES) else f'type {k}'
                   for _, k in _graph_nodes(graph))


def graph_kernel_names(graph: int) -> List[str]:
    """The function name of every kernel node of a CUDA graph (a
    cudaGraph_t, as torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()
    gives it), child graphs included: one name for each launch that a
    replay runs."""
    cu = _cu()
    names = []
    for node, kind in _graph_nodes(graph):
        if kind != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        params = _KernelNodeParams()
        _check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
               'cuGraphKernelNodeGetParams_v2')
        name = ctypes.c_char_p()
        if params.func:
            _check(cu.cuFuncGetName(ctypes.byref(name),
                                    ctypes.c_void_p(params.func)),
                   'cuFuncGetName')
        else:
            _check(cu.cuKernelGetName(ctypes.byref(name),
                                      ctypes.c_void_p(params.kern)),
                   'cuKernelGetName')
        names.append(name.value.decode())
    return names
