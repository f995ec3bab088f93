"""The lockstep solver's loop on the device, and its condition kernel.

JAX runs its solver's loop as lax.while_loop: one device program whose
condition, t < max_iters and any lane not done, is read on the device. The
port's counterpart (csrc/loop_cond.cu) is a CUDA graph whose conditional
WHILE node runs a solve's step, captured straight into the node's body,
while the condition kernel says so: the kernel runs once before the node
and again after each pass, and sets the node's handle from the solve's own
t and done. One launch runs the whole loop and reads nothing back
(mpc/solver.py's kept programs).

`go_on(t, done, max_iters)` is the condition as a tensor: on CUDA tensors
the kernel's plain launch (it writes the condition where the loop graph
sets the handle), on CPU tensors its plain version `go_on_reference`, the
torch expression of the host loop's `_go_on`. There is no fallback from
one to the other.

The loop needs conditional nodes and a capture into their body: a CUDA
runtime (the toolkit the library is built with) and a CUDA driver of
12.4 or later (`supported`, read once). Where they are older the solver keeps its
host-read loop; the choice is made by version, never by catching a
failure, and a loop graph that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
import time

import torch

from gpmpc_tpu_torch.ops.kernels import _build

_LIB = 'loop_cond'
MIN_CUDA = 12040           # conditional WHILE nodes, a capture into the body

# The condition kernel's launches: each loop graph runs it once before its
# WHILE node and once a pass (counted when the loop's passes are read,
# mpc/solver.py `_Program.settle`), and each plain launch of go_on once.
LAUNCHES_COND = 0
_versions: list = []


def add_launches(n: int) -> None:
    global LAUNCHES_COND
    LAUNCHES_COND += n


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.gpmpc_loop_begin.argtypes = [
        vp, vp, ctypes.c_int, i64, vp, ctypes.POINTER(vp),
        ctypes.POINTER(ctypes.c_ulonglong)]
    lib.gpmpc_loop_end.argtypes = [
        vp, vp, ctypes.c_ulonglong, vp, vp, ctypes.c_int, i64,
        ctypes.POINTER(vp), ctypes.POINTER(vp)]
    lib.gpmpc_loop_abort.argtypes = [vp]
    lib.gpmpc_loop_launch.argtypes = [vp, vp]
    lib.gpmpc_loop_destroy.argtypes = [vp, vp]
    lib.gpmpc_loop_cond.argtypes = [vp, vp, ctypes.c_int, i64, vp, vp]
    lib.gpmpc_loop_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.gpmpc_loop_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, call: str) -> None:
    if err != 0:
        msg = _lib().gpmpc_loop_error_string(err).decode()
        raise RuntimeError(f'{call} failed: {msg} (cudaError {err})')


def versions() -> tuple:
    """(runtime, driver): the CUDA runtime the library is built with and
    the CUDA driver's version, each 1000 * major + 10 * minor (read once)."""
    if not _versions:
        rt, drv = ctypes.c_int(0), ctypes.c_int(0)
        _check(_lib().gpmpc_loop_versions(ctypes.byref(rt),
                                          ctypes.byref(drv)),
               'cudaDriverGetVersion')
        _versions.append((rt.value, drv.value))
    return _versions[0]


def supported() -> bool:
    """Whether this card's CUDA runs the device loop (both versions at
    least MIN_CUDA)."""
    return min(versions()) >= MIN_CUDA


def go_on_reference(t: torch.Tensor, done: torch.Tensor,
                    max_iters: int) -> torch.Tensor:
    """The plain version: t < max_iters and some lane not done, a bool
    scalar tensor on t's device (no host read)."""
    return (t < max_iters) & (~done).any()


def launch(t: torch.Tensor, done: torch.Tensor, max_iters: int,
           out: torch.Tensor) -> None:
    """The kernel's plain launch on the current stream: the condition
    written to out (an int32 scalar on the card) where the loop graph sets
    its node's handle. CUDA tensors only: t int64 scalar, done contiguous
    bool."""
    if not (t.is_cuda and t.dtype == torch.long and t.ndim == 0
            and done.dtype == torch.bool and done.is_contiguous()
            and out.dtype == torch.int32 and out.numel() == 1):
        raise ValueError('loop_cond.launch takes a CUDA int64 scalar t, a '
                         'contiguous bool done and an int32 out')
    stream = torch.cuda.current_stream(t.device).cuda_stream
    _check(_lib().gpmpc_loop_cond(t.data_ptr(), done.data_ptr(),
                                  done.numel(), max_iters, out.data_ptr(),
                                  stream), 'loop_cond_kernel')
    add_launches(1)


def go_on(t: torch.Tensor, done: torch.Tensor, max_iters: int) -> torch.Tensor:
    """The loop's condition as a bool scalar tensor: on CUDA the kernel's
    plain launch (`launch`), on the CPU go_on_reference."""
    if t.device.type != 'cuda':
        return go_on_reference(t, done, max_iters)
    out = torch.empty((), dtype=torch.int32, device=t.device)
    launch(t, done.contiguous(), max_iters, out)
    return out.bool()


class DeviceLoop:
    """The loop graph of one solve: record() (one step, which writes the
    solve's static buffers in place; run once eagerly before, as a capture
    needs) captured straight into the WHILE node's body on the current
    stream, which must be a side stream (as for a torch capture), its
    allocations in the memory pool `pool` (a torch.cuda.graph_pool_handle(),
    shared with the solve's other graphs), run while t < max_iters and some
    lane of done is live, read from the solve's static t (int64 scalar) and
    done (B bools), which must stay allocated while the loop lives. `body`
    is the body graph (a cudaGraph_t, for its kernel nodes), `capture_s`
    and `instantiate_s` the seconds its build took. `launch()` runs the
    whole loop on the current stream; `reset()` frees the graph and lets
    the pool go."""

    def __init__(self, record, t: torch.Tensor, done: torch.Tensor,
                 max_iters: int, pool):
        if not (t.is_cuda and t.dtype == torch.long and t.ndim == 0
                and done.dtype == torch.bool and done.is_contiguous()):
            raise ValueError('DeviceLoop takes a CUDA int64 scalar t and a '
                             'contiguous bool done')
        lib, dev = _lib(), t.device
        stream = torch.cuda.current_stream(dev)
        if stream == torch.cuda.default_stream(dev):
            raise ValueError('DeviceLoop captures on a side stream, not the '
                             'default stream')
        self.device, self.pool = dev, pool
        self.graph, self.exec = ctypes.c_void_p(), ctypes.c_void_p()
        body, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
        args = (t.data_ptr(), done.data_ptr(), done.numel(), max_iters)
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            _check(lib.gpmpc_loop_begin(*args, stream.cuda_stream,
                                        ctypes.byref(self.graph),
                                        ctypes.byref(handle)),
                   'the loop graph\'s build')
            # As a torch capture routes its allocations: into the pool, which
            # this loop holds until reset(). Every allocation on the device
            # (the backward pass runs on autograd's own thread).
            torch._C._cuda_beginAllocateToPool(dev.index, pool)
            try:
                record()
            except BaseException:
                lib.gpmpc_loop_abort(stream.cuda_stream)
                torch._C._cuda_endAllocateToPool(dev.index, pool)
                self._drop()
                raise
            torch._C._cuda_endAllocateToPool(dev.index, pool)
            t1 = time.perf_counter()
            err = lib.gpmpc_loop_end(stream.cuda_stream, self.graph, handle,
                                     *args, ctypes.byref(body),
                                     ctypes.byref(self.exec))
            if err:
                self._drop()
                _check(err, 'the loop graph\'s build')
        self.body = body.value
        self.capture_s = t1 - t0
        self.instantiate_s = time.perf_counter() - t1

    def launch(self) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(_lib().gpmpc_loop_launch(self.exec, stream),
               'the loop graph\'s launch')

    def _drop(self) -> None:
        _lib().gpmpc_loop_destroy(self.graph, self.exec)
        torch._C._cuda_releasePool(self.device.index, self.pool)
        self.graph, self.exec = ctypes.c_void_p(), ctypes.c_void_p()

    def reset(self) -> None:
        """Free the graph and let the pool go (as CUDAGraph.reset)."""
        if self.graph:
            self._drop()
