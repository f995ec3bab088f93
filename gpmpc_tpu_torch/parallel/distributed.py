"""Multi-process execution on torch.distributed
(port of gpmpc_tpu/parallel/distributed.py).

One process per rank. `initialize` starts the process group from the
`torchrun` environment (or explicit arguments): NCCL between CUDA ranks, gloo
for CPU ranks, always with a timeout, so that a rank that never arrives fails
the collective instead of hanging it. The scenario fan-out then runs over a
one-axis 'batch' mesh of all ranks: each process contributes its local
scenarios, the global batch is assembled by an all_gather, the GP and the
shared cost parameters are broadcast from rank 0, and `solve_batch_sharded`
solves every rank's lanes with no collective inside the solve.

    torchrun --nproc-per-node 2 script.py      # script calls initialize()

`launch_ranks` does what torchrun does for a few ranks on one host, for a
caller that must time them out and read their output (the tests and
chip_smoke.py); each rank ends with `finish_rank`. A process that leaves
its group calls `destroy_group`, which releases the kept solve programs
bound to the group (mpc/solver.py) before the group goes.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import tempfile
import time
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gpmpc_tpu_torch.device import resolve_device
from gpmpc_tpu_torch.parallel.mesh import BATCH_AXIS

DEFAULT_TIMEOUT_S = 300.0


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Initialise the default process group once (idempotent).

    With no arguments, reads the `torchrun` environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK). An explicit init_method
    ('tcp://host:port') needs world_size and rank. The backend is NCCL for
    CUDA and gloo for the CPU (`device`, CUDA by default); a CUDA rank first
    takes the card LOCAL_RANK modulo the cards present."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK', rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    if init_method is not None and (world_size is None or rank is None):
        raise ValueError('an explicit init_method needs world_size and rank')
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=timedelta(seconds=timeout_s))


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _marker(rank: int) -> str:
    return f'RANK{rank} OK'


def launch_ranks(argv, world: int, timeout_s: float, env=None,
                 cwd=None) -> list:
    """Run `world` processes of the command `argv` on this host as the ranks
    of one group: each gets the torchrun environment (MASTER_ADDR=localhost,
    a free MASTER_PORT, RANK, LOCAL_RANK, WORLD_SIZE) on top of `env`
    (default os.environ), so that its `initialize()` joins the group.

    Waits at most timeout_s for all of them together and kills every rank
    left past it. Raises RuntimeError, with the rank's output, unless each
    rank exited 0 after `finish_rank` in time. Returns each rank's output,
    stdout and stderr together (kept in files, so that no rank blocks on a
    full pipe while another is awaited)."""
    port = str(free_port())
    base = dict(os.environ if env is None else env)
    logs = [tempfile.TemporaryFile(mode='w+') for _ in range(world)]
    procs = [subprocess.Popen(
        argv, cwd=cwd, stdout=logs[r], stderr=subprocess.STDOUT, text=True,
        env=dict(base, MASTER_ADDR='localhost', MASTER_PORT=port, RANK=str(r),
                 LOCAL_RANK=str(r), WORLD_SIZE=str(world)))
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    late = ''
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        late = f', the ranks timed out after {timeout_s} s'
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if late or p.returncode != 0 or _marker(r) not in out:
            raise RuntimeError(f'rank {r} of {world} failed (exit '
                               f'{p.returncode}{late}):\n{out[-4000:]}')
    return outs


def destroy_group() -> None:
    """Destroy the default process group, and with it every group of this
    process, after releasing each kept solve program whose collectives run
    over one of them (mpc/solver.release_group_programs): a captured
    collective must never outlive its communicator. A program of a later
    group never matches one of these (its key holds the group's serial
    number)."""
    from gpmpc_tpu_torch.mpc import solver
    solver.release_group_programs()
    dist.destroy_process_group()


def finish_rank() -> None:
    """A launched rank's last step: wait for every rank, leave the group
    (destroy_group) and print the marker that `launch_ranks` looks for."""
    rank = dist.get_rank()
    dist.barrier()
    destroy_group()
    print(_marker(rank), flush=True)


def global_batch_mesh(device=None) -> DeviceMesh:
    """One-axis 'batch' mesh over every rank, in rank order."""
    device_type = torch.device('cuda' if device is None else device).type
    return DeviceMesh(device_type, torch.arange(dist.get_world_size()),
                      mesh_dim_names=(BATCH_AXIS,))


def _tree_map(fn, tree):
    """Apply fn to every tensor of a tensor, a NamedTuple / tuple / list or a
    dataclass of them; None and other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def make_global_batch(mesh: DeviceMesh, local_tree):
    """Each process's LOCAL scenario shard (tensors with a leading
    (B_local,) axis, B_local the same on every rank) -> the global
    (B_local * P, ...) tensors in rank order, on every rank."""
    group = mesh.get_group(BATCH_AXIS)
    n = mesh.size(0)

    def one(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=0)

    return _tree_map(one, local_tree)


def replicate_global(mesh: DeviceMesh, tree):
    """Every tensor of `tree` broadcast from the mesh's first rank, so that
    all ranks hold the same values (the GP posterior, shared cost
    parameters)."""
    group = mesh.get_group(BATCH_AXIS)
    src = int(mesh.mesh.flatten()[0])

    def one(t):
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        wire = wire.clone()
        dist.broadcast(wire, src=src, group=group)
        return wire.to(torch.bool) if t.dtype == torch.bool else wire

    return _tree_map(one, tree)


def solve_batch_multihost(gp, state_dim: int, action_dim: int,
                          x0s_local: torch.Tensor, params, horizon: int, lb,
                          ub, solver=None, gammas_local=None,
                          full_cov: bool = False, delta: bool = False):
    """`solve_batch_sharded` across every process of the group.

    x0s_local (B_local, ds): THIS process's scenarios; every process
    contributes B_local of them. gammas_local optionally splits a
    per-scenario gamma sweep the same way; the other parameters and the GP are
    taken from rank 0. Returns the whole global result on every rank, lanes in
    rank order."""
    from gpmpc_tpu_torch.mpc.solver import SolverConfig
    from gpmpc_tpu_torch.parallel.batch import solve_batch_sharded

    solver = solver or SolverConfig()
    mesh = global_batch_mesh(gp.x.device)
    gp_g = replicate_global(mesh, gp)
    x0s_g = make_global_batch(mesh, x0s_local)
    if gammas_local is not None:
        params = replicate_global(mesh, params._replace(gamma=None))._replace(
            gamma=make_global_batch(mesh, gammas_local))
    else:
        params = replicate_global(mesh, params)
    return solve_batch_sharded(mesh, gp_g, state_dim, action_dim, x0s_g,
                               params, horizon, lb, ub, solver,
                               full_cov=full_cov, delta=delta)
