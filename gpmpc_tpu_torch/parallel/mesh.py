"""Device-mesh helpers for scenario fan-out and model sharding
(port of gpmpc_tpu/parallel/mesh.py).

One process per rank over an initialised `torch.distributed` process group
(parallel/distributed.initialize). The mesh is a
`torch.distributed.device_mesh.DeviceMesh` with dims ('batch', 'model'): a
rank's batch coordinate says which lanes it solves, its model coordinate which
row block of the variance cache b_lam it holds. Independent solves fan out
over the batch axis with no collective; the model axis splits each solve's
O(N^2) trace and sums the partial traces (parallel/model_sharded.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BATCH_AXIS = 'batch'
MODEL_AXIS = 'model'


def make_mesh(n_batch: Optional[int] = None, n_model: int = 1,
              device=None) -> DeviceMesh:
    """(batch, model) mesh over every rank of the initialised process group,
    rank r at (r // n_model, r % n_model). n_batch defaults to all ranks
    over n_model. `device` (the ranks' device type) defaults to CUDA."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs an initialised process group '
                           '(gpmpc_tpu_torch.parallel.distributed.initialize)')
    world = dist.get_world_size()
    if n_batch is None:
        n_batch = world // n_model
    if n_batch * n_model != world:
        raise ValueError(f'a ({n_batch}, {n_model}) mesh needs '
                         f'{n_batch * n_model} ranks, the group has {world}')
    device_type = torch.device('cuda' if device is None else device).type
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(n_batch, n_model),
                      mesh_dim_names=(BATCH_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def lane_slice(mesh: DeviceMesh, b: int, axis: str = BATCH_AXIS) -> slice:
    """This rank's lanes of a B-lane batch split evenly over `axis`."""
    n = axis_size(mesh, axis)
    if b % n != 0:
        raise ValueError(f'batch {b} not divisible by mesh axis {axis!r} of '
                         f'size {n}')
    k = b // n
    i = mesh.get_local_rank(axis)
    return slice(i * k, (i + 1) * k)


def row_block(mesh: DeviceMesh, b_lam: torch.Tensor, axis: str = MODEL_AXIS):
    """This rank's row block of b_lam (E, cap, cap), stored transposed:
    (row_off, b_lam[:, row_off:row_off + Nl].transpose(1, 2) as a contiguous
    (E, cap, Nl) copy), with Nl = cap / n_model and n_model the size of
    `axis`. The transposed layout is the one the row-block kernel K3 reads,
    so the rollout passes it on without a copy a step."""
    n = axis_size(mesh, axis)
    cap = b_lam.shape[1]
    if cap % n != 0:
        raise ValueError(f'capacity {cap} not divisible by mesh axis '
                         f'{axis!r} of size {n}')
    n_loc = cap // n
    off = mesh.get_local_rank(axis) * n_loc
    return off, b_lam[:, off:off + n_loc].transpose(1, 2).contiguous()


def gather_lanes(mesh: DeviceMesh, t: torch.Tensor,
                 axis: str = BATCH_AXIS) -> torch.Tensor:
    """All-gather each rank's lanes (leading axis) over `axis`, in
    coordinate order: the inverse of `lane_slice`, on every rank."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(torch.bool) if t.dtype == torch.bool else out
