"""Data-parallel placement and the collectives of the trainers.

Port of ``shacira_tpu/parallel/mesh.py``.  A JAX mesh is n devices of one
process, and XLA inserts the collectives.  Here a mesh is one process per
device in a ``torch.distributed`` process group of world size n, and the
collectives are written out:

* **data axis**: rays and pixels are split across the ranks.  Every rank
  builds the same global batch and keeps its contiguous rows
  (:func:`shard_batch`, :func:`shard_axis`), so rank r of n holds rows
  ``[r B/n, (r+1) B/n)``, as the JAX package's multi-process branch feeds
  them;
* **parameters** are replicated: every rank holds all of them and applies
  the same update after :func:`all_reduce_mean_` of the gradients;
* **table work** (the trainers' ``shard_table_work``): a ``[T, ...]`` table
  is split by rows (:func:`row_sharding`); :func:`all_gather_rows` joins
  the rows again, and its backward is :func:`reduce_scatter_rows`.

A placement of the JAX package (``batch_sharding``, ``row_sharding``,
``replicated``) is here the slice of rows that a rank holds.  A mesh
without a process group has one rank, and no collective runs.  The
collectives use the process group's backend: NCCL on CUDA tensors, gloo on
CPU tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from shacira_tpu_torch.device import resolve_device

DATA_AXIS = 'data'


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: the process group (None: one rank, no
    group), this process's rank in it, its size and the rank's device."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def make_mesh(num_devices: Optional[int] = None, group=None) -> Mesh:
    """Mesh over ``group``, or over the default process group, or over its
    first ``num_devices`` ranks (a new group: every rank of the default
    group must call this; a rank outside it gets ``None``).

    The rank's device is the current CUDA device when the group's backend
    is NCCL and the CPU otherwise.  With no process group it is a mesh of
    one rank on the port's default device, and no collective runs."""
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(f'a mesh of {num_devices} ranks needs an '
                             f'initialised process group')
        return local_mesh(resolve_device(None))
    if group is None:
        world = dist.get_world_size()
        if num_devices is None or num_devices == world:
            group = dist.group.WORLD
        elif 0 < num_devices < world:
            group = dist.new_group(list(range(num_devices)))
            if dist.get_rank() >= num_devices:
                return None
        else:
            raise ValueError(f'num_devices {num_devices} of a world of '
                             f'{world}')
    dev = (torch.device('cuda', torch.cuda.current_device())
           if dist.get_backend(group) == 'nccl' else torch.device('cpu'))
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev)


def local_mesh(device) -> Mesh:
    """A mesh of one rank on ``device`` without a process group: every
    placement is the whole array and every collective a no-op (a trainer
    given no mesh runs on this one)."""
    return Mesh(None, 0, 1, torch.device(device))


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The rows of an ``n``-sample batch that this rank holds (``n`` must
    divide the mesh size)."""
    if n % mesh.size:
        raise ValueError(f'{n} rows do not divide the mesh size {mesh.size}')
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def row_sharding(mesh: Mesh, n: int) -> slice:
    """The rows of an ``n``-row table whose work this rank does (the
    codebook-side SGA quantize, rate loss and Adam moments)."""
    return batch_sharding(mesh, n)


def replicated(mesh: Mesh, n: int) -> slice:
    """Every row: a replicated array is whole on every rank."""
    return slice(0, n)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad axis to a multiple (for even sharding).  Returns (padded,
    orig_len)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad, mode='edge'), n


def shard_axis(mesh: Mesh, axis: int, *arrays):
    """This rank's contiguous part of each global array (numpy or tensor)
    along ``axis``, on the mesh's device."""
    out = []
    for a in arrays:
        sl = [slice(None)] * a.ndim
        sl[axis] = batch_sharding(mesh, a.shape[axis])
        out.append(torch.as_tensor(a[tuple(sl)], device=mesh.device))
    return tuple(out)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each global array, on the mesh's device."""
    return shard_axis(mesh, 0, *arrays)


def shard_rows_global(mesh: Mesh, a):
    """This rank's ``T/n`` rows of a ``[T, ...]`` table."""
    return shard_batch(mesh, a)[0]


def _src(mesh: Mesh) -> int:
    """The global rank of the mesh's rank 0."""
    return dist.get_global_rank(mesh.group, 0)


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Broadcast every tensor of ``tree`` from rank 0, in place (every
    rank calls it with tensors of the same shapes); returns ``tree``."""
    # optim imports this module
    from shacira_tpu_torch.optim import tree_leaves_with_path
    if mesh.group is not None:
        for _, t in tree_leaves_with_path(tree):
            if not isinstance(t, torch.Tensor):
                continue
            # NCCL has no bool type: a bool tensor goes as its bytes
            dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool
                           else t, src=_src(mesh), group=mesh.group)
    return tree


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=_src(mesh), group=mesh.group)
    return box[0]


@torch.no_grad()
def all_reduce_mean_(mesh: Mesh, tensors) -> None:
    """Replace each tensor by its mean over the ranks, in place, in one
    all-reduce per dtype over a flat buffer."""
    if mesh.group is None:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
        o = 0
        for t in group:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` (a scalar or a few) over the ranks, as a new
    tensor."""
    t = t.detach().clone()
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


def reduce_scatter_rows(mesh: Mesh, g: torch.Tensor) -> torch.Tensor:
    """This rank's ``T/n`` rows of the sum over the ranks of ``g`` [T, ...]
    (each rank's gradient of the whole table)."""
    if mesh.group is None:
        return g
    out = g.new_empty((g.shape[0] // mesh.size,) + tuple(g.shape[1:]))
    dist.reduce_scatter_tensor(out, g.contiguous(), group=mesh.group)
    return out


def _all_gather_rows(mesh: Mesh, x: torch.Tensor, out=None) -> torch.Tensor:
    if mesh.group is None:
        return x if out is None else out.copy_(x)
    if out is None:
        out = x.new_empty((x.shape[0] * mesh.size,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    return out


class _AllGatherRows(torch.autograd.Function):
    """Rows of every rank joined into the whole table; the backward
    reduce-scatters the table's gradient back to this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(ctx.mesh, g), None


def all_gather_rows(mesh: Mesh, x: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``[T, ...]`` table whose rows ``row_sharding(mesh, T)`` are each
    rank's ``x`` [T/n, ...] (into ``out`` when given, outside autograd);
    differentiable when ``out`` is None: the gradient reaching ``x`` is the
    sum over the ranks of the table's gradient in its rows."""
    if out is not None:
        with torch.no_grad():
            return _all_gather_rows(mesh, x, out)
    return _AllGatherRows.apply(x, mesh)
