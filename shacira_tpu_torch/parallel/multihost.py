"""Multi-process execution and the weak-scaling report.

Port of ``shacira_tpu/parallel/multihost.py``.  One process drives one
device:

* :func:`initialize` joins the processes into one ``torch.distributed``
  process group: NCCL on CUDA devices (each process on its local GPU), or
  gloo on the CPU;
* :func:`global_mesh` is the data-parallel mesh over every rank;
* each rank loads its part of the global batch
  (:func:`host_local_batch_slice`); parameters are replicated and the
  gradients all-reduced (``parallel/mesh.py``);
* :func:`scaling_report` measures throughput on meshes of increasing size
  (weak scaling: a constant batch per device).
"""
from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from shacira_tpu_torch.device import resolve_device
from shacira_tpu_torch.parallel.mesh import Mesh, make_mesh

# a lost peer fails a collective after this long instead of hanging it
TIMEOUT_S = 300


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = TIMEOUT_S) -> None:
    """Join ``num_processes`` processes into the default process group; a
    no-op for one process or none, as in the JAX package.

    ``coordinator_address``: ``host:port`` of rank 0 (a TCP rendezvous), an
    init-method URL (``file://...``), or None for torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``).  ``backend``: ``'nccl'`` (the
    default) trains on CUDA, each process on GPU ``LOCAL_RANK`` (default:
    ``process_id`` modulo the GPU count), and raises without a GPU;
    ``'gloo'`` trains on the CPU.  A failure to initialise raises; there
    is no fall-back to another backend."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None:
        init = 'env://'
    elif '://' in coordinator_address:
        init = coordinator_address
    else:
        init = f'tcp://{coordinator_address}'
    _init_group(init, num_processes, process_id, backend or 'nccl',
                timeout_s)


def _init_group(init: str, num_processes: int, process_id: Optional[int],
                backend: str, timeout_s: float) -> None:
    """:func:`initialize` past its one-process no-op, at any world size:
    the rank's GPU for NCCL, then the group at ``init`` (an init-method
    URL) with ``timeout_s``."""
    if backend == 'nccl':
        resolve_device(None)                 # raises without a GPU
        local = os.environ.get('LOCAL_RANK')
        if local is None:
            if process_id is None:
                raise ValueError('NCCL needs LOCAL_RANK or a process_id '
                                 'to choose the GPU')
            local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(int(local))
    elif backend != 'gloo':
        raise ValueError(f"backend {backend!r}: 'nccl' (CUDA) or 'gloo' "
                         f'(CPU)')
    # rank -1: env://'s RANK names it
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes,
                            rank=-1 if process_id is None else process_id,
                            timeout=timedelta(seconds=timeout_s))


def global_mesh(num_devices: Optional[int] = None) -> Mesh:
    """1-D data mesh over every rank (or the first ``num_devices``)."""
    return make_mesh(num_devices)


def host_local_batch_slice(global_batch: int,
                           mesh: Optional[Mesh] = None) -> slice:
    """The slice of the global batch this rank loads: rank r of n loads
    ``[r B/n, (r+1) B/n)`` (of the mesh, else of the default group)."""
    if mesh is not None:
        p, n = mesh.rank, mesh.size
    elif dist.is_initialized():
        p, n = dist.get_rank(), dist.get_world_size()
    else:
        p, n = 0, 1
    per = global_batch // n
    return slice(p * per, (p + 1) * per)


def scaling_report(step_builder: Callable, batch_per_device: int,
                   device_counts: Optional[List[int]] = None,
                   steps: int = 20) -> Dict[int, Dict[str, float]]:
    """Weak-scaling throughput on meshes over the first n ranks.

    Every rank calls it.  ``step_builder(mesh, batch_size)`` returns a
    callable that runs one training step of this rank and returns once
    the step has finished on the device; ranks outside a mesh wait.
    Returns rank 0's ``{n: {'items_per_s', 'efficiency'}}`` on every
    rank."""
    avail = dist.get_world_size() if dist.is_initialized() else 1
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= avail]
    out = {}
    base = None
    for n in device_counts:
        mesh = make_mesh(n)
        if mesh is not None:
            step = step_builder(mesh, batch_per_device * n)
            step()                                 # warm-up
            if mesh.group is not None:
                dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            dt = time.perf_counter() - t0
            ips = batch_per_device * n * steps / dt
            if base is None:
                base = ips / n
            out[n] = {'items_per_s': ips, 'efficiency': ips / (n * base)}
        if dist.is_initialized():
            dist.barrier()
    if dist.is_initialized():
        box = [out]
        dist.broadcast_object_list(box, src=0)
        out = box[0]
    return out
