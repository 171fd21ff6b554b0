"""Row scatter-add and differentiable segment sum.

Port of ``shacira_tpu/ops/pallas_scatter.py``.  Its Pallas kernel
``_scatter_kernel`` (a one-hot MXU matmul) becomes the CUDA kernel
``csrc/scatter.cu``: a warp walks a run of consecutive rows
(:func:`merge_chunk_rows`), each row and its index read once with all its
columns in registers, sums runs of an equal index among rows 8 apart (the
same corner of consecutive samples), and issues one vector ``atomicAdd``
per run and group of :func:`vector_width` columns (:func:`merge_plain` is
the plain mirror of that walk).  Both uses of the JAX package's scatter
run through it:

* :func:`scatter_add` -- the hash-grid backward (``ops/hashgrid.py``), one
  launch over all LODs;
* :func:`segment_sum` -- the per-ray sums of the compact volume integration
  (``tracers/rf_tracer.py``); its backward is a gather.

:func:`gather_rows` is the feature-table gather of the alternative grid
backbones (NGLOD corner features, VQAD corner logits, triplanar plane
texels).  Its forward is kernel R1 of the same source
(:func:`gather_rows_plain` its plain twin): one launch over the tables of
every LOD (and plane), each row copied in the widest vector its width
allows, the indices read as int32 or int64 where they lie.  Its backward
is the scatter, one launch over the tables in one row space with offsets,
inside the range ``backward/encode`` on autograd's thread.  The JAX
package leaves both to XLA outside any Pallas kernel.

Dispatch (``kernels/launch.py``): a CPU tensor takes the plain PyTorch
version beside the kernel; a CUDA tensor launches the kernel or raises.
There is no fallback.

Unlike the JAX path, sums on the card are not bitwise deterministic: float
atomics change the summation order from run to run.  Indices outside the
table are dropped by the kernel and the plain version alike, as the Pallas
kernel drops them.

Each wrapper counts its kernel launches in the counter registry
(``launches/scatter_add``, ``launches/segment_sum``,
``launches/gather_rows``; ``utils/perf.py``) so a run can show the main
path used the kernel.
"""
from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from shacira_tpu_torch.kernels import launch


def _check(idx: torch.Tensor, vals: torch.Tensor):
    if idx.dim() != 1 or vals.dim() != 2 or idx.shape[0] != vals.shape[0]:
        raise ValueError(f'idx [N] and vals [N, F] expected, got '
                         f'{tuple(idx.shape)} and {tuple(vals.shape)}')
    if idx.device != vals.device:
        raise ValueError(f'idx on {idx.device}, vals on {vals.device}')


def merge_chunk_rows(n: int) -> int:
    """Rows each warp of ``csrc/scatter.cu`` walks for ``n`` rows: 2 a
    lane, doubled up to 32 a lane while at least 2^20 lanes stay busy."""
    chunk = 2 * 32
    while chunk < 32 * 32 and n // (2 * chunk // 32) >= 1 << 20:
        chunk *= 2
    return chunk


def vector_width(f: int) -> int:
    """Columns one global atomic of ``csrc/scatter.cu`` adds at width
    ``f``: a float4 where ``f % 4 == 0``, a float2 where ``f % 2 == 0``,
    else one float."""
    return 4 if f % 4 == 0 else 2 if f % 2 == 0 else 1


def lane_walks(x: torch.Tensor, chunk: int, fill=-1) -> torch.Tensor:
    """The run sequences of ``csrc/scatter.cu`` in ``x`` [N] or [N, F]:
    [runs, chunk // 8(, F)], row j of every 8 rows of a warp's ``chunk``
    rows (rows 8 apart, the same corner of consecutive samples); the last
    chunk padded with ``fill``."""
    tail = tuple(x.shape[1:])
    x = torch.cat([x, x.new_full((-x.shape[0] % chunk, *tail), fill)])
    return x.reshape(-1, chunk // 8, 8, *tail).transpose(1, 2).reshape(
        -1, chunk // 8, *tail)


def run_merge(keys: torch.Tensor, vals: torch.Tensor):
    """Plain mirror of the merge in ``csrc/scatter.cu``: row ``i`` of
    ``keys`` [S, K] (int64, negative = not live) and ``vals`` [S, K, F] is
    one run sequence (:func:`lane_walks`); each run of an equal key is
    summed per column and issued where the key changes (a row that is not
    live ends a run).  Returns the (keys [M], sums [M, F]) of the runs that
    reach the table (runs whose sums are all exactly zero are dropped, as
    the kernel drops them)."""
    held_k = torch.full((keys.shape[0],), -1, dtype=torch.long,
                        device=keys.device)
    held_v = torch.zeros((keys.shape[0], vals.shape[2]), device=keys.device)
    out_k, out_v = [], []
    for i in range(keys.shape[1]):
        k, v = keys[:, i], vals[:, i]
        end = k != held_k
        out_k.append(held_k[end])
        out_v.append(held_v[end])
        held_v = torch.where(end[:, None],
                             torch.where(k[:, None] >= 0, v, 0.0),
                             held_v + v)
        held_k = k
    out_k = torch.cat(out_k + [held_k])
    out_v = torch.cat(out_v + [held_v])
    keep = (out_k >= 0) & (out_v != 0).any(1)
    return out_k[keep], out_v[keep]


def merge_plain(idx: torch.Tensor, vals: torch.Tensor, table_size: int):
    """The walk of ``csrc/scatter.cu`` on ``idx`` [N] and ``vals`` [N, F],
    in plain PyTorch: (keys [M], sums [M, F], atomics), the runs that reach
    the table and the global atomics they issue, one per group of
    :func:`vector_width` columns with a non-zero sum.  A row is live when
    its index lies in ``[0, table_size)`` and any of its values is
    non-zero.  A ``cuda`` test holds ``atomics`` to the count of the
    kernel's counting build."""
    _check(idx, vals)
    idx, vals = idx.long(), vals.float()
    live = (idx >= 0) & (idx < table_size) & (vals != 0).any(1)
    chunk = merge_chunk_rows(idx.shape[0])
    keys, sums = run_merge(lane_walks(torch.where(live, idx, -1), chunk),
                           lane_walks(vals, chunk, fill=0.0))
    groups = sums.reshape(sums.shape[0], -1, vector_width(vals.shape[1]))
    return keys, sums, int((groups != 0).any(2).sum())


def scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor,
                      table_size: int) -> torch.Tensor:
    """Plain PyTorch version: ``out[t] = sum over idx == t of vals``, f32.
    Indices outside ``[0, table_size)`` are dropped, as the kernel and the
    Pallas one-hot kernel drop them: they go to a dump row sliced off at the
    end (no host sync, unlike a boolean mask)."""
    _check(idx, vals)
    idx = idx.long()
    inside = (idx >= 0) & (idx < table_size)
    out = torch.zeros((table_size + 1, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_put_((torch.where(inside, idx, table_size),), vals.float(),
                   accumulate=True)
    return out[:table_size]


_SCATTER = launch.Entry('scatter', 'scatter_add_rows', 'pppqiq')


def _launch_scatter(idx: torch.Tensor, vals: torch.Tensor,
                    table_size: int, lib=None) -> torch.Tensor:
    """Launch ``scatter_add_rows`` of ``lib`` (default: the kernel built
    from ``csrc/scatter.cu``) on the current stream into a fresh
    zero-filled f32 table."""
    idx = idx.to(torch.int32).contiguous()
    vals = launch.aligned_f32(vals)
    n, f = vals.shape
    out = torch.zeros((table_size, f), dtype=torch.float32,
                      device=vals.device)
    _SCATTER(vals.device, idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
             n, f, table_size, lib=lib)
    return out


def _scatter(name, idx, vals, table_size):
    return launch.dispatch(
        name, vals.device, lambda: scatter_add_plain(idx, vals, table_size),
        lambda: (_launch_scatter(idx, vals, table_size), 1))


def scatter_add(idx: torch.Tensor, vals: torch.Tensor,
                table_size: int) -> torch.Tensor:
    """``out[t, :] = sum over n with idx[n] == t of vals[n, :]`` into a
    ``[table_size, F]`` f32 table.

    CPU tensors take :func:`scatter_add_plain`; CUDA tensors launch the
    kernel.  The JAX package rounds ``vals`` to bf16 on the TPU; the port
    accumulates in f32 like the JAX package's CPU path."""
    _check(idx, vals)
    return _scatter('scatter_add', idx, vals, table_size)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, vals, num_rows):
        _check(idx, vals)
        ctx.save_for_backward(idx)
        return _scatter('segment_sum', idx, vals, num_rows)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return None, ct.float()[idx.long()], None


def segment_sum(idx: torch.Tensor, vals: torch.Tensor,
                num_rows: int) -> torch.Tensor:
    """Differentiable f32 segment sum ``out[r] = sum over idx == r``.

    Port of ``pallas_scatter.segment_sum``.  ``idx`` need not be sorted: the
    compact tracer's zero-filled tail slots carry row 0.  The backward is
    the gather ``ct[idx]``."""
    return _SegmentSum.apply(idx, vals, num_rows)


MAX_GATHER_TABLES = 64        # kernel R1's kMaxGatherTables


class _GatherTable(ctypes.Structure):
    """``struct GatherTable`` of ``csrc/scatter.cu``: one table of kernel
    R1 (``first_block`` is set by the launcher)."""
    _fields_ = [('table', ctypes.c_void_p), ('idx', ctypes.c_void_p),
                ('out', ctypes.c_void_p), ('rows', ctypes.c_longlong),
                ('n', ctypes.c_longlong), ('first_block', ctypes.c_longlong)]


_GATHER = launch.Entry('scatter', 'gather_rows', _GatherTable, 'iqi')


def gather_rows_plain(tables, idxs) -> list:
    """Plain PyTorch version of kernel R1: ``[t[i.long()] for t, i]``."""
    return [t[i.long()] for t, i in zip(tables, idxs)]


def _launch_gather(tables, idxs, lib=None):
    """Launch ``gather_rows`` of ``lib`` (default: kernel R1 built from
    ``csrc/scatter.cu``) on the current stream, once for every
    ``MAX_GATHER_TABLES`` tables that hold a row to gather; returns (the
    outputs, the launches).  Indices are read as they come where all are
    int32 or all int64; otherwise every one is read as int64."""
    idx64 = any(i.dtype != torch.int32 for i in idxs)
    idxs = [(i.long() if idx64 else i).contiguous() for i in idxs]
    tables = [t.contiguous() for t in tables]
    outs = [torch.empty((*i.shape, t.shape[1]), dtype=t.dtype,
                        device=t.device) for t, i in zip(tables, idxs)]
    row_bytes = tables[0].shape[1] * tables[0].element_size()
    dev = tables[0].device
    launches = 0
    for at in range(0, len(tables), MAX_GATHER_TABLES):
        group = range(at, min(at + MAX_GATHER_TABLES, len(tables)))
        if not any(idxs[k].numel() for k in group):
            continue
        arr = (_GatherTable * len(group))(*[
            _GatherTable(tables[k].data_ptr(), idxs[k].data_ptr(),
                         outs[k].data_ptr(), tables[k].shape[0],
                         idxs[k].numel(), 0) for k in group])
        _GATHER(dev, arr, len(group), row_bytes, int(idx64), lib=lib)
        launches += 1
    return outs, launches


def _gather_forward(tables, idxs) -> list:
    """Each ``tables[k][idxs[k]]``: :func:`gather_rows_plain` on the CPU,
    kernel R1 on the card (counted as ``launches/gather_rows``)."""
    return launch.dispatch('gather_rows', tables[0].device,
                           lambda: gather_rows_plain(tables, idxs),
                           lambda: _launch_gather(tables, idxs))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, *tables_and_idx):
        tables, idxs = tables_and_idx[:n], tables_and_idx[n:]
        ctx.rows = [t.shape[0] for t in tables]
        ctx.dtypes = [t.dtype for t in tables]
        ctx.save_for_backward(*idxs)
        # an output outside the loss gets None, not a zero-filled gradient
        ctx.set_materialize_grads(False)
        return tuple(_gather_forward(tables, idxs))

    @staticmethod
    def backward(ctx, *grads):
        idxs = ctx.saved_tensors
        rows = ctx.rows
        offsets = [0]
        for r in rows[:-1]:
            offsets.append(offsets[-1] + r)
        live = [k for k, g in enumerate(grads) if g is not None]
        if not live:
            return (None,) * (1 + 2 * len(rows))
        width = grads[live[0]].shape[-1]
        with record_function('backward/encode'):
            flat_idx = [(idxs[k].reshape(-1).long() + offsets[k]
                         ).to(torch.int32) for k in live]
            vals = [grads[k].float().reshape(-1, width) for k in live]
            if len(live) > 1:
                flat_idx, vals = torch.cat(flat_idx), torch.cat(vals)
            else:
                flat_idx, vals = flat_idx[0], vals[0]
            table = scatter_add(flat_idx, vals, sum(rows))
            del flat_idx, vals
            out = [None] * len(rows)
            for k, part in enumerate(torch.split(table, rows)):
                if k in live:
                    out[k] = part.to(ctx.dtypes[k])
        return (None, *out, *([None] * len(rows)))


def gather_rows(tables, idxs):
    """``[tables[k][idxs[k]] for k]``: rows of ``[T_k, F]`` tables (one
    width ``F`` and dtype) at integer indices of any shape, each
    ``[*idxs[k].shape, F]``, all on one device.

    The forward is ONE launch of kernel R1 on the card over every table.
    The backward adds every output's gradient rows into one zeroed f32
    table of ``sum T_k`` rows, table ``k``'s indices offset by the rows
    before it, with ONE :func:`scatter_add` (kernel B1 on the card), then
    splits it per table.  Indices must lie in their table."""
    tables, idxs = list(tables), list(idxs)
    if len(tables) != len(idxs) or not tables:
        raise ValueError(f'{len(tables)} tables and {len(idxs)} index '
                         'tensors')
    if any(t.dim() != 2 for t in tables) or len(
            {(t.shape[1], t.dtype) for t in tables}) != 1:
        raise ValueError('[T, F] tables of one width and dtype expected, '
                         f'got {[(tuple(t.shape), t.dtype) for t in tables]}')
    if len({x.device for x in tables + idxs}) != 1:
        raise ValueError('tables and indices on one device expected, got '
                         f'{sorted({str(x.device) for x in tables + idxs})}')
    return list(_GatherRows.apply(len(tables), *tables, *idxs))
