"""Row scatter-add and differentiable segment sum.

Port of ``shacira_tpu/ops/pallas_scatter.py``.  Its Pallas kernel
``_scatter_kernel`` (a one-hot MXU matmul) becomes the CUDA kernel
``csrc/scatter.cu``: a warp walks a run of consecutive rows
(:func:`merge_chunk_rows`) 32 at a time, sums runs of an equal index among
rows 8 apart (the same corner of consecutive samples) with a segmented
scan over lanes, and issues one float ``atomicAdd`` per run
(:func:`lane_walks` and :func:`run_merge` are the plain mirror of that
merge).  Both uses of the JAX package's scatter run through it:

* :func:`scatter_add` -- the hash-grid backward (``ops/hashgrid.py``), one
  launch over all LODs;
* :func:`segment_sum` -- the per-ray sums of the compact volume integration
  (``tracers/rf_tracer.py``); its backward is a gather.

Dispatch: a CPU tensor takes the plain PyTorch version beside the kernel;
a CUDA tensor launches the kernel or raises.  There is no fallback.

Unlike the JAX path, sums on the card are not bitwise deterministic: float
atomics change the summation order from run to run.  Indices outside the
table are dropped by the kernel and the plain version alike, as the Pallas
kernel drops them.

Each wrapper counts its kernel launches (``scatter_add.launches``,
``segment_sum.launches``) so a run can show the main path used the kernel.
"""
from __future__ import annotations

import ctypes

import torch


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


def lane_walks(x: torch.Tensor, chunk: int, fill=-1) -> torch.Tensor:
    """The run sequences of ``csrc/scatter.cu`` in ``x`` [N]: [runs,
    chunk // 8], row j of every 8 rows of a warp's ``chunk`` rows (rows 8
    apart, the same corner of consecutive samples); the last chunk padded
    with ``fill``."""
    x = torch.nn.functional.pad(x, (0, -x.shape[0] % chunk), value=fill)
    return x.reshape(-1, chunk // 8, 8).transpose(1, 2).reshape(
        -1, chunk // 8)


def run_merge(keys: torch.Tensor, vals: torch.Tensor):
    """Plain mirror of the merge in ``csrc/scatter.cu``: row ``i`` of
    ``keys`` [S, K] (int64, negative = no update) and ``vals`` [S, K] is
    one run sequence (:func:`lane_walks`); each run of an equal key is
    summed and issued where the key changes (a row without an update ends
    a run).  Returns the (keys [M], sums [M]) that reach the table, one
    global atomic each (sums that are exactly zero are dropped, as the
    kernel drops them).  A ``cuda`` test holds their count to the atomics
    the kernel's counting build issues."""
    held_k = torch.full((keys.shape[0],), -1, dtype=torch.long,
                        device=keys.device)
    held_v = torch.zeros((keys.shape[0],), device=keys.device)
    out_k, out_v = [], []
    for i in range(keys.shape[1]):
        k, v = keys[:, i], vals[:, i].float()
        end = k != held_k
        out_k.append(held_k[end])
        out_v.append(held_v[end])
        held_v = torch.where(end, torch.where(k >= 0, v, 0.0), held_v + v)
        held_k = k
    out_k = torch.cat(out_k + [held_k])
    out_v = torch.cat(out_v + [held_v])
    keep = (out_k >= 0) & (out_v != 0)
    return out_k[keep], out_v[keep]


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


def _launch_scatter(idx: torch.Tensor, vals: torch.Tensor,
                    table_size: int, lib=None) -> torch.Tensor:
    """Launch ``scatter_add_rows`` of ``lib`` (default: the kernel built
    from ``csrc/scatter.cu``) on the current stream into a fresh
    zero-filled f32 table."""
    if lib is None:
        from shacira_tpu_torch.kernels.build import load
        lib = load('scatter')
    fn = lib.scatter_add_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    idx = idx.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    n, f = vals.shape
    out = torch.zeros((table_size, f), dtype=torch.float32,
                      device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = fn(idx.data_ptr(), vals.data_ptr(), out.data_ptr(), n, f,
             table_size, stream)
    if err != 0:
        raise RuntimeError(f'scatter_add_rows launch failed: CUDA error {err}')
    return out


def scatter_add(idx: torch.Tensor, vals: torch.Tensor,
                table_size: int) -> torch.Tensor:
    """``out[t, :] = sum over n with idx[n] == t of vals[n, :]`` into a
    ``[table_size, F]`` f32 table.

    CPU tensors take :func:`scatter_add_plain`; CUDA tensors launch the
    kernel.  The JAX package rounds ``vals`` to bf16 on the TPU; the port
    accumulates in f32 like the JAX package's CPU path."""
    _check(idx, vals)
    if vals.device.type == 'cpu':
        return scatter_add_plain(idx, vals, table_size)
    if vals.device.type != 'cuda':
        raise RuntimeError(f'scatter_add: unsupported device {vals.device}')
    out = _launch_scatter(idx, vals, table_size)
    scatter_add.launches += 1
    return out


scatter_add.launches = 0


def _segment_sum_forward(idx, vals, num_rows):
    if vals.device.type == 'cpu':
        return scatter_add_plain(idx, vals, num_rows)
    if vals.device.type != 'cuda':
        raise RuntimeError(f'segment_sum: unsupported device {vals.device}')
    out = _launch_scatter(idx, vals, num_rows)
    segment_sum.launches += 1
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, vals, num_rows):
        _check(idx, vals)
        ctx.save_for_backward(idx)
        return _segment_sum_forward(idx, vals, num_rows)

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


segment_sum.launches = 0


def reset_launches():
    """Set every wrapper's launch count to 0."""
    scatter_add.launches = 0
    segment_sum.launches = 0
