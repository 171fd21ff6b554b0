"""VQAD's straight-through codebook mix and trilinear blend.

Each LOD of the CodebookOctreeGrid (``models/grids/octree_grid.py``)
turns the gathered corner logits ``l`` [N, 8, D], the corners' trilinear
weights ``w`` [N, 8], whether each point's cell is in the octree ``v``
[N] and the LOD's dictionary [D, F] into the points' features [N, F]:
``where(v, sum_c w[c] * (keys[c] @ dictionary), 0)``, with the
straight-through keys ``y_soft + (one_hot(argmax y_soft) - y_soft)`` (the
bracket detached) and ``y_soft = softmax(l)``.  The JAX package leaves
this to XLA (``shacira_tpu/models/grids/octree_grid.py:194-203``).

:func:`codebook_mix_plain` is that expression in PyTorch, its gradient
through autograd.  On the card :func:`codebook_mix` runs one autograd
Function instead: its forward is ONE launch of kernel M1 over every LOD,
its backward ONE launch of M1(b) (``csrc/codebook_mix.cu``) inside the
range ``backward/codebook_mix`` on autograd's thread.  The forward saves
its inputs and nothing else; the backward recomputes the softmax, its
argmax and the keys in registers.  No gradient goes to the weights (no
VQAD path differentiates the coordinates): :func:`codebook_mix` refuses
weights that require one.

Dispatch (``kernels/launch.py``): a CPU tensor takes the plain twin, a
CUDA tensor the kernels or raises.  The kernels take D in ``WIDTHS``
(``codebook_bitwidth`` 2 to 6), F up to ``MAX_WIDTH`` and up to
``MAX_LODS`` LODs; other shapes raise ``codebook_mix: unsupported ...``
on the card.  Launches are counted as ``launches/codebook_mix`` (one a
forward) and ``launches/codebook_mix_backward`` (one a backward).
"""
from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from shacira_tpu_torch.kernels import launch
from shacira_tpu_torch.utils import perf

WIDTHS = (4, 8, 16, 32, 64)     # dictionary sizes M1 is built for
MAX_WIDTH = 16                  # features a LOD
MAX_LODS = 16                   # kernel M1's kMaxMixLods


def codebook_mix_plain(logits, dictionaries, weights, valid) -> list:
    """Each LOD's features [N, F], in plain PyTorch (autograd through its
    ops)."""
    out = []
    for l, dictionary, w, v in zip(logits, dictionaries, weights, valid):
        y_soft = torch.softmax(l, dim=-1)
        # the one-hot of the argmax (the first maximum), built in f32
        # (F.one_hot's int64 would double the largest tensor of the step)
        hard = torch.zeros_like(y_soft).scatter_(
            -1, torch.argmax(y_soft, dim=-1, keepdim=True), 1.0)
        keys = y_soft + (hard - y_soft).detach()
        cf = torch.einsum('...d,df->...f', keys, dictionary)
        out.append(torch.where(v[..., None],
                               torch.sum(cf * w[..., None], dim=-2), 0.0))
    return out


class _MixLod(ctypes.Structure):
    """``struct MixLod`` of ``csrc/codebook_mix.cu``: one LOD of kernel M1
    or M1(b) (``first_block`` and ``blocks`` are set by the launcher)."""
    _fields_ = [('logits', ctypes.c_void_p), ('weights', ctypes.c_void_p),
                ('valid', ctypes.c_void_p), ('dictionary', ctypes.c_void_p),
                ('grad_out', ctypes.c_void_p), ('out', ctypes.c_void_p),
                ('grad_logits', ctypes.c_void_p),
                ('grad_dictionary', ctypes.c_void_p),
                ('n', ctypes.c_longlong), ('first_block', ctypes.c_longlong),
                ('blocks', ctypes.c_longlong)]


_FORWARD = launch.Entry('codebook_mix', 'codebook_mix_forward', _MixLod,
                        'iii')
_BACKWARD = launch.Entry('codebook_mix', 'codebook_mix_backward', _MixLod,
                         'iii')


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(entry, logits, dictionaries, weights, valid, grads=None,
            outs=None, dls=None, dds=None, lib=None):
    """Launch ``entry`` of ``lib`` (default: the kernels built from
    ``csrc/codebook_mix.cu``) on the current stream over every LOD (inputs
    as :func:`_apply` prepares them), each output or gradient where
    given."""
    n = len(logits)
    grads, outs, dls, dds = (x or [None] * n
                             for x in (grads, outs, dls, dds))
    d, f = dictionaries[0].shape
    arr = (_MixLod * n)(*[
        _MixLod(l.data_ptr(), w.data_ptr(), v.data_ptr(),
                t.data_ptr(), _ptr(g), _ptr(o), _ptr(dl), _ptr(dd),
                l.shape[0], 0, 0)
        for l, t, w, v, g, o, dl, dd in zip(logits, dictionaries, weights,
                                            valid, grads, outs, dls, dds)])
    entry(logits[0].device, arr, n, d, f, lib=lib)


class _CodebookMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, *tensors):
        logits, dictionaries, weights, valid = (
            tensors[i * n:(i + 1) * n] for i in range(4))
        ctx.n = n
        ctx.save_for_backward(*tensors)
        f = dictionaries[0].shape[1]
        outs = [torch.empty((l.shape[0], f), dtype=torch.float32,
                            device=l.device) for l in logits]
        _launch(_FORWARD, logits, dictionaries, weights, valid, outs=outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.n
        logits, dictionaries, weights, valid = (
            ctx.saved_tensors[i * n:(i + 1) * n] for i in range(4))
        need = ctx.needs_input_grad
        with record_function('backward/codebook_mix'):
            dls = [torch.empty_like(l) if need[1 + k] else None
                   for k, l in enumerate(logits)]
            dds = [torch.zeros_like(t) if need[1 + n + k] else None
                   for k, t in enumerate(dictionaries)]
            grads = [g.float().contiguous() for g in grads]
            # a profile gives a kernel launched here to the innermost op
            # record on this thread: without one of its own, M1(b) would
            # fall to the autograd node around this range
            with torch._C._profiler._RecordFunctionFast(
                    'codebook_mix_backward'):
                _launch(_BACKWARD, logits, dictionaries, weights, valid,
                        grads=grads, dls=dls, dds=dds)
            perf.count('launches/codebook_mix_backward', 1)
        return (None, *dls, *dds, *([None] * 2 * n))


def _check(logits, dictionaries, weights, valid):
    n = len(logits)
    if not n or len({n, len(dictionaries), len(weights), len(valid)}) != 1:
        raise ValueError(f'codebook_mix: {n} logits, {len(dictionaries)} '
                         f'dictionaries, {len(weights)} weights and '
                         f'{len(valid)} masks')
    d, f = dictionaries[0].shape
    for l, t, w, v in zip(logits, dictionaries, weights, valid):
        rows = l.shape[0]
        if (tuple(l.shape) != (rows, 8, d) or tuple(t.shape) != (d, f)
                or tuple(w.shape) != (rows, 8) or tuple(v.shape) != (rows,)
                or v.dtype != torch.bool):
            raise ValueError(
                'codebook_mix: logits [N, 8, D], dictionary [D, F], weights '
                '[N, 8] and bool mask [N] of one D and F expected, got '
                f'{tuple(l.shape)}, {tuple(t.shape)}, {tuple(w.shape)}, '
                f'{tuple(v.shape)} {v.dtype}')
        if w.requires_grad:
            raise ValueError('codebook_mix: no gradient flows to the '
                             'trilinear weights')
    devices = {str(x.device) for x in (*logits, *dictionaries, *weights,
                                       *valid)}
    if len(devices) != 1:
        raise ValueError(f'codebook_mix: tensors on {sorted(devices)}')


def _apply(logits, dictionaries, weights, valid) -> list:
    """The Function on the card's tensors, whose shapes the kernels
    take: f32 logits aligned for their vector loads (a copy, if one is
    needed, is differentiable), contiguous f32 dictionaries and weights."""
    d, f = dictionaries[0].shape
    if d not in WIDTHS or not 1 <= f <= MAX_WIDTH or len(logits) > MAX_LODS:
        raise ValueError(
            f'codebook_mix: unsupported dictionary {d} x {f} over '
            f'{len(logits)} LODs (the kernels take D in {WIDTHS}, F up to '
            f'{MAX_WIDTH}, up to {MAX_LODS} LODs)')
    return list(_CodebookMix.apply(
        len(logits), *[launch.aligned_f32(l) for l in logits],
        *[t.float().contiguous() for t in dictionaries],
        *[w.float().contiguous() for w in weights],
        *[v.contiguous() for v in valid]))


def codebook_mix(logits, dictionaries, weights, valid) -> list:
    """Each LOD's features [N, F] from its gathered logits [N, 8, D], its
    dictionary [D, F], its trilinear weights [N, 8] (no gradient) and its
    mask [N] (bool): :func:`codebook_mix_plain` on the CPU; kernels M1 and
    M1(b) on the card, one launch each over every LOD."""
    logits, dictionaries = list(logits), list(dictionaries)
    weights, valid = list(weights), list(valid)
    _check(logits, dictionaries, weights, valid)
    return launch.dispatch(
        'codebook_mix', logits[0].device,
        lambda: codebook_mix_plain(logits, dictionaries, weights, valid),
        lambda: (_apply(logits, dictionaries, weights, valid), 1))
