"""Multi-resolution hash-grid encoding, flat ``'xor'`` and ``'paged'`` layouts.

Port of ``shacira_tpu/ops/hashgrid.py``.  Semantics match the JAX package
(and through it the reference CUDA kernels) exactly:

* coordinate mapping ``x = clamp(res * (c * 0.5 + 0.5), 0, res - 1 - 1e-5)``
  with the cell clamped to ``res - 2``;
* direct linear indexing when every partial power ``res^d`` (int32 wrap) is
  below the table size, else the XOR-prime hash masked to the table size;
* output ``[N, num_lods, feature_dim]``.

The uint32 hash is computed in int64 as ``(c * prime) & 0xFFFFFFFF`` (the
product stays below 2^47), then XORed and masked, so indices are
bit-identical to JAX's uint32 arithmetic.

Both encodes are ``torch.autograd.Function``s.  Their forward is
:func:`encode_forward`: on the card ONE launch of kernel E1
(``csrc/hash_encode.cu``) over every LOD computes cells, corner rows,
weights, gathers and blends in registers and writes the features, plus
the corner rows ``gidx`` and weights ``w`` ``[L, N, C]`` the backward
reads when an input needs a gradient (features alone otherwise: prune,
renders, validation).  E1 replaces no Pallas kernel: the JAX package's
flat forward is a gather left to XLA.  On the CPU the forward is
:func:`encode_plain`, the PyTorch version E1 is held to: E1 takes the
orders of PyTorch's CUDA product and sum, so on the card its corner rows,
weights and features equal :func:`encode_plain`'s bit for bit.  Their
backward is :func:`encode_backward`: on the card ONE launch of kernel E1(b)
(``csrc/hash_encode.cu``) over every LOD writes the scatter's rows ``upd``
from the features' gradient and the saved ``w`` (and, on the affine path,
reads ``zbar`` and writes ``grad_scale`` and ``grad_shift``), then ONE
launch of the scatter kernel (``ops/scatter.py``) adds the rows into the
concatenated ``[total_size, width]`` table gradient, every LOD's indices
offset by its ``lod_first_idx``.  On the CPU it is
:func:`encode_backward_plain`, the eager formulas E1(b) is held to.  Every
encode's backward runs in the range ``backward/encode``, on autograd's
thread, so the profiler gives it the kernels it launches (E1(b) under an
op record of its own, ``hash_encode_backward``).

The ``'paged'`` layout (``hash_layout='paged'``) places a hashed LOD's
entries page by page: ``entry = page(cell) * E + fold_hash(xor_hash, E)``,
with ``page`` the cell's coarse spatial bin at ``page_res`` bins per axis.
The block-local encode of that layout is ``ops/paged_hash.py``; the plain
encode here gives the same entries for every LOD, so it is the reference
the block-local encode is tested against and the path of hashed LODs that
cannot be paged.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from shacira_tpu_torch.kernels import launch
from shacira_tpu_torch.ops.scatter import scatter_add

# XOR-hash primes of the reference kernels.
PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

# 'paged' layout: coarse spatial bins (pages) per axis by default, and the
# entries-per-page below which the hash folds its high bytes down before
# the mask (with few entries the bare XOR-prime hash keeps only its low
# bits, which skews collisions).
PAGE_RES = 16
SMALL_PAGE_ENTRIES = 32


def fold_hash(acc, e: int):
    """Mask an XOR-prime hash accumulator (uint32 values, held in int64 or
    a Python int) to ``e`` entries, folding the high bytes down first when
    the page is small."""
    if e < SMALL_PAGE_ENTRIES:
        acc = acc ^ (acc >> 8) ^ (acc >> 16) ^ (acc >> 24)
    return acc & (e - 1)


def _int32_wrap(x: int) -> int:
    """Emulate C int32 overflow for the direct-index condition."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


def use_direct_index(resolution: int, codebook_size: int, dim: int) -> bool:
    """True when a LOD addresses its table directly instead of hashing:
    every partial power ``res, .., res^dim`` (int32 wrap) is below the
    table size."""
    acc = 1
    for _ in range(dim):
        acc = _int32_wrap(acc * resolution)
        if acc >= codebook_size:
            return False
    return True


def paged_params(res: int, codebook_size: int, dim: int,
                 page_res: int = PAGE_RES):
    """(num_pages, entries_per_page) of a paged hashed LOD, or None when the
    LOD cannot be paged (direct-indexed, table not divisible by the page
    count, or fewer than 4 entries per page)."""
    if use_direct_index(res, codebook_size, dim):
        return None
    p = page_res ** dim
    if codebook_size % p or codebook_size < 4 * p:
        return None
    return p, codebook_size // p


def _page_of_cell(cpos: torch.Tensor, res: int, dim: int,
                  page_res: int = PAGE_RES) -> torch.Tensor:
    """Coarse page id of integer cell coords ``[..., dim]`` (x-major):
    ``page_axis = (cell * page_res) // res`` in integer arithmetic."""
    pax = torch.div(cpos * page_res, res, rounding_mode='floor')
    page = pax[..., 0]
    for d in range(1, dim):
        page = page * page_res + pax[..., d]
    return page


@dataclass(frozen=True)
class HashGridSpec:
    """Static layout of a concatenated multi-LOD hash table.  ``'paged'``
    hashes page-divisible LODs into ``page_res**dim`` spatial pages."""
    resolutions: Tuple[int, ...]
    codebook_bitwidth: int
    dim: int
    hash_layout: str = 'xor'
    page_res: int = PAGE_RES

    def __post_init__(self):
        if self.hash_layout not in ('xor', 'paged'):
            raise ValueError(f'hash_layout={self.hash_layout!r}')

    @property
    def codebook_size(self) -> int:
        return 2 ** self.codebook_bitwidth

    @property
    def num_lods(self) -> int:
        return len(self.resolutions)

    @functools.cached_property
    def lod_sizes(self) -> Tuple[int, ...]:
        """Per-LOD table sizes ``min(2**bw, res**dim)``."""
        return tuple(min(self.codebook_size, int(r) ** self.dim)
                     for r in self.resolutions)

    @functools.cached_property
    def lod_first_idx(self) -> Tuple[int, ...]:
        offs = np.concatenate([[0], np.cumsum(self.lod_sizes)[:-1]])
        return tuple(int(o) for o in offs)

    @property
    def total_size(self) -> int:
        return sum(self.lod_sizes)

    @functools.cached_property
    def corner_offsets(self) -> np.ndarray:
        """[2**dim, dim] corner offsets; the first coordinate is the high
        bit of the corner number (reference order)."""
        n = 2 ** self.dim
        out = np.zeros((n, self.dim), dtype=np.int64)
        for j in range(n):
            for d in range(self.dim):
                out[j, d] = (j >> (self.dim - 1 - d)) & 1
        return out


def geometric_resolutions(min_grid_res: int, max_grid_res: int,
                          num_lods: int) -> Tuple[int, ...]:
    """Instant-NGP geometric LOD progression
    ``res_l = floor(min * b**l) + 1``, ``b = exp((ln max - ln min)/(L-1))``."""
    if num_lods == 1:
        return (int(1 + np.floor(min_grid_res)),)
    b = np.exp((np.log(max_grid_res) - np.log(min_grid_res)) / (num_lods - 1))
    return tuple(int(1 + np.floor(min_grid_res * (b ** l)))
                 for l in range(num_lods))


def octree_resolutions(base_lod: int, num_lods: int) -> Tuple[int, ...]:
    """Power-of-two LOD progression ``2^(base_lod + l)``."""
    return tuple(2 ** (base_lod + l) for l in range(num_lods))


def _cell_and_frac(coords: torch.Tensor, res: int):
    """Cell position [N, dim] int64 and fraction [N, dim] f32."""
    x = torch.clamp(res * (coords.float() * 0.5 + 0.5), 0.0, res - 1 - 1e-5)
    pos = torch.clamp(torch.floor(x), max=max(res - 2, 0))
    frac = torch.clamp(x - pos, 0.0, 1.0)
    return pos.long(), frac


def _corner_offsets(spec: HashGridSpec, device) -> torch.Tensor:
    """``spec.corner_offsets`` [2**dim, dim] int64, built on ``device``: a
    host-to-device copy would synchronise the stream at every LOD."""
    j = torch.arange(2 ** spec.dim, device=device)[:, None]
    return (j >> torch.arange(spec.dim - 1, -1, -1, device=device)) & 1


def _corner_weights(frac: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Multilinear weights [N, 2**dim] in reference corner order."""
    offs = _corner_offsets(spec, frac.device).bool()
    w = torch.where(offs[None], frac[:, None, :], 1.0 - frac[:, None, :])
    return torch.prod(w, dim=-1)


def _lod_corner_indices_and_weights(coords: torch.Tensor, res: int,
                                    spec: HashGridSpec):
    """Per-LOD corner indices into the LOD-local table ([N, 2**dim] int64)
    and multilinear weights ([N, 2**dim] f32)."""
    dim, cs = spec.dim, spec.codebook_size
    pos, frac = _cell_and_frac(coords, res)
    offs = _corner_offsets(spec, coords.device)
    cpos = pos[:, None, :] + offs[None, :, :]             # [N, C, dim]
    w = _corner_weights(frac, spec)
    if use_direct_index(res, cs, dim):
        strides = res ** torch.arange(dim, device=coords.device)
        idx = torch.sum(cpos * strides, dim=-1)
    else:
        acc = (cpos[..., 0] * PRIMES[0]) & _U32
        for d in range(1, dim):
            acc = acc ^ ((cpos[..., d] * PRIMES[d]) & _U32)
        paged = (spec.hash_layout == 'paged' and paged_params(
            res, cs, dim, spec.page_res) is not None)
        if paged:
            _, e = paged_params(res, cs, dim, spec.page_res)
            page = _page_of_cell(cpos, res, dim, spec.page_res)
            idx = page * e + fold_hash(acc, e)
        else:
            idx = acc & (cs - 1)
    return idx, w


def _all_corners(coords: torch.Tensor, spec: HashGridSpec, lods=None):
    """Global corner indices [L, N, C] int32 (LOD-local index plus the LOD's
    offset into the concatenated table) and weights [L, N, C] f32, over
    ``lods`` (default: every LOD)."""
    idx, w = [], []
    for lod in (range(spec.num_lods) if lods is None else lods):
        res = spec.resolutions[lod]
        i, wl = _lod_corner_indices_and_weights(coords, res, spec)
        idx.append((i + spec.lod_first_idx[lod]).to(torch.int32))
        w.append(wl)
    return torch.stack(idx), torch.stack(w)


def _interp(table: torch.Tensor, gidx: torch.Tensor, w: torch.Tensor):
    """Gather rows of ``table`` at the [N, C] corners and blend them with
    the weights: [N, W]."""
    return torch.sum(table[gidx.long()] * w[..., None], dim=1)


def encode_plain(coords: torch.Tensor, table: torch.Tensor,
                 spec: HashGridSpec, lods=None, zt=None):
    """Plain PyTorch version of kernel E1 (:func:`encode_forward`): the
    blend of ``table`` [T, F] and, when given, ``zt`` [T, ld] (the table
    ``[table, zt]``, f32) at ``coords`` [N, dim] over ``lods`` (default:
    every LOD).  Returns (feats [N, L, F], zbar [L, N, ld] or None, gidx
    [L, N, C] int32, w [L, N, C] f32)."""
    f = table.shape[1]
    both = table.float() if zt is None else torch.cat(
        [table.float(), zt.float()], dim=-1)
    gidx, w = _all_corners(coords, spec, lods)
    blend = [_interp(both, gidx[l], w[l]) for l in range(gidx.shape[0])]
    feats = torch.stack([b[:, :f] for b in blend], dim=1)
    zbar = None if zt is None else torch.stack([b[:, f:] for b in blend])
    return feats, zbar, gidx, w


# Per-LOD modes of kernel E1 (``csrc/hash_encode.cu``).
LOD_DIRECT, LOD_XOR, LOD_PAGED = 0, 1, 2
MAX_LODS = 64                 # the kernel's kMaxLods


class _Lod(ctypes.Structure):
    """``struct Lod`` of ``csrc/hash_encode.cu``: one LOD's parameters."""
    _fields_ = [('res', ctypes.c_int32), ('first', ctypes.c_int32),
                ('size', ctypes.c_int32), ('mode', ctypes.c_int32),
                ('entries', ctypes.c_int32), ('hi', ctypes.c_float),
                ('cell_max', ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def lod_params(spec: HashGridSpec, lods=None):
    """The ``struct Lod`` array kernel E1 takes for ``lods`` (default:
    every LOD) in that order: resolution, first row in the concatenated
    table, rows (a hashed LOD masks with ``size - 1``), mode
    (``LOD_DIRECT`` / ``LOD_XOR`` / ``LOD_PAGED``), entries a page, and
    the clamps of :func:`_cell_and_frac` in f32.  Built once per (spec,
    lods); passed by value with each launch."""
    lods = range(spec.num_lods) if lods is None else lods
    if not 1 <= len(lods) <= MAX_LODS:
        raise ValueError(f'kernel E1 takes 1 to {MAX_LODS} LODs, got '
                         f'{len(lods)}')
    out = (_Lod * len(lods))()
    for k, lod in enumerate(lods):
        res, cs = spec.resolutions[lod], spec.codebook_size
        paged = spec.hash_layout == 'paged' and paged_params(
            res, cs, spec.dim, spec.page_res)
        if use_direct_index(res, cs, spec.dim):
            mode, entries = LOD_DIRECT, 0
        elif paged:
            mode, entries = LOD_PAGED, paged[1]
        else:
            mode, entries = LOD_XOR, 0
        out[k] = _Lod(res, spec.lod_first_idx[lod], spec.lod_sizes[lod],
                      mode, entries, res - 1 - 1e-5, max(res - 2, 0))
    return out


_ENCODE = launch.Entry('hash_encode', 'hash_encode_forward', 'ppipi', _Lod,
                       'iiqipppp')


def _launch_encode(coords: torch.Tensor, table: torch.Tensor,
                   spec: HashGridSpec, lods, zt, save: bool):
    """Launch ``hash_encode_forward`` (``csrc/hash_encode.cu``) on the
    current stream; the outputs of :func:`encode_plain`, ``zbar``, ``gidx``
    and ``w`` None unless ``save``."""
    params = lod_params(spec, lods)
    coords = coords.float().contiguous()
    table = launch.aligned_f32(table)
    zt = None if zt is None else launch.aligned_f32(zt)
    n, f = coords.shape[0], table.shape[1]
    ld = 0 if zt is None else zt.shape[1]
    num, c = len(params), 2 ** spec.dim
    dev = table.device
    feats = torch.empty((n, num, f), dtype=torch.float32, device=dev)
    zbar = gidx = w = None
    if save:
        gidx = torch.empty((num, n, c), dtype=torch.int32, device=dev)
        w = torch.empty((num, n, c), dtype=torch.float32, device=dev)
        if ld:
            zbar = torch.empty((num, n, ld), dtype=torch.float32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    _ENCODE(dev, coords.data_ptr(), table.data_ptr(), f, ptr(zt), ld, params,
            num, spec.page_res, n, spec.dim, feats.data_ptr(), ptr(zbar),
            ptr(gidx), ptr(w))
    return feats, zbar, gidx, w


def encode_forward(coords: torch.Tensor, table: torch.Tensor,
                   spec: HashGridSpec, lods=None, zt=None,
                   save: bool = True):
    """The flat encode's forward: ``table`` [T, F] blended at ``coords``
    [N, dim] over ``lods`` (default: every LOD) as features [N, L, F] and,
    when given, ``zt`` [T, ld] as ``zbar`` [L, N, ld], with the corner rows
    ``gidx`` and weights ``w`` [L, N, C] the backward reads.

    CPU tensors take :func:`encode_plain`; CUDA tensors launch kernel E1
    once for all LODs (counted as ``launches/hash_encode``), writing
    ``zbar``, ``gidx`` and ``w`` only when ``save`` (None otherwise)."""
    if coords.dim() != 2 or coords.shape[1] != spec.dim or table.dim() != 2:
        raise ValueError(f'coords [N, {spec.dim}] and table [T, F] expected, '
                         f'got {tuple(coords.shape)} and '
                         f'{tuple(table.shape)}')
    if coords.device != table.device:
        raise ValueError(f'coords on {coords.device}, table on '
                         f'{table.device}')
    return launch.dispatch(
        'hash_encode', table.device,
        lambda: encode_plain(coords, table, spec, lods, zt),
        lambda: (_launch_encode(coords, table, spec, lods, zt, save), 1))


def backward_updates_plain(g: torch.Tensor, w: torch.Tensor, zbar=None,
                           scale=None):
    """Plain PyTorch version of kernel E1(b): from the features' gradient
    ``g`` [N, L, F] and the forward's corner weights ``w`` [L, N, C], the
    scatter's rows ``upd`` [L, N, C, W] (W = F, or ld through ``scale``
    [ld, F]), and on the affine path (``zbar`` [L, N, ld] and ``scale``
    given) ``grad_scale`` [ld, F] and ``grad_shift`` [1, F] (None
    without)."""
    g = g.float()                                         # [N, L, F]
    gz = g if scale is None else g @ scale.float().t()    # [N, L, W]
    upd = gz.permute(1, 0, 2)[:, :, None, :] * w[..., None]
    if scale is None:
        return upd, None, None
    # zbar[l, n] = sum_c w * z_c: the sum over corners is taken
    return (upd, torch.einsum('lnd,nlf->df', zbar, g),
            torch.einsum('lnc,nlf->f', w, g)[None])


def encode_backward_plain(g, gidx, w, zbar, scale, total_size: int):
    """The flat encode's backward in plain PyTorch: the table's gradient
    [total_size, W], the rows of :func:`backward_updates_plain` added at
    the corner rows ``gidx`` [L, N, C], then ``grad_scale`` and
    ``grad_shift`` (None without ``scale``)."""
    upd, grad_scale, grad_shift = backward_updates_plain(g, w, zbar, scale)
    grad = scatter_add(gidx.reshape(-1), upd.reshape(-1, upd.shape[-1]),
                       total_size)
    return grad, grad_scale, grad_shift


MAX_WIDTH = 8                 # kernel E1(b)'s largest F and ld (kMaxWidth)

_ENCODE_BACKWARD = launch.Entry('hash_encode', 'hash_encode_backward',
                                'ppppqiiiippipp')


@functools.lru_cache(maxsize=None)
def _partial_columns(device: torch.device) -> int:
    """Columns of E1(b)'s scratch, one a block: its grid is one wave, at
    most 32 blocks an SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count * 32


def _launch_encode_backward(g, w, zbar=None, scale=None):
    """Launch ``hash_encode_backward`` (kernel E1(b)) on the current stream
    under an op record of its own; the outputs of
    :func:`backward_updates_plain`."""
    n, num, f = g.shape
    c = w.shape[2]
    ld = 0 if scale is None else scale.shape[0]
    if c not in (4, 8) or not 1 <= num <= MAX_LODS or f > MAX_WIDTH \
            or ld > MAX_WIDTH:
        raise ValueError(
            f'kernel E1(b) takes 4 or 8 corners, 1 to {MAX_LODS} LODs and '
            f'F and ld up to {MAX_WIDTH}, got C {c}, L {num}, F {f}, ld {ld}')
    dev = g.device
    g, w = launch.aligned_f32(g), launch.aligned_f32(w)
    upd = torch.empty((num, n, c, ld or f), dtype=torch.float32, device=dev)
    partials = grad_scale = grad_shift = None
    cols = 0
    if ld:
        zbar, scale = launch.aligned_f32(zbar), scale.float().contiguous()
        cols = _partial_columns(dev)
        partials = torch.empty(((ld + 1) * f * cols + 1,),
                               dtype=torch.float32, device=dev)
        # with no points the kernel writes nothing: the sums are zero
        alloc = torch.empty if n else torch.zeros
        grad_scale = alloc((ld, f), dtype=torch.float32, device=dev)
        grad_shift = alloc((1, f), dtype=torch.float32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    # a profile gives a kernel launched here to the innermost op record on
    # this thread: without one of its own, E1(b) would fall to the autograd
    # node around ``backward/encode``
    with torch._C._profiler._RecordFunctionFast('hash_encode_backward'):
        _ENCODE_BACKWARD(dev, g.data_ptr(), w.data_ptr(), ptr(zbar),
                         ptr(scale), n, num, c, f, ld, upd.data_ptr(),
                         ptr(partials), cols, ptr(grad_scale),
                         ptr(grad_shift))
    return upd, grad_scale, grad_shift


def encode_backward(g: torch.Tensor, gidx: torch.Tensor, w: torch.Tensor,
                    zbar, scale, total_size: int):
    """The flat encode's backward from the features' gradient ``g``
    [N, L, F] and what the forward saved: the corner rows ``gidx`` and
    weights ``w`` [L, N, C] and, on the affine path, ``zbar`` [L, N, ld]
    with ``scale`` [ld, F].  Returns (the table's gradient
    [total_size, W], grad_scale [ld, F], grad_shift [1, F]), W = F and
    both None without ``scale``.

    CPU tensors take :func:`encode_backward_plain`; CUDA tensors launch
    kernel E1(b) once for all LODs (counted as
    ``launches/hash_encode_backward``), then the scatter kernel on its
    rows."""
    n, num, f = g.shape
    affine = scale is not None
    if (tuple(w.shape[:2]) != (num, n) or gidx.shape != w.shape
            or affine != (zbar is not None)
            or (affine and (tuple(zbar.shape) != (num, n, scale.shape[0])
                            or scale.shape[1] != f))):
        raise ValueError(
            f'encode_backward: g [N, L, F], gidx and w [L, N, C], zbar '
            f'[L, N, ld] and scale [ld, F] expected, got {tuple(g.shape)}, '
            f'{tuple(gidx.shape)}, {tuple(w.shape)}, '
            f'{None if zbar is None else tuple(zbar.shape)}, '
            f'{None if scale is None else tuple(scale.shape)}')

    def kernel():
        upd, grad_scale, grad_shift = _launch_encode_backward(g, w, zbar,
                                                              scale)
        grad = scatter_add(gidx.reshape(-1), upd.reshape(-1, upd.shape[-1]),
                           total_size)
        return (grad, grad_scale, grad_shift), 1

    return launch.dispatch(
        'hash_encode_backward', g.device,
        lambda: encode_backward_plain(g, gidx, w, zbar, scale, total_size),
        kernel)


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, codebook, spec):
        feats, _, gidx, w = encode_forward(coords, codebook, spec,
                                           save=ctx.needs_input_grad[1])
        ctx.spec = spec
        ctx.cb_dtype = codebook.dtype
        ctx.save_for_backward(gidx, w)
        return feats.to(codebook.dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            # a gradient taken for the coordinates alone: none flows there
            return None, None, None
        gidx, w = ctx.saved_tensors
        with record_function('backward/encode'):
            grad, _, _ = encode_backward(g, gidx, w, None, None,
                                         ctx.spec.total_size)
        return None, grad.to(ctx.cb_dtype), None


def hash_encode(coords: torch.Tensor, codebook: torch.Tensor,
                spec: HashGridSpec) -> torch.Tensor:
    """Multi-LOD hash-grid interpolation ``[N, dim] -> [N, L, F]``.
    Gradients flow to ``codebook`` only."""
    if not torch.is_grad_enabled():     # no backward: save nothing for it
        codebook = codebook.detach()
    return _HashEncode.apply(coords, codebook, spec)


class _HashEncodeAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, z, scale, shift, spec, lods):
        decoded = z @ scale + shift                       # [T, F]
        feats, zbar, gidx, w = encode_forward(
            coords, decoded, spec, lods, z,
            save=any(ctx.needs_input_grad[1:4]))
        ctx.spec = spec
        ctx.dtypes = (z.dtype, scale.dtype, shift.dtype)
        ctx.save_for_backward(gidx, w, zbar, scale)
        return feats

    @staticmethod
    def backward(ctx, g):
        gidx, w, zbar, scale = ctx.saved_tensors
        z_dtype, scale_dtype, shift_dtype = ctx.dtypes
        with record_function('backward/encode'):
            grad_z, grad_scale, grad_shift = encode_backward(
                g, gidx, w, zbar, scale, ctx.spec.total_size)
        return (None, grad_z.to(z_dtype), grad_scale.to(scale_dtype),
                grad_shift.to(shift_dtype), None, None)


def hash_encode_affine(coords: torch.Tensor, z: torch.Tensor,
                       scale: torch.Tensor, shift: torch.Tensor,
                       spec: HashGridSpec, lods=None) -> torch.Tensor:
    """Multi-LOD interpolation of ``z @ scale + shift`` -> [N, L, F], over
    the LOD indices ``lods`` (default: all) in the order given.

    The backward scatters latent-width rows (``ld`` columns instead of
    ``F``): ``grad_z[t] = sum w * (g @ scale^T)``, ``grad_scale =
    sum (w z) (x) g``, ``grad_shift = sum w g``.
    """
    lods = None if lods is None else tuple(lods)
    if not torch.is_grad_enabled():     # no backward: save nothing for it
        z, scale, shift = z.detach(), scale.detach(), shift.detach()
    return _HashEncodeAffine.apply(coords, z, scale, shift, spec, lods)


# ---------------------------------------------------------------------------
# Static-coordinate plan: with coordinates fixed for the whole training (an
# image INR on its full pixel lattice), the corner indices and weights and
# the transposed scatter pattern are fixed too.  The plan holds per LOD the
# forward gather (idx, w) and, for every table row, the padded list of the
# (sample, corner) pairs that touch it (src, srcw), so the backward is a
# gather and a weighted sum: no scatter.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StaticPlanMeta:
    spec: HashGridSpec
    num_coords: int
    bucket_ks: Tuple[int, ...]   # padded contributors per row, per LOD


def build_static_plan(coords, spec: HashGridSpec, device,
                      pad_multiple: int = 8):
    """The forward indices and the backward transpose plan of ``coords``
    [N, dim] (array or tensor), built on the host.

    Returns (meta, arrays), ``arrays`` lists per LOD of tensors on
    ``device``:
      idx  [N, C] int32   LOD-local corner indices;
      w    [N, C] f32     interpolation weights;
      src  [S, K] int32   flattened (n * C + c) contributors of each row;
      srcw [S, K] f32     their weights (0 = padding).
    """
    coords = torch.as_tensor(np.asarray(coords, np.float32))
    n = coords.shape[0]
    arrays = {'idx': [], 'w': [], 'src': [], 'srcw': []}
    bucket_ks = []
    for lod, res in enumerate(spec.resolutions):
        idx, w = _lod_corner_indices_and_weights(coords, res, spec)
        idx = idx.numpy().astype(np.int32)
        w = w.numpy()
        size = spec.lod_sizes[lod]
        flat_idx = idx.reshape(-1)
        order = np.argsort(flat_idx, kind='stable')
        sorted_idx = flat_idx[order]
        counts = np.bincount(sorted_idx, minlength=size)
        k = int(counts.max()) if counts.size else 0
        k = max(pad_multiple, -(-k // pad_multiple) * pad_multiple)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        src = np.zeros((size, k), np.int32)
        srcw = np.zeros((size, k), np.float32)
        pos_in_bucket = np.arange(len(sorted_idx)) - starts[sorted_idx]
        src[sorted_idx, pos_in_bucket] = order.astype(np.int32)
        srcw[sorted_idx, pos_in_bucket] = w.reshape(-1)[order]
        for key, a in (('idx', idx), ('w', w), ('src', src),
                       ('srcw', srcw)):
            arrays[key].append(torch.as_tensor(a, device=device))
        bucket_ks.append(k)
    return StaticPlanMeta(spec, n, tuple(bucket_ks)), arrays


class _StaticHashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, codebook, meta, arrays):
        spec = meta.spec
        feats = []
        for lod in range(spec.num_lods):
            first = spec.lod_first_idx[lod]
            table = codebook[first:first + spec.lod_sizes[lod]].float()
            feats.append(_interp(table, arrays['idx'][lod], arrays['w'][lod]))
        ctx.meta, ctx.arrays = meta, arrays
        ctx.cb_dtype = codebook.dtype
        return torch.stack(feats, dim=1).to(codebook.dtype)

    @staticmethod
    def backward(ctx, g):
        spec, arrays = ctx.meta.spec, ctx.arrays
        c = 2 ** spec.dim
        with record_function('backward/encode'):
            g = g.float()                                 # [N, L, F]
            grads = []
            for lod in range(spec.num_lods):
                src, srcw = arrays['src'][lod], arrays['srcw'][lod]  # [S, K]
                gl = g[:, lod, :][torch.div(src.long(), c,
                                            rounding_mode='floor')]  # [S,K,F]
                grads.append(torch.sum(gl * srcw[..., None], dim=1))
            return torch.cat(grads).to(ctx.cb_dtype), None, None


def static_hash_encode(arrays: dict, codebook: torch.Tensor,
                       meta: StaticPlanMeta) -> torch.Tensor:
    """Multi-LOD interpolation [N, L, F] at the plan's coordinates.
    Gradients flow to ``codebook`` only, through the plan's
    gather-and-weighted-sum (no scatter)."""
    return _StaticHashEncode.apply(codebook, meta, arrays)
