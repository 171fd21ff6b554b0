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

Both encodes are ``torch.autograd.Function``s whose backward scatters into
the concatenated ``[total_size, width]`` table gradient with ONE launch of
the scatter kernel (``ops/scatter.py``), every LOD's indices offset by its
``lod_first_idx``.

The ``'paged'`` layout (``hash_layout='paged'``) places a hashed LOD's
entries page by page: ``entry = page(cell) * E + fold_hash(xor_hash, E)``,
with ``page`` the cell's coarse spatial bin at ``page_res`` bins per axis.
The block-local encode of that layout is ``ops/paged_hash.py``; the plain
encode here gives the same entries for every LOD, so it is the reference
the block-local encode is tested against and the path of hashed LODs that
cannot be paged.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

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


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, codebook, spec):
        gidx, w = _all_corners(coords, spec)
        table = codebook.float()
        feats = [_interp(table, gidx[l], w[l]) for l in range(spec.num_lods)]
        ctx.spec = spec
        ctx.cb_dtype = codebook.dtype
        ctx.save_for_backward(gidx, w)
        return torch.stack(feats, dim=1).to(codebook.dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            # a gradient taken for the coordinates alone: none flows there
            return None, None, None
        gidx, w = ctx.saved_tensors
        spec = ctx.spec
        g = g.float()                                     # [N, L, F]
        f = g.shape[-1]
        upd = g.permute(1, 0, 2)[:, :, None, :] * w[..., None]  # [L,N,C,F]
        grad = scatter_add(gidx.reshape(-1), upd.reshape(-1, f),
                           spec.total_size)
        return None, grad.to(ctx.cb_dtype), None


def hash_encode(coords: torch.Tensor, codebook: torch.Tensor,
                spec: HashGridSpec) -> torch.Tensor:
    """Multi-LOD hash-grid interpolation ``[N, dim] -> [N, L, F]``.
    Gradients flow to ``codebook`` only."""
    return _HashEncode.apply(coords, codebook, spec)


class _HashEncodeAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, z, scale, shift, spec, lods):
        ld = z.shape[-1]
        decoded = (z @ scale + shift).float()
        both = torch.cat([decoded, z.float()], dim=-1)    # [T, F + ld]
        gidx, w = _all_corners(coords, spec, lods)
        feats, zbar = [], []
        for l in range(gidx.shape[0]):
            blend = _interp(both, gidx[l], w[l])          # [N, F + ld]
            feats.append(blend[:, :-ld])
            zbar.append(blend[:, -ld:])
        ctx.spec = spec
        ctx.dtypes = (z.dtype, scale.dtype, shift.dtype)
        ctx.save_for_backward(gidx, w, torch.stack(zbar), scale)
        return torch.stack(feats, dim=1)

    @staticmethod
    def backward(ctx, g):
        gidx, w, zbar, scale = ctx.saved_tensors
        spec = ctx.spec
        z_dtype, scale_dtype, shift_dtype = ctx.dtypes
        g = g.float()                                     # [N, L, F]
        ld = scale.shape[0]
        gz = (g @ scale.float().t()).permute(1, 0, 2)     # [L, N, ld]
        upd = gz[:, :, None, :] * w[..., None]            # [L, N, C, ld]
        grad_z = scatter_add(gidx.reshape(-1), upd.reshape(-1, ld),
                             spec.total_size)
        # zbar[l, n] = sum_c w * z_c, so sum over corners is already taken
        grad_scale = torch.einsum('lnd,nlf->df', zbar, g)
        grad_shift = torch.einsum('lnc,nlf->f', w, g)[None]
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
    return _HashEncodeAffine.apply(coords, z, scale, shift, spec, lods)
