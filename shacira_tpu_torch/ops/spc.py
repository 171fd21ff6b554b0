"""Structured point cloud (octree) utilities.

Port of ``shacira_tpu/ops/spc.py``: per level a sorted array of the occupied
cells' morton codes instead of kaolin's byte-packed octree, queries as
vectorized binary searches (``torch.searchsorted``).  The JAX package builds
the structure on the host with numpy; here it is built with torch on the
device of its input (``torch.unique(sorted=True, return_inverse=True)``
gives ``np.unique``'s sorted values and inverse, so the dual octree's
corners and trinkets are equal to the JAX package's).

Morton codes are int64 throughout (JAX uses uint32 on the device and uint64
on the host): codes of levels <= 10 stay below 2^30, and
``torch.searchsorted`` needs the sorted codes and the queries in one dtype.

The octree grids' corner query over every active LOD is
:func:`octree_corners`: on the CPU its plain twin
:func:`octree_corners_plain` (:func:`query_cells`, the trinkets' gather and
:func:`trilinear_coeffs` a LOD at a time), on the card ONE launch of kernel
Q1 (``csrc/octree_query.cu``) with the same outputs bit for bit, counted as
``launches/octree_query`` and run under the op record
``octree_query_launch``.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from shacira_tpu_torch.kernels import launch

# corner j of a cell sits at offset ((j >> 2) & 1, (j >> 1) & 1, j & 1):
# x is the high bit, as in the hash-grid kernels
CORNER_OFFSETS = tuple(((j >> 2) & 1, (j >> 1) & 1, j & 1) for j in range(8))


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def spread_bits(x: torch.Tensor) -> torch.Tensor:
    """Interleave two zeros between the bits of ``x`` (3D morton), up to 10
    input bits; int64 (``spread_bits_np`` and ``_spread_bits_jnp`` of the
    JAX package)."""
    x = x.long() & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(cells: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer cells -> int64 morton codes, x the high bit of each
    triple as in kaolin (``morton3d_np`` / ``morton3d``)."""
    return ((spread_bits(cells[..., 0]) << 2)
            | (spread_bits(cells[..., 1]) << 1)
            | spread_bits(cells[..., 2]))


def morton_decode(codes: torch.Tensor) -> torch.Tensor:
    """int64 morton codes [M] -> cells [M, 3] int64 (``morton_decode_np``)."""
    c = codes.long()
    out = []
    for shift in (2, 1, 0):
        x = (c >> shift) & 0x09249249
        x = (x | (x >> 2)) & 0x030C30C3
        x = (x | (x >> 4)) & 0x0300F00F
        x = (x | (x >> 8)) & 0x030000FF
        x = (x | (x >> 16)) & 0x3FF
        out.append(x)
    return torch.stack(out, dim=-1)


def quantize_points(coords: torch.Tensor, level: int) -> torch.Tensor:
    """[-1, 1]^3 points -> integer cells [N, 3] int64 at ``level``, computed
    in the points' own float dtype (kaolin ``quantize_points``)."""
    res = 2 ** level
    return torch.clamp(torch.floor((coords * 0.5 + 0.5) * res),
                       0, res - 1).long()


class Octree:
    """Sparse occupancy hierarchy: per level a sorted unique int64 morton
    code tensor (``level_codes[l]``), all on one device."""

    def __init__(self, level_codes: List[torch.Tensor], max_level: int):
        self.level_codes = level_codes
        self.max_level = max_level

    @classmethod
    def from_quantized_points(cls, cells, level: int) -> 'Octree':
        """The hierarchy above occupied leaf cells [M, 3] at ``level``
        (kaolin ``unbatched_points_to_octree``)."""
        codes = torch.unique(morton3d(_as_tensor(cells)), sorted=True)
        levels = [None] * (level + 1)
        levels[level] = codes
        for l in range(level - 1, -1, -1):
            codes = torch.unique(codes >> 3, sorted=True)
            levels[l] = codes
        return cls(levels, level)

    @classmethod
    def make_dense(cls, level: int, device='cpu') -> 'Octree':
        """Every cell occupied.  Morton coding maps the cells of a level
        one to one onto ``[0, 8^level)``, so each level's sorted codes are
        ``arange(8^l)``: what sorting the codes of every cell gives."""
        return cls([torch.arange(8 ** l, device=device)
                    for l in range(level + 1)], level)

    @classmethod
    def from_pointcloud(cls, pts, level: int, dilate: int = 0,
                        device=None) -> 'Octree':
        """The cells of points in [-1, 1]^3 (numpy or tensor; moved to
        ``device`` when given), each dilated by ``dilate`` cells."""
        cells = quantize_points(_as_tensor(pts, device), level)
        if dilate:
            r = torch.arange(-dilate, dilate + 1, device=cells.device)
            offs = torch.stack(torch.meshgrid(r, r, r, indexing='ij'),
                               dim=-1).reshape(-1, 3)
            cells = torch.clamp((cells[:, None, :] + offs[None]
                                 ).reshape(-1, 3), 0, 2 ** level - 1)
        return cls.from_quantized_points(cells, level)

    def num_cells(self, level: int) -> int:
        return int(self.level_codes[level].shape[0])

    def points(self, level: int) -> torch.Tensor:
        """Occupied cell coordinates [M, 3] at a level, in morton order."""
        return morton_decode(self.level_codes[level])

    def occupancy_mask(self, level: int) -> torch.Tensor:
        """Dense [res, res, res] bool of the occupied cells."""
        res = 2 ** level
        p = self.points(level)
        occ = torch.zeros((res, res, res), dtype=torch.bool, device=p.device)
        occ[p[:, 0], p[:, 1], p[:, 2]] = True
        return occ


def query_cells(sorted_codes: torch.Tensor, cells: torch.Tensor
                ) -> torch.Tensor:
    """Cells [..., 3] -> int64 index into ``sorted_codes``, or -1 where the
    cell is not in it (kaolin ``unbatched_query``).  The search index is
    clipped before the compare, as the JAX package clips it."""
    codes = morton3d(cells)
    idx = torch.searchsorted(sorted_codes, codes.reshape(-1)
                             ).reshape(codes.shape)
    idx = torch.clamp(idx, 0, sorted_codes.shape[0] - 1)
    return torch.where(sorted_codes[idx] == codes, idx, -1)


def build_dual(octree: Octree, level: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual octree at a level: (corners [C, 3] int64, the sorted unique
    lattice points of the occupied cells' corners; trinkets [M, 8] int32,
    each cell's 8 corner indices into ``corners``, corner j at offset
    :data:`CORNER_OFFSETS` [j]).

    A corner's key is ``(x * (R + 1) + y) * (R + 1) + z`` with ``R =
    2^level``, so a cell's corner keys are its own key plus a per-corner
    offset; the corners come back from the sorted unique keys."""
    n = 2 ** level + 1
    cells = octree.points(level)
    base = (cells[:, 0] * n + cells[:, 1]) * n + cells[:, 2]
    offs = torch.tensor([(ox * n + oy) * n + oz
                         for ox, oy, oz in CORNER_OFFSETS], device=base.device)
    keys, inv = torch.unique(base[:, None] + offs[None], sorted=True,
                             return_inverse=True)
    corners = torch.stack([keys // (n * n), keys // n % n, keys % n], dim=-1)
    return corners, inv.reshape(-1, 8).to(torch.int32)


def trilinear_coeffs(coords: torch.Tensor, cells: torch.Tensor,
                     level: int) -> torch.Tensor:
    """Weights [..., 8] of a cell's corners at ``coords`` inside it, corner
    j as in :func:`build_dual` (kaolin ``coords_to_trilinear_coeffs``)."""
    res = 2 ** level
    x = (coords * 0.5 + 0.5) * res
    frac = torch.clamp(x - cells.float(), 0.0, 1.0)
    fx, fy, fz = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    gx, gy, gz = 1 - fx, 1 - fy, 1 - fz
    return torch.cat([
        gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
        fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz], dim=-1)


def total_variation(features: torch.Tensor, trinkets: torch.Tensor
                    ) -> torch.Tensor:
    """Mean squared feature difference of a cell's corners adjacent along
    x, y and z, averaged over the three axes (wisp ``total_variation``)."""
    f = features[trinkets.long()]                         # [M, 8, F]
    dx = f[:, 4:] - f[:, :4]
    dy = f[:, [2, 3, 6, 7]] - f[:, [0, 1, 4, 5]]
    dz = f[:, [1, 3, 5, 7]] - f[:, [0, 2, 4, 6]]
    return (torch.mean(dx ** 2) + torch.mean(dy ** 2)
            + torch.mean(dz ** 2)) / 3.0


# ---------------------------------------------------------------------------
# The octree grids' corner query (kernel Q1)
# ---------------------------------------------------------------------------

MAX_QUERY_LODS = 16     # kernel Q1's kMaxQueryLods
MAX_QUERY_LOD = 10      # kMaxQueryLod: 10 bits an axis, as spread_bits keeps


def lod_corners_plain(codes: torch.Tensor, trinkets: torch.Tensor,
                      coords: torch.Tensor, lod: int):
    """One LOD of :func:`octree_corners_plain`: the corner rows [N, 8]
    int32 of each point's cell, its trilinear weights [N, 8] and whether
    the cell is in the octree [N]."""
    cells = torch.floor((coords * 0.5 + 0.5) * (2 ** lod)).to(torch.int32)
    cells = torch.clamp(cells, 0, 2 ** lod - 1)
    pidx = query_cells(codes, cells)
    corner_idx = trinkets[torch.clamp(pidx, min=0)]
    return corner_idx, trilinear_coeffs(coords, cells, lod), pidx >= 0


def octree_corners_plain(coords: torch.Tensor, tables: dict, lods) -> list:
    """Plain PyTorch version of kernel Q1: :func:`lod_corners_plain` for
    each LOD of ``lods``, with its ``tables['codes']`` and
    ``tables['trinkets']``."""
    return [lod_corners_plain(codes, trinkets, coords, lod)
            for codes, trinkets, lod in zip(tables['codes'],
                                            tables['trinkets'], lods)]


class _QueryLod(ctypes.Structure):
    """``struct QueryLod`` of ``csrc/octree_query.cu``: one LOD of kernel
    Q1."""
    _fields_ = [('codes', ctypes.c_void_p), ('trinkets', ctypes.c_void_p),
                ('corner_idx', ctypes.c_void_p), ('w', ctypes.c_void_p),
                ('valid', ctypes.c_void_p), ('m', ctypes.c_longlong),
                ('lod', ctypes.c_int)]


_QUERY = launch.Entry('octree_query', 'octree_query_forward', 'pq',
                      _QueryLod, 'i')


def _launch_query(coords: torch.Tensor, tables: dict, lods,
                  lib=None) -> list:
    """Launch ``octree_query_forward`` of ``lib`` (default: kernel Q1
    built from ``csrc/octree_query.cu``) on the current stream over every
    LOD; returns each LOD's (corner_idx, w, valid)."""
    lods = [int(l) for l in lods]
    codes, trinkets = list(tables['codes']), list(tables['trinkets'])
    if not lods or len({len(lods), len(codes), len(trinkets)}) != 1:
        raise ValueError(f'octree_corners: {len(lods)} LODs, {len(codes)} '
                         f'code tables and {len(trinkets)} trinket tables')
    if len(lods) > MAX_QUERY_LODS or not all(
            0 <= l <= MAX_QUERY_LOD for l in lods):
        raise ValueError(f'octree_corners: unsupported LODs {lods} on the '
                         f'card (up to {MAX_QUERY_LODS} of 0 to '
                         f'{MAX_QUERY_LOD})')
    if (coords.dim() != 2 or coords.shape[1] != 3
            or coords.dtype != torch.float32):
        raise ValueError('octree_corners: f32 coordinates [N, 3] expected, '
                         f'got {coords.dtype} {tuple(coords.shape)}')
    if coords.requires_grad and torch.is_grad_enabled():
        raise ValueError('octree_corners: no gradient flows to the '
                         'coordinates on the card')
    dev = coords.device
    for c, t in zip(codes, trinkets):
        m = c.shape[0] if c.dim() == 1 else 0
        if (c.dtype != torch.int64 or m < 1
                or tuple(t.shape) != (m, 8) or t.dtype != torch.int32):
            raise ValueError(
                'octree_corners: sorted int64 codes [M] and int32 trinkets '
                f'[M, 8], M >= 1, expected, got {c.dtype} '
                f'{tuple(c.shape)} and {t.dtype} {tuple(t.shape)}')
        if c.device != dev or t.device != dev:
            raise ValueError('octree_corners: coordinates and tables on one '
                             'device expected')
    coords = coords.contiguous()
    codes = [c.contiguous() for c in codes]
    trinkets = [t.contiguous() for t in trinkets]
    n = coords.shape[0]
    outs = [(torch.empty((n, 8), dtype=torch.int32, device=dev),
             torch.empty((n, 8), dtype=torch.float32, device=dev),
             torch.empty((n,), dtype=torch.bool, device=dev))
            for _ in lods]
    arr = (_QueryLod * len(lods))(*[
        _QueryLod(c.data_ptr(), t.data_ptr(), ci.data_ptr(), w.data_ptr(),
                  v.data_ptr(), c.shape[0], lod)
        for c, t, (ci, w, v), lod in zip(codes, trinkets, outs, lods)])
    # a profile gives a ctypes launch to the innermost op record on its
    # thread, which a record_function range is not: without one of its
    # own, Q1 would fall outside 'field/octree_query'
    with torch._C._profiler._RecordFunctionFast('octree_query_launch'):
        _QUERY(dev, coords.data_ptr(), n, arr, len(lods), lib=lib)
    return outs


def octree_corners(coords: torch.Tensor, tables: dict, lods) -> list:
    """Each LOD's (corner rows [N, 8] int32, trilinear weights [N, 8] f32,
    valid [N] bool) of the points ``coords`` [N, 3] in [-1, 1]^3 (outside
    it, the nearest cell), per LOD of ``lods`` with its sorted codes
    ``tables['codes']`` and trinkets ``tables['trinkets']`` (an
    ``OctreeStructure.tables()``).  A point whose cell is not in the
    octree takes trinket row 0 and ``valid`` False.

    CPU tensors take :func:`octree_corners_plain`; CUDA tensors ONE launch
    of kernel Q1 over every LOD, equal to it bit for bit (counted as
    ``launches/octree_query``).  On the card no gradient flows to the
    coordinates: they may not require one."""
    return launch.dispatch(
        'octree_query', coords.device,
        lambda: octree_corners_plain(coords, tables, lods),
        lambda: (_launch_query(coords, tables, lods),
                 1 if coords.shape[0] else 0))
