"""Dense occupancy grid -- the acceleration structure of the NeRF march.

Port of ``shacira_tpu/accel/occupancy.py``: a dense boolean volume of
``(2**level)**3`` cells with the NGP-style pruning update, its seeding from
a depth point cloud (RTMV), the ``'ray'`` march and the ``'voxel'`` march.
Every random draw (march jitter, prune points) is an argument.

The voxel march's DDA walk (:func:`voxel_crossings`) is kernel V1
(``csrc/voxel_dda.cu``, a walker and a recorder warp per 32 rays) on a
CUDA tensor and the plain step loop :func:`voxel_crossings_plain` on a
CPU tensor; the JAX package runs it as a ``lax.scan``, which has no
Pallas kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from shacira_tpu_torch.core.rays import Rays
from shacira_tpu_torch.kernels import launch
from shacira_tpu_torch.utils import perf


@dataclass(frozen=True)
class OccupancyGridConfig:
    level: int = 7                 # grid res = 2**level per axis

    @property
    def res(self) -> int:
        return 2 ** self.level

    @property
    def num_cells(self) -> int:
        return self.res ** 3


def occupancy_init(cfg: OccupancyGridConfig, device,
                   occupied: bool = True) -> dict:
    """'density': decayed max density per cell; 'occ': boolean mask."""
    res = cfg.res
    return {'density': torch.zeros((res, res, res), device=device),
            'occ': torch.full((res, res, res), occupied, dtype=torch.bool,
                              device=device)}


def occupancy_from_points(cfg: OccupancyGridConfig, points, device,
                          dilate: int = 1) -> dict:
    """Occupancy state seeded from a [-1,1]^3 point cloud: the cells that
    hold a point, max-dilated by ``dilate`` cells (a 3D max filter of width
    ``2 * dilate + 1``, zero outside the grid); densities start at zero, so
    a prune keeps the seed until the field's density forms."""
    res = cfg.res
    idx = np.clip(((np.asarray(points) * 0.5 + 0.5) * res), 0,
                  res - 1e-5).astype(np.int64)
    occ = np.zeros((res, res, res), bool)
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    o = torch.as_tensor(occ, device=device)
    if dilate > 0:
        k = 2 * dilate + 1
        o = F.max_pool3d(o.float()[None, None], k, stride=1,
                         padding=dilate)[0, 0] > 0
    return {'density': torch.zeros((res, res, res), device=device), 'occ': o}


def cell_index(cfg: OccupancyGridConfig, coords: torch.Tensor) -> torch.Tensor:
    """[-1,1]^3 coords -> integer cell ids [..., 3] (clamped)."""
    res = cfg.res
    x = torch.clamp((coords * 0.5 + 0.5) * res, 0, res - 1e-5)
    return torch.floor(x).long()


def query(state: dict, cfg: OccupancyGridConfig,
          coords: torch.Tensor) -> torch.Tensor:
    """Occupancy at coords; False outside the unit cube."""
    idx = cell_index(cfg, coords)
    inside = torch.all((coords >= -1.0) & (coords <= 1.0), dim=-1)
    occ = state['occ'][idx[..., 0], idx[..., 1], idx[..., 2]]
    return occ & inside


def prune_update(state: dict, cfg: OccupancyGridConfig, density: torch.Tensor,
                 *, density_decay: float, min_density: float) -> dict:
    """NGP pruning: decay the tracked density, take the max with the fresh
    [num_cells] samples (x-major raster order), threshold; if nothing
    survives keep the previous occupancy."""
    res = cfg.res
    d = torch.maximum(state['density'] * density_decay,
                      density.reshape(res, res, res))
    occ_new = d > min_density
    occ_new = torch.where(torch.any(occ_new), occ_new, state['occ'])
    return {'density': d, 'occ': occ_new}


def march_uniform(source, shape, device) -> torch.Tensor:
    """March jitter: a pre-drawn U(0,1) tensor of exactly ``shape``, or a
    ``torch.Generator`` to draw it from."""
    if isinstance(source, torch.Tensor):
        if tuple(source.shape) != tuple(shape):
            raise ValueError(
                f'pre-drawn march jitter shape {tuple(source.shape)} != '
                f'{tuple(shape)}')
        return source
    return torch.rand(shape, generator=source, device=device)


def cell_centers_jittered(cfg: OccupancyGridConfig,
                          u: torch.Tensor) -> torch.Tensor:
    """One point per cell, ``(cell + u) / res * 2 - 1`` with ``u`` a
    [num_cells, 3] U(0,1) draw; cells in x-major raster order."""
    res = cfg.res
    ar = torch.arange(res, device=u.device)
    ii = torch.stack(torch.meshgrid(ar, ar, ar, indexing='ij'),
                     dim=-1).reshape(-1, 3)
    return ((ii + u) / res) * 2.0 - 1.0


def linspace01(n: int, device) -> torch.Tensor:
    """``linspace(0, 1, n)`` in f32 computed as ``i * (1 / (n - 1))``, the
    formula whose values equal ``jnp.linspace`` bit for bit."""
    if n == 1:
        return torch.zeros((1,), device=device)
    return torch.arange(n, dtype=torch.float32, device=device) * (1.0 / (n - 1))


def raymarch_ray(state: dict, cfg: OccupancyGridConfig, rays: Rays,
                 num_steps: int, jitter) -> dict:
    """'ray' raymarching: ``num_steps`` jittered samples per ray and an
    occupancy mask.  ``depth = (linspace(0,1,S) + U/S)`` scaled to
    ``[dist_min, dist_max]``; ``deltas = diff(depth, prepend=dist_min)``.

    ``jitter``: [R, S] U(0,1) tensor or a generator.
    Returns samples [R,S,3], depth [R,S], deltas [R,S], mask [R,S]."""
    R = rays.origins.shape[0]
    dev = rays.origins.device
    base = linspace01(num_steps, dev)
    u = march_uniform(jitter, (R, num_steps), dev)
    t = base[None, :] + u / num_steps
    dmin = rays.dist_min[:, None]
    dmax = rays.dist_max[:, None]
    depth = t * (dmax - dmin) + dmin
    samples = rays.origins[:, None, :] + rays.dirs[:, None, :] * depth[..., None]
    mask = query(state, cfg, samples)
    deltas = torch.diff(depth, dim=-1, prepend=dmin)
    return {'samples': samples, 'depth': depth, 'deltas': deltas, 'mask': mask}


# ---------------------------------------------------------------------------
# 'voxel' march: DDA crossings (kernel V1) and samples inside them
# ---------------------------------------------------------------------------

DDA_EPS = 1e-6


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors with ONE rounding, as a fused
    multiply-add gives it: the product is exact in f64, the f64 sum's error
    is recovered exactly (two-sum) and the sum rounded to odd, after which
    rounding to f32 is correct (53 >= 24 + 2 bits)."""
    a, b, c = a.double(), b.double(), c.double()
    prod = a * b                                     # exact: 48 bits
    s = prod + c
    bb = s - c
    err = (c - (s - bb)) + (prod - bb)               # s + err == prod + c
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _safe_dirs(d: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)


def _box_interval(rays: Rays):
    """(tmin, tmax) [R]: the rays' [dist_min, dist_max] clipped to their
    [-1, 1]^3 box interval (empty when tmax <= tmin)."""
    o, sd = rays.origins, _safe_dirs(rays.dirs)
    t0 = (-1.0 - o) / sd
    t1 = (1.0 - o) / sd
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (torch.maximum(tmin, rays.dist_min),
            torch.minimum(tmax, rays.dist_max))


def dda_steps(state: dict, cfg: OccupancyGridConfig, rays: Rays):
    """Every one of the ``3 * res + 2`` steps of the bounded DDA, the scan
    body's arithmetic in its order, vectorized over rays: [R, L] each of
    the step's entry t, its exit t clipped to the ray's ``tmax``, whether
    its cell is occupied (inside the grid, ``t < tmax``), and whether ``t <
    tmax`` (the steps kernel V1 walks before it stops)."""
    res = cfg.res
    o, d = rays.origins, rays.dirs
    sd = _safe_dirs(d)
    tmin, tmax = _box_interval(rays)
    cell_w = 2.0 / res
    up = (d > 0).long()
    occ = state['occ'].reshape(-1)
    t = tmin
    t_ent, t_exi, occ_l, ahead = [], [], [], []
    for _ in range(3 * res + 2):
        te = t + DDA_EPS
        p = fma_f32(d, te[:, None].expand_as(d), o)
        x = torch.floor((p * 0.5 + 0.5) * res)
        inside = torch.all((x >= 0) & (x < res), dim=-1) & (t < tmax)
        cell = torch.clamp(x, 0, res - 1).long()
        bounds = (cell + up).float() * cell_w - 1.0
        t_exit = torch.maximum(torch.amin((bounds - o) / sd, dim=-1), te)
        t_ent.append(t)
        t_exi.append(torch.minimum(t_exit, tmax))
        occ_l.append(occ[(cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]]
                     & inside)
        ahead.append(t < tmax)
        t = t_exit
    return tuple(torch.stack(v, dim=1) for v in (t_ent, t_exi, occ_l, ahead))


def voxel_crossings_plain(state: dict, cfg: OccupancyGridConfig, rays: Rays,
                          max_intersections: int = 64) -> dict:
    """Plain PyTorch version of :func:`voxel_crossings`: all the DDA's
    steps (:func:`dda_steps`), then the occupied ones fill the slots by
    rank, as the JAX package compacts them (slots past the count stay
    0)."""
    R = rays.origins.shape[0]
    dev = rays.origins.device
    tmin, tmax = _box_interval(rays)
    t_ent, t_exi, occ_l, _ = dda_steps(state, cfg, rays)
    occ_l = occ_l & (tmax > tmin)[:, None]                     # [R, L]
    rank = torch.cumsum(occ_l.long(), dim=1) - 1
    kept = occ_l & (rank < max_intersections)
    slot = torch.where(kept, rank, torch.full_like(rank, max_intersections))
    flat = (torch.arange(R, device=dev)[:, None] * (max_intersections + 1)
            + slot)[kept]

    def fill(v):
        out = torch.zeros((R * (max_intersections + 1),), device=dev)
        out[flat] = v[kept]
        return out.reshape(R, max_intersections + 1)[:, :-1]

    count = kept.sum(dim=1)
    valid = (torch.arange(max_intersections, device=dev)[None, :]
             < count[:, None])
    return {'entries': fill(t_ent), 'exits': fill(t_exi), 'valid': valid}


_DDA = launch.Entry('voxel_dda', 'voxel_dda', 'ppppppppqii')


def _launch_dda(state: dict, cfg: OccupancyGridConfig, rays: Rays,
                max_intersections: int, lib=None) -> dict:
    """Launch ``voxel_dda`` of ``lib`` (default: kernel V1 built from
    ``csrc/voxel_dda.cu``) on the current stream."""
    res = cfg.res
    occ = state['occ']
    if occ.dtype != torch.bool or tuple(occ.shape) != (res, res, res):
        raise ValueError(f'voxel_crossings: occupancy must be bool '
                         f'{(res,) * 3}, got {occ.dtype} {tuple(occ.shape)}')
    dev = rays.origins.device
    R = rays.origins.shape[0]
    ins = [rays.origins, rays.dirs, rays.dist_min, rays.dist_max]
    if occ.device != dev or any(t.device != dev or t.dtype != torch.float32
                                for t in ins):
        raise ValueError('voxel_crossings: f32 rays and the occupancy must '
                         'lie on one device')
    o, d, dmin, dmax = (t.contiguous() for t in ins)
    occ = occ.contiguous()
    shape = (R, max_intersections)
    entries = torch.empty(shape, dtype=torch.float32, device=dev)
    exits = torch.empty(shape, dtype=torch.float32, device=dev)
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    # a profile gives a ctypes launch to the innermost op record on its
    # thread, which a record_function range is not: without one of its
    # own, V1 would fall outside 'trace/dda'
    with torch._C._profiler._RecordFunctionFast('dda_launch'):
        _DDA(dev, o.data_ptr(), d.data_ptr(), dmin.data_ptr(),
             dmax.data_ptr(), occ.data_ptr(), entries.data_ptr(),
             exits.data_ptr(), valid.data_ptr(), R, res, max_intersections,
             lib=lib)
    return {'entries': entries, 'exits': exits, 'valid': valid}


def voxel_crossings(state: dict, cfg: OccupancyGridConfig, rays: Rays,
                    max_intersections: int = 64) -> dict:
    """Occupied-cell crossings of the bounded DDA: ``entries``, ``exits``
    [R, I] f32 and ``valid`` [R, I] bool, the first ``I`` crossings of each
    ray in depth order (slots past the count hold 0).

    CPU tensors take :func:`voxel_crossings_plain`; CUDA tensors launch
    kernel V1, which walks each ray with the same arithmetic.  The walk
    runs in the range ``trace/dda`` (V1's launch belongs to it in a
    profile); while a profiler records, a training step's valid crossings
    are counted as ``trace/crossings`` (no sync)."""
    with record_function('trace/dda'):
        c = launch.dispatch(
            'voxel_crossings', rays.origins.device,
            lambda: voxel_crossings_plain(state, cfg, rays,
                                          max_intersections),
            lambda: (_launch_dda(state, cfg, rays, max_intersections), 1))
    if perf.tracing() and torch.is_grad_enabled():
        perf.count('trace/crossings', c['valid'].sum())
    return c


def raymarch_voxel(state: dict, cfg: OccupancyGridConfig, rays: Rays,
                   num_steps: int, jitter, max_intersections: int = 64
                   ) -> dict:
    """'voxel' raymarching: the DDA crossings, then ``num_steps`` jittered
    samples inside each crossing, ``depth = entry + (exit - entry) * (j +
    u_j) / num_steps``, each sample's delta ``(exit - entry) / num_steps``.

    ``jitter``: [R, I, S] U(0,1) tensor or a generator.
    Returns samples [R, I*S, 3], depth, deltas [R, I*S], mask [R, I*S]."""
    R = rays.origins.shape[0]
    dev = rays.origins.device
    o, d = rays.origins, rays.dirs
    c = voxel_crossings(state, cfg, rays, max_intersections)
    entries, exits = c['entries'], c['exits']
    u = march_uniform(jitter, (R, max_intersections, num_steps), dev)
    frac = (torch.arange(num_steps, device=dev) + u) / num_steps
    depth = (entries[..., None]
             + (exits - entries)[..., None] * frac).reshape(R, -1)
    shape = (R, max_intersections, num_steps)
    deltas = ((exits - entries) / num_steps)[..., None].expand(shape)
    mask = c['valid'][..., None].expand(shape)
    samples = o[:, None, :] + d[:, None, :] * depth[..., None]
    return {'samples': samples, 'depth': depth,
            'deltas': deltas.reshape(R, -1), 'mask': mask.reshape(R, -1)}
