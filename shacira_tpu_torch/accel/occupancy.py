"""Dense occupancy grid -- the acceleration structure of the NeRF march.

Port of the 'ray'-march part of ``shacira_tpu/accel/occupancy.py``: a dense
boolean volume of ``(2**level)**3`` cells with the NGP-style pruning update.
Every random draw (march jitter, prune points) is an argument; the voxel
DDA march waits for ROADMAP Queue A item 11.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from shacira_tpu_torch.core.rays import Rays


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
