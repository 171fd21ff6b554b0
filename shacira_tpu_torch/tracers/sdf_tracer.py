"""SDF sphere tracer.

Port of ``shacira_tpu/tracers/sdf_tracer.py``: every ray carries its own
state through a fixed number of masked steps (the JAX package's
``fori_loop``, compiled by XLA, with no Pallas kernel: here PyTorch ops).
The loop has no early exit, which would read a flag back from the card
every step.  Rays enter at the unit cube (``+1e-5``); a sample in an empty
cell of the occupancy grid advances at least to that cell's exit; a ray
hits where ``|sdf| < min_dis`` or ``|sdf + sdf_prev| / 2 < 5 min_dis``
and stops past ``dist_max``.  Normals are the field's gradient at the hits.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from shacira_tpu_torch.accel import occupancy as occ
from shacira_tpu_torch.core.rays import Rays


@dataclass(frozen=True)
class SDFTracerConfig:
    num_steps: int = 64
    step_size: float = 0.8
    min_dis: float = 1e-3


@torch.no_grad()
def trace(sdf_fn, occ_state: dict, occ_cfg: occ.OccupancyGridConfig,
          cfg: SDFTracerConfig, rays: Rays) -> dict:
    """Sphere-trace rays against ``sdf_fn(coords [R, 3]) -> [R, 1]``.

    Returns hit [R] bool, depth [R, 1] and xyz [R, 3] (zero where the ray
    missed)."""
    R = rays.origins.shape[0]
    o, d = rays.origins, rays.dirs
    safe_d = torch.where(torch.abs(d) < 1e-9, 1e-9, d)
    t0 = (-1.0 - o) / safe_d
    t1 = (1.0 - o) / safe_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    dist_max = torch.minimum(torch.broadcast_to(rays.dist_max, (R,)), tmax)
    t = torch.maximum(torch.broadcast_to(rays.dist_min, (R,)), tmin) + 1e-5
    alive = tmax > tmin
    res = occ_cfg.res
    cell_w = 2.0 / res
    positive = d > 0

    def cell_exit_t(x, t):
        """Distance along each ray to the exit of its current cell."""
        idx = torch.clamp(torch.floor((x * 0.5 + 0.5) * res), 0, res - 1)
        bounds = (idx + positive) * cell_w - 1.0
        te = torch.amin((bounds - o) / safe_d, dim=-1)
        return torch.maximum(te, t + 1e-5)

    hit = torch.zeros(R, dtype=torch.bool, device=o.device)
    dist_prev = torch.full((R,), 20.0, device=o.device)
    for _ in range(cfg.num_steps):
        x = o + d * t[:, None]
        occupied = occ.query(occ_state, occ_cfg, x)
        sdf = sdf_fn(x)[..., 0] * cfg.step_size
        # empty-space skip: to the cell's exit at least
        step = torch.where(occupied, sdf,
                           torch.maximum(sdf, cell_exit_t(x, t) - t))
        new_hit = alive & occupied & (
            (torch.abs(sdf) < cfg.min_dis)
            | (torch.abs(sdf + dist_prev) * 0.5 < cfg.min_dis * 5))
        hit = hit | new_hit
        t = torch.where(alive & ~new_hit, t + step, t)
        alive = alive & ~hit & (t < dist_max)
        dist_prev = torch.where(alive, sdf, dist_prev)

    x = o + d * t[:, None]
    return {'hit': hit, 'depth': torch.where(hit[:, None], t[:, None], 0.0),
            'xyz': torch.where(hit[:, None], x, 0.0)}


def shade_normals(sdf_grad_fn, result: dict) -> dict:
    """Normals and normal-coloured rgb at the hits: adds normal [R, 3],
    rgb [R, 3] and alpha [R, 1]."""
    grad = sdf_grad_fn(result['xyz'])
    normal = grad / (torch.linalg.norm(grad, dim=-1, keepdim=True) + 1e-5)
    normal = torch.where(result['hit'][:, None], normal, 0.0)
    rgb = (normal + 1.0) / 2.0
    alpha = result['hit'][:, None].float()
    return {**result, 'normal': normal, 'rgb': rgb * alpha, 'alpha': alpha}
