"""Rays: origins, directions and per-ray distance bounds.  Port of
``shacira_tpu/core/rays.py`` as a plain dataclass of tensors."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Rays:
    origins: torch.Tensor     # [R, 3]
    dirs: torch.Tensor        # [R, 3]
    dist_min: torch.Tensor    # [R]
    dist_max: torch.Tensor    # [R]


def make_rays(origins, dirs, dist_min=0.0, dist_max=6.0) -> Rays:
    origins = torch.as_tensor(origins, dtype=torch.float32)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=origins.device)
    lead = origins.shape[:-1]

    def bound(v):
        if isinstance(v, (int, float)):     # a fill: no host-to-device copy
            return torch.full(lead, float(v), dtype=torch.float32,
                              device=origins.device)
        v = torch.as_tensor(v, dtype=torch.float32, device=origins.device)
        return torch.broadcast_to(v, lead)

    return Rays(origins, dirs, bound(dist_min), bound(dist_max))
