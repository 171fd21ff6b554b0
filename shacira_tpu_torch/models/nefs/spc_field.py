"""SPCField: renders a colored voxel point cloud (no neural decoder).

Port of ``shacira_tpu/models/nefs/spc_field.py`` on the port's morton codes
(``ops/spc.py``): each occupied octree cell carries the mean color of its
points; a query returns the cell's color with a large constant density, so
the RF tracer composites the first hit; empty cells are transparent.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shacira_tpu_torch.ops import spc


@dataclass(frozen=True)
class SPCFieldConfig:
    level: int = 7
    density_scale: float = 1e3     # opaque voxels


class SPCField:
    """Static colored voxel field built from a point cloud."""

    def __init__(self, cfg: SPCFieldConfig, points, colors, device):
        """points [N, 3] in [-1, 1]; colors [N, 3] in [0, 1], averaged per
        occupied cell."""
        self.cfg = cfg
        points = torch.as_tensor(np.asarray(points, np.float32),
                                 device=device)
        colors = torch.as_tensor(np.asarray(colors, np.float32),
                                 device=device)
        codes = spc.morton3d(spc.quantize_points(points, cfg.level))
        self.codes, inverse = torch.unique(codes, sorted=True,
                                           return_inverse=True)
        m = self.codes.shape[0]
        sums = torch.zeros((m, 3), dtype=torch.float64, device=device)
        sums.index_add_(0, inverse, colors.double())
        counts = torch.bincount(inverse, minlength=m).double()
        self.colors = (sums / counts[:, None]).float()

    def rgba(self, coords: torch.Tensor, ray_d=None):
        """coords [..., 3] -> (rgb [..., 3], density [..., 1])."""
        res = 2 ** self.cfg.level
        cells = torch.clamp(torch.floor((coords * 0.5 + 0.5) * res), 0,
                            res - 1).long()
        idx = spc.query_cells(self.codes, cells)
        valid = (idx >= 0)[..., None]
        rgb = torch.where(valid, self.colors[torch.clamp(idx, min=0)], 0.0)
        density = torch.where(valid, self.cfg.density_scale, 0.0)
        return rgb, density

    def occupancy_mask(self) -> np.ndarray:
        """Dense [res, res, res] bool of the occupied cells."""
        res = 2 ** self.cfg.level
        occ = np.zeros((res, res, res), bool)
        pts = spc.morton_decode(self.codes).cpu().numpy()
        occ[pts[:, 0], pts[:, 1], pts[:, 2]] = True
        return occ
