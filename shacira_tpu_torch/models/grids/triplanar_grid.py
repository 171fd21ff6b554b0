"""TriplanarGrid -- a multi-LOD pyramid of orthogonal feature planes.

Port of ``shacira_tpu/models/grids/triplanar_grid.py``: per LOD three
``(2^l + 1)^2`` feature maps sampled bilinearly (align_corners) at the
(y, z), (x, z) and (x, y) projections of a point and concatenated, then
summed or concatenated across LODs.  Coordinates are clipped to the plane,
not reflected, as in the JAX package.

Each plane is read as ``[(S+1)^2, F]`` rows: the texels of every plane of
every LOD are gathered with ONE :func:`ops.scatter.gather_rows`, whose
forward is one launch of kernel R1 and whose backward is one launch of
kernel B1 over all twelve planes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from shacira_tpu_torch.ops.scatter import gather_rows

# plane name and the coordinate axes it is sampled at
PLANES = (('yz', (1, 2)), ('xz', (0, 2)), ('xy', (0, 1)))


@dataclass(frozen=True)
class TriplanarGridConfig:
    feature_dim: int                    # per plane; a LOD gives 3x
    base_lod: int = 4
    num_lods: int = 4
    multiscale_type: str = 'sum'
    feature_std: float = 0.0
    feature_bias: float = 0.0

    @property
    def active_lods(self) -> Tuple[int, ...]:
        return tuple(self.base_lod + i for i in range(self.num_lods))

    @property
    def output_dim(self) -> int:
        per_lod = self.feature_dim * 3
        return per_lod * self.num_lods if self.multiscale_type == 'cat' \
            else per_lod


def triplanar_grid_init(generator: torch.Generator, cfg: TriplanarGridConfig,
                        device) -> dict:
    """Per LOD three [S+1, S+1, F] planes, N(bias, std)."""
    planes = []
    for lod in cfg.active_lods:
        s = 2 ** lod + 1
        planes.append({ax: torch.randn((s, s, cfg.feature_dim),
                                       generator=generator, device=device)
                       * cfg.feature_std + cfg.feature_bias
                       for ax, _ in PLANES})
    return {'planes': planes}


def _plane_texels(s: int, uv: torch.Tensor):
    """Rows [N, 4] of the texels around ``uv`` [N, 2] in [-1, 1]^2 on an
    ``s`` x ``s`` plane, in the order (i, j), (i, j+1), (i+1, j),
    (i+1, j+1), and the fractions (fx [N, 1], fy [N, 1])."""
    x = torch.clamp((uv + 1.0) * 0.5 * (s - 1), 0.0, s - 1)
    lo = torch.clamp(torch.floor(x), 0, s - 2).to(torch.int32)
    frac = x - lo
    r = lo[:, 0].long() * s + lo[:, 1]
    rows = torch.stack([r, r + 1, r + s, r + s + 1], dim=-1)
    return rows, frac[:, 0:1], frac[:, 1:2]


def interpolate(params: dict, cfg: TriplanarGridConfig,
                coords: torch.Tensor) -> torch.Tensor:
    """coords [..., 3] -> features [..., output_dim]."""
    lead = coords.shape[:-1]
    c = coords.reshape(-1, 3)
    tables, idx, fracs = [], [], []
    for lod_planes in params['planes']:
        for ax, axes in PLANES:
            plane = lod_planes[ax]
            s = plane.shape[0]
            # two columns stacked: indexing with a tuple would copy it to
            # the device, a stream sync each plane
            uv = torch.stack((c[:, axes[0]], c[:, axes[1]]), dim=-1)
            rows, fx, fy = _plane_texels(s, uv)
            tables.append(plane.reshape(s * s, plane.shape[-1]))
            idx.append(rows)
            fracs.append((fx, fy))
    texels = gather_rows(tables, idx)                     # each [N, 4, F]
    samples = []
    for t, (fx, fy) in zip(texels, fracs):
        samples.append((1 - fx) * (1 - fy) * t[:, 0] + (1 - fx) * fy * t[:, 1]
                       + fx * (1 - fy) * t[:, 2] + fx * fy * t[:, 3])
    feats = [torch.cat(samples[i:i + 3], dim=-1)
             for i in range(0, len(samples), 3)]
    stacked = torch.stack(feats, dim=1)                   # [N, L, 3F]
    out = (stacked.sum(dim=1) if cfg.multiscale_type == 'sum'
           else stacked.reshape(stacked.shape[0], -1))
    return out.reshape(*lead, out.shape[-1])


def grid_size_bits(params: dict) -> int:
    return sum(int(v.numel()) * 32 for lod_planes in params['planes']
               for v in lod_planes.values())
