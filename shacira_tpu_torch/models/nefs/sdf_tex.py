"""NeuralSDFTex: a signed distance and an RGB colour from one head.

Port of ``shacira_tpu/models/nefs/sdf_tex.py``: NeuralSDF's grid and input,
a 4-output MLP split into the distance and a sigmoid colour.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from shacira_tpu_torch.models.grids import latent_grid as lg
from shacira_tpu_torch.models.mlp import mlp_apply, mlp_init
from shacira_tpu_torch.models.nefs.sdf import NeuralSDFConfig, sdf_head_input


@dataclass(frozen=True)
class NeuralSDFTexConfig(NeuralSDFConfig):
    @property
    def output_dim(self) -> int:
        return 4


def neural_sdf_tex_init(generator: torch.Generator, cfg: NeuralSDFTexConfig,
                        device) -> dict:
    return {'grid': lg.latent_grid_init(generator, cfg.grid, device),
            'decoder': mlp_init(generator, cfg.mlp_cfg, device)}


def neural_sdf_tex(params: dict, cfg: NeuralSDFTexConfig,
                   coords: torch.Tensor, *,
                   lod_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords [..., 3] -> (sdf [..., 1], rgb [..., 3] in (0, 1))."""
    out = mlp_apply(params['decoder'], cfg.mlp_cfg,
                    sdf_head_input(params, cfg, coords, lod_mask))
    return out[..., :1], torch.sigmoid(out[..., 1:4])
