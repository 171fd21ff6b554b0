"""NeuralSDF: 3D coordinates -> signed distance.

Port of ``shacira_tpu/models/nefs/sdf.py``: latent hash-grid features
(optionally after a positional embedding or the raw position) into a
one-output MLP.  The grid encode is ``latent_grid.interpolate``, whose
backward into the table is one launch of kernel B1 (``ops/hashgrid.py``);
like the JAX package's ``hash_encode`` it gives no gradient with respect to
the coordinates, so the field's autodiff gradient is the MLP's
raw-position path alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.profiler import record_function

from shacira_tpu_torch.models.embedders import (
    PositionalEmbedderConfig, positional_embed)
from shacira_tpu_torch.models.grids import latent_grid as lg
from shacira_tpu_torch.models.mlp import (
    MLPConfig, mlp_apply, mlp_init, mlp_size_bits)


@dataclass(frozen=True)
class NeuralSDFConfig:
    grid: lg.LatentGridConfig
    hidden_dim: int = 128
    num_layers: int = 1
    activation: str = 'relu'
    pos_embedder: str = 'none'            # 'none' | 'identity' | 'positional'
    pos_multires: int = 4
    position_input: bool = True

    @property
    def pos_embed_dim(self) -> int:
        if self.pos_embedder == 'positional':
            return PositionalEmbedderConfig(
                self.pos_multires, 3, include_input=self.position_input
            ).output_dim
        if self.pos_embedder == 'identity' or (
                self.pos_embedder == 'none' and self.position_input):
            return 3
        return 0

    @property
    def output_dim(self) -> int:
        return 1

    @property
    def mlp_cfg(self) -> MLPConfig:
        return MLPConfig(input_dim=self.grid.output_dim + self.pos_embed_dim,
                         output_dim=self.output_dim,
                         hidden_dim=self.hidden_dim,
                         num_layers=self.num_layers,
                         activation=self.activation)


def neural_sdf_init(generator: torch.Generator, cfg: NeuralSDFConfig,
                    device) -> dict:
    return {'grid': lg.latent_grid_init(generator, cfg.grid, device),
            'decoder': mlp_init(generator, cfg.mlp_cfg, device)}


def sdf_head_input(params: dict, cfg: NeuralSDFConfig, coords: torch.Tensor,
                   lod_mask: Optional[torch.Tensor] = None,
                   decoded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MLP's input: grid features after the embedded (or raw)
    position when the config asks for one."""
    with record_function('field/encode'):
        feats = lg.interpolate(params['grid'], cfg.grid, coords,
                               lod_mask=lod_mask, decoded=decoded)
        if cfg.pos_embed_dim:
            if cfg.pos_embedder == 'positional':
                emb = positional_embed(PositionalEmbedderConfig(
                    cfg.pos_multires, 3, include_input=cfg.position_input),
                    coords)
            else:
                emb = coords
            feats = torch.cat([emb, feats], dim=-1)
    return feats


def neural_sdf(params: dict, cfg: NeuralSDFConfig, coords: torch.Tensor, *,
               lod_mask: Optional[torch.Tensor] = None,
               decoded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """coords [..., 3] -> sdf [..., 1]; ``lod_mask`` [num_lods] 0/1 masks
    the features of LODs."""
    feats = sdf_head_input(params, cfg, coords, lod_mask, decoded)
    with record_function('field/head'):
        return mlp_apply(params['decoder'], cfg.mlp_cfg, feats)


def finitediff_gradient(params: dict, cfg: NeuralSDFConfig,
                        coords: torch.Tensor,
                        eps: float = 5e-4) -> torch.Tensor:
    """Central-difference SDF gradient [..., 3] (for normals)."""
    offs = torch.eye(3, device=coords.device) * eps
    return torch.cat([(neural_sdf(params, cfg, coords + offs[i])
                       - neural_sdf(params, cfg, coords - offs[i])) / (2 * eps)
                      for i in range(3)], dim=-1)


def non_grid_size_bits(params: dict) -> int:
    return mlp_size_bits(params['decoder'])
