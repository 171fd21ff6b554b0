"""NeuralImage: 2D coordinates -> RGB.

Port of ``shacira_tpu/models/nefs/image.py``: latent hash-grid features,
optionally concatenated with the positionally embedded (or raw)
coordinates, fed to a small MLP colour head and a final activation.  The
grid encode takes the fused latent-width path (``affine=``), a pre-decoded
feature table (``decoded=``) or a fresh decode of the codebook, as the
NeRF field does.  The JAX package's ``encoder=`` hook (its lattice encode,
TPU staging for the full pixel lattice) has no counterpart: the port's
full-image step runs ``hash_encode_affine`` on the lattice coordinates in
row-major order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from shacira_tpu_torch.models.embedders import (
    PositionalEmbedderConfig, positional_embed)
from shacira_tpu_torch.models.grids import latent_grid as lg
from shacira_tpu_torch.models.mlp import (
    MLPConfig, get_activation, mlp_apply, mlp_init, mlp_size_bits)


@dataclass(frozen=True)
class NeuralImageConfig:
    grid: lg.LatentGridConfig
    hidden_dim: int = 128
    num_layers: int = 1
    activation: str = 'relu'
    final_activation: str = 'none'
    pos_embedder: str = 'none'            # 'none' | 'identity' | 'positional'
    pos_multires: int = 10
    position_input: bool = False

    @property
    def pos_embed_dim(self) -> int:
        if self.pos_embedder == 'positional':
            return PositionalEmbedderConfig(
                self.pos_multires, 2, include_input=self.position_input
            ).output_dim
        if self.pos_embedder == 'identity' or (
                self.pos_embedder == 'none' and self.position_input):
            return 2
        return 0

    @property
    def mlp_cfg(self) -> MLPConfig:
        return MLPConfig(input_dim=self.grid.output_dim + self.pos_embed_dim,
                         output_dim=3, hidden_dim=self.hidden_dim,
                         num_layers=self.num_layers,
                         activation=self.activation)


def neural_image_init(generator: torch.Generator, cfg: NeuralImageConfig,
                      device) -> dict:
    return {'grid': lg.latent_grid_init(generator, cfg.grid, device),
            'decoder_color': mlp_init(generator, cfg.mlp_cfg, device)}


def neural_image_rgb(params: dict, cfg: NeuralImageConfig,
                     coords: torch.Tensor, *, use_sga: bool = False,
                     temperature: float = 1.0,
                     sga_u: Optional[torch.Tensor] = None,
                     decoded: Optional[torch.Tensor] = None, affine=None,
                     static_plan=None,
                     lod_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """coords [N, 2] in [-1, 1] -> rgb [N, 3]; ``static_plan`` as in
    ``latent_grid.interpolate``."""
    feats = lg.interpolate(params['grid'], cfg.grid, coords, use_sga=use_sga,
                           temperature=temperature, sga_u=sga_u,
                           decoded=decoded, affine=affine,
                           static_plan=static_plan, lod_mask=lod_mask)
    if cfg.pos_embed_dim:
        if cfg.pos_embedder == 'positional':
            emb = positional_embed(PositionalEmbedderConfig(
                cfg.pos_multires, 2, include_input=cfg.position_input),
                coords)
        else:
            emb = coords
        feats = torch.cat([feats, emb], dim=-1)
    colors = mlp_apply(params['decoder_color'], cfg.mlp_cfg, feats)
    return get_activation(cfg.final_activation)(colors)


def non_grid_size_bits(params: dict) -> int:
    """Bits of the colour MLP as stored (the 'remainder' of the size)."""
    return mlp_size_bits(params['decoder_color'])
