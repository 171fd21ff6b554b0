"""NeuralRadianceField: 3D coords + view dirs -> RGB + density.

Port of the latent-grid part of ``shacira_tpu/models/nefs/nerf.py``: grid
features -> density MLP (16 outputs, output bias[0] initialized to 1.0,
density = relu(feats[..., 0])) -> colour MLP on [density feats, PE(-dir)]
-> sigmoid.  With ``amp`` the MLPs run in bf16 (cast per layer, as the JAX
package does) and return f32.  Pruning updates the dense occupancy grid.
The octree, codebook and triplanar backbones wait for ROADMAP Queue A
item 12; the paged prune for item 8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.profiler import record_function

from shacira_tpu_torch.accel import occupancy as occ
from shacira_tpu_torch.models.embedders import (
    PositionalEmbedderConfig, positional_embed)
from shacira_tpu_torch.models.grids import latent_grid as lg
from shacira_tpu_torch.models.mlp import MLPConfig, mlp_apply, mlp_init


@dataclass(frozen=True)
class NeuralRadianceFieldConfig:
    grid: lg.LatentGridConfig
    hidden_dim: int = 128
    num_layers: int = 1
    activation: str = 'relu'
    pos_embedder: str = 'none'
    view_embedder: str = 'none'       # 'none' | 'identity' | 'positional'
    pos_multires: int = 10
    view_multires: int = 4
    position_input: bool = False
    prune_density_decay: float = 0.6
    prune_min_density: float = 2.956
    blas_level: int = 7
    amp: bool = False

    def __post_init__(self):
        if not isinstance(self.grid, lg.LatentGridConfig):
            raise NotImplementedError(
                'only the LatentGrid backbone is ported; octree, codebook '
                'and triplanar grids are ROADMAP Queue A item 12')

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
    def view_embed_dim(self) -> int:
        if self.view_embedder == 'positional':
            return PositionalEmbedderConfig(self.view_multires, 3,
                                            include_input=True).output_dim
        if self.view_embedder in ('identity', 'none'):
            return 3
        return 0

    @property
    def density_mlp_cfg(self) -> MLPConfig:
        return MLPConfig(input_dim=self.grid.output_dim + self.pos_embed_dim,
                         output_dim=16, hidden_dim=self.hidden_dim,
                         num_layers=self.num_layers,
                         activation=self.activation)

    @property
    def color_mlp_cfg(self) -> MLPConfig:
        return MLPConfig(input_dim=16 + self.view_embed_dim, output_dim=3,
                         hidden_dim=self.hidden_dim,
                         num_layers=self.num_layers + 1,
                         activation=self.activation)

    @property
    def occ_cfg(self) -> occ.OccupancyGridConfig:
        return occ.OccupancyGridConfig(self.blas_level)


def nerf_init(generator: torch.Generator, cfg: NeuralRadianceFieldConfig,
              device) -> dict:
    """Grid, density MLP (first output bias = 1.0) and colour MLP."""
    grid = lg.latent_grid_init(generator, cfg.grid, device)
    density = mlp_init(generator, cfg.density_mlp_cfg, device)
    density['layers'][-1]['b'][0] = 1.0
    color = mlp_init(generator, cfg.color_mlp_cfg, device)
    return {'grid': grid, 'decoder_density': density, 'decoder_color': color}


def _pos_embed(cfg: NeuralRadianceFieldConfig, coords):
    if cfg.pos_embedder == 'positional':
        return positional_embed(PositionalEmbedderConfig(
            cfg.pos_multires, 3, include_input=cfg.position_input), coords)
    return coords


def nerf_feats(params: dict, cfg: NeuralRadianceFieldConfig,
               coords: torch.Tensor, *, use_sga: bool = False,
               temperature: float = 1.0, sga_u: Optional[torch.Tensor] = None,
               decoded: Optional[torch.Tensor] = None,
               affine=None) -> torch.Tensor:
    """Grid features (+ positional embedding) at coords."""
    feats = lg.interpolate(params['grid'], cfg.grid, coords, use_sga=use_sga,
                           temperature=temperature, sga_u=sga_u,
                           decoded=decoded, affine=affine)
    if cfg.pos_embed_dim:
        feats = torch.cat([feats, _pos_embed(cfg, coords)], dim=-1)
    return feats


def nerf_head(params: dict, cfg: NeuralRadianceFieldConfig,
              feats: torch.Tensor, ray_d: torch.Tensor):
    """MLP half of the field -> (rgb [..., 3], density [..., 1]), f32."""
    dt = torch.bfloat16 if cfg.amp else None
    density_feats = mlp_apply(params['decoder_density'], cfg.density_mlp_cfg,
                              feats, compute_dtype=dt)
    if cfg.view_embed_dim:
        if cfg.view_embedder == 'positional':
            vemb = positional_embed(PositionalEmbedderConfig(
                cfg.view_multires, 3, include_input=True), -ray_d)
        else:
            vemb = -ray_d
        if dt is not None:
            vemb = vemb.to(dt)
        fdir = torch.cat([density_feats, vemb], dim=-1)
    else:
        fdir = density_feats
    colors = torch.sigmoid(mlp_apply(params['decoder_color'],
                                     cfg.color_mlp_cfg, fdir,
                                     compute_dtype=dt))
    density = torch.relu(density_feats[..., 0:1])
    return colors.float(), density.float()


def nerf_rgba(params: dict, cfg: NeuralRadianceFieldConfig,
              coords: torch.Tensor, ray_d: torch.Tensor, **kw):
    """coords, ray_d [..., 3] -> (rgb [..., 3], density [..., 1]); the view
    embedder sees the negated direction."""
    with record_function('field/encode'):
        feats = nerf_feats(params, cfg, coords, **kw)
    with record_function('field/head'):
        return nerf_head(params, cfg, feats, ray_d)


def nerf_density(params: dict, cfg: NeuralRadianceFieldConfig,
                 coords: torch.Tensor, **kw) -> torch.Tensor:
    """Density only (used by pruning)."""
    _, density = nerf_rgba(params, cfg, coords, torch.zeros_like(coords), **kw)
    return density


@torch.no_grad()
def prune(params: dict, cfg: NeuralRadianceFieldConfig, occ_state: dict,
          u: torch.Tensor) -> dict:
    """One NGP pruning step: the field's eval-mode (rounded-latent) density
    at one jittered point per cell (``u``: [num_cells, 3] U(0,1)), max with
    the decayed tracked density, threshold."""
    pts = occ.cell_centers_jittered(cfg.occ_cfg, u)
    density = nerf_density(params, cfg, pts)[..., 0]
    return occ.prune_update(occ_state, cfg.occ_cfg, density,
                            density_decay=cfg.prune_density_decay,
                            min_density=cfg.prune_min_density)
