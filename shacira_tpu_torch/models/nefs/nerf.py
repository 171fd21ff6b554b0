"""NeuralRadianceField: 3D coords + view dirs -> RGB + density.

Port of the latent-grid part of ``shacira_tpu/models/nefs/nerf.py``: grid
features -> density MLP (16 outputs, output bias[0] initialized to 1.0,
density = relu(feats[..., 0])) -> colour MLP on [density feats, PE(-dir)]
-> sigmoid.  With ``amp`` the MLPs run in bf16 (cast per layer, as the JAX
package does) and return f32.  Pruning updates the dense occupancy grid;
on the paged layout its density query runs through the block-local kernels
with a static grouping (:func:`_prune_density_paged`).  The paged encode
splits in two (:func:`nerf_zbar` on segment rows, :func:`nerf_finish_feats`
on the compacted rows).  The alternative backbones (:func:`grid_kind`:
NGLOD's octree grid, VQAD's codebook octree grid, the triplanar grid) take
the octree structure's tables (``structure``) and ``training`` (VQAD's
straight-through mix, or its argmax lookup in eval mode); they prune
through the plain density query.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from shacira_tpu_torch.accel import occupancy as occ
from shacira_tpu_torch.models.embedders import (
    PositionalEmbedderConfig, positional_embed)
from shacira_tpu_torch.models.grids import latent_grid as lg
from shacira_tpu_torch.models.grids import octree_grid as og
from shacira_tpu_torch.models.grids import triplanar_grid as tg
from shacira_tpu_torch.models.mlp import (
    MLPConfig, mlp_apply, mlp_init, mlp_size_bits)
from shacira_tpu_torch.ops import paged_hash as ph


GRID_CONFIGS = (lg.LatentGridConfig, og.OctreeGridConfig,
                tg.TriplanarGridConfig)


def grid_kind(grid_cfg) -> str:
    """Backbone family of a grid config: 'latent' (SHACIRA's LatentGrid or
    the uncompressed HashGrid), 'codebook' (VQAD), 'octree' (NGLOD) or
    'triplanar'."""
    if isinstance(grid_cfg, og.CodebookOctreeGridConfig):
        return 'codebook'
    if isinstance(grid_cfg, og.OctreeGridConfig):
        return 'octree'
    if isinstance(grid_cfg, tg.TriplanarGridConfig):
        return 'triplanar'
    return 'latent'


@dataclass(frozen=True)
class NeuralRadianceFieldConfig:
    # LatentGridConfig, OctreeGridConfig, CodebookOctreeGridConfig or
    # TriplanarGridConfig
    grid: object
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
        if not isinstance(self.grid, GRID_CONFIGS):
            raise TypeError(f'no grid backbone for {type(self.grid)}')

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
              device, structure=None) -> dict:
    """Grid, density MLP (first output bias = 1.0) and colour MLP;
    ``structure`` is the OctreeStructure of the octree and codebook
    backbones."""
    kind = grid_kind(cfg.grid)
    if kind == 'latent':
        grid = lg.latent_grid_init(generator, cfg.grid, device)
    elif kind == 'octree':
        grid = og.octree_grid_init(generator, cfg.grid, structure, device)
    elif kind == 'codebook':
        grid = og.codebook_grid_init(generator, cfg.grid, structure, device)
    else:
        grid = tg.triplanar_grid_init(generator, cfg.grid, device)
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
               affine=None, lod_mask: Optional[torch.Tensor] = None,
               structure=None, training: bool = True) -> torch.Tensor:
    """Grid features (``lod_mask`` applied) + positional embedding at
    coords; ``structure`` and ``training`` serve the alternative
    backbones, which take no ``lod_mask``."""
    kind = grid_kind(cfg.grid)
    if kind == 'octree':
        feats = og.interpolate(params['grid'], cfg.grid, structure, coords)
    elif kind == 'codebook':
        feats = og.codebook_interpolate(params['grid'], cfg.grid, structure,
                                        coords, training=training)
    elif kind == 'triplanar':
        feats = tg.interpolate(params['grid'], cfg.grid, coords)
    else:
        feats = lg.interpolate(params['grid'], cfg.grid, coords,
                               use_sga=use_sga, temperature=temperature,
                               sga_u=sga_u, decoded=decoded, affine=affine,
                               lod_mask=lod_mask)
    if cfg.pos_embed_dim:
        feats = torch.cat([feats, _pos_embed(cfg, coords)], dim=-1)
    return feats


def nerf_zbar(cfg: NeuralRadianceFieldConfig, coords: torch.Tensor,
              grouping: dict, seg_size: int, *, affine,
              occ=None) -> torch.Tensor:
    """Block-local LOD latents on segment-ordered rows (the paged encode's
    first stage, ``latent_grid.paged_zbar``): [N, Lk * ld]; with ``occ``
    the last ld columns are the fine occupancy row (split it off before
    decoding)."""
    zb = lg.paged_zbar(cfg.grid, coords, grouping, seg_size, affine=affine,
                       occ=occ)
    return zb.reshape(zb.shape[0], -1)


def nerf_finish_feats(cfg: NeuralRadianceFieldConfig, zbar: torch.Tensor,
                      coords: torch.Tensor, *, affine,
                      lod_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The paged encode's second stage on the compacted rows: decode the
    latents (``latent_grid.paged_finish``, ``lod_mask`` applied) and append
    the positional embedding."""
    feats = lg.paged_finish(cfg.grid, zbar, coords, affine=affine,
                            lod_mask=lod_mask)
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


@functools.lru_cache(maxsize=None)
def _prune_block_layout(res: int, g8: int = 8):
    """Static slot layout of the paged prune: occupancy cells enumerated in
    grouping-cell-major order (the ``res``-grid tiles the ``g8``^3 grouping
    cells exactly), so every kernel block lies in one grouping cell by
    construction.

    Returns (idx3 [N, 3] cell indices in grouped order, block_cell [nb],
    inv [N] with density_raster = density_grouped[inv])."""
    assert res % g8 == 0, res
    w = res // g8
    b = 1
    while b < 128 and w ** 3 % (2 * b) == 0:
        b *= 2                                  # block rows (128 at res 128)
    cells = np.arange(g8 ** 3)
    cx, cy, cz = cells // (g8 * g8), (cells // g8) % g8, cells % g8
    loc = np.arange(w ** 3)
    lx, ly, lz = loc // (w * w), (loc // w) % w, loc % w
    ix = (cx[:, None] * w + lx[None, :]).reshape(-1)
    iy = (cy[:, None] * w + ly[None, :]).reshape(-1)
    iz = (cz[:, None] * w + lz[None, :]).reshape(-1)
    idx3 = np.stack([ix, iy, iz], axis=-1).astype(np.int32)
    flat = (ix.astype(np.int64) * res + iy) * res + iz
    inv = np.empty(res ** 3, np.int64)
    inv[flat] = np.arange(res ** 3)
    block_cell = np.repeat(cells.astype(np.int32), w ** 3 // b)
    return idx3, block_cell, inv


@functools.lru_cache(maxsize=None)
def _prune_block_layout_on(res: int, g8: int, dev: torch.device):
    """:func:`_prune_block_layout` as tensors on ``dev``, copied once so
    that a prune makes no host-to-device copies."""
    return tuple(torch.as_tensor(a, device=dev)
                 for a in _prune_block_layout(res, g8))


def _prune_density_paged(params: dict, cfg: NeuralRadianceFieldConfig,
                         u: torch.Tensor) -> torch.Tensor:
    """Eval-mode density at one jittered point per occupancy cell through
    the block-local kernels.  ``u`` [res^3, 3] U(0,1) is in GROUPED cell
    order (``_prune_block_layout``); the result is in raster order."""
    res = cfg.occ_cfg.res
    gr = ph.group_res_of(cfg.grid.spec.page_res)
    dev = u.device
    idx3, block_cell, inv = _prune_block_layout_on(res, gr, dev)
    n = res ** 3
    pts = ((idx3 + u) / res) * 2.0 - 1.0
    parts = lg.affine_parts(params['grid'], cfg.grid)       # eval/round mode
    static = ph.default_static(cfg.grid.spec)
    zbar = ph.paged_interp_lods(
        pts, torch.ones((n,), dtype=torch.bool, device=dev),
        block_cell, parts[0], static)
    feats = lg.paged_finish(cfg.grid, zbar, pts, affine=parts)
    _, density = nerf_head(params, cfg, feats, torch.zeros_like(pts))
    return density[..., 0][inv]


def _can_prune_paged(cfg: NeuralRadianceFieldConfig) -> bool:
    if grid_kind(cfg.grid) != 'latent':
        return False
    res = cfg.occ_cfg.res
    gr = ph.group_res_of(cfg.grid.spec.page_res)
    return (cfg.grid.spec.hash_layout == 'paged'
            and lg.supports_affine_fusion(cfg.grid)
            and res % gr == 0 and res // gr >= 4)


@torch.no_grad()
def prune(params: dict, cfg: NeuralRadianceFieldConfig, occ_state: dict,
          u: torch.Tensor, structure=None) -> dict:
    """One NGP pruning step: the field's eval-mode (rounded-latent, or
    with ``structure`` the alternative backbone's eval-mode) density at one
    jittered point per cell (``u``: [num_cells, 3] U(0,1); raster cell
    order, or grouped order when the paged prune applies, see
    :func:`_can_prune_paged`), max with the decayed tracked density,
    threshold."""
    if _can_prune_paged(cfg):
        density = _prune_density_paged(params, cfg, u)
    else:
        pts = occ.cell_centers_jittered(cfg.occ_cfg, u)
        density = nerf_density(params, cfg, pts, structure=structure,
                               training=False)[..., 0]
    return occ.prune_update(occ_state, cfg.occ_cfg, density,
                            density_decay=cfg.prune_density_decay,
                            min_density=cfg.prune_min_density)


def non_grid_size_bits(params: dict) -> int:
    """Bits of the density and colour MLPs as stored."""
    return (mlp_size_bits(params['decoder_density'])
            + mlp_size_bits(params['decoder_color']))
