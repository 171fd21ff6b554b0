"""LatentGrid -- SHACIRA's compressed multi-resolution latent hash grid.

Port of the single-decoder part of ``shacira_tpu/models/grids/latent_grid.py``
(flat and paged layouts): a concatenated multi-LOD latent table is
quantized (STE/SGA), decoded by a learned decoder into hash-grid features,
and a learned entropy model gives the rate loss.  On the paged layout the
block-local LODs are interpolated as raw latents on segment-grouped rows
(:func:`paged_zbar`, kernels B2/B3) and decoded after interpolation
(:func:`paged_finish`), which is exact for an affine decoder.  Size accounting
and the codestream wait for ROADMAP Queue A item 7 (later slice); the multi
and hierarchical decoders for item 10.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from shacira_tpu_torch.ops import paged_hash as ph
from shacira_tpu_torch.ops.hashgrid import (
    PAGE_RES, HashGridSpec, geometric_resolutions, hash_encode,
    hash_encode_affine)
from shacira_tpu_torch.models.latent_decoders import (
    LatentDecoderConfig, latent_decoder_init, latent_decoder_apply,
    latent_decoder_is_affine, latent_decoder_affine_parts)
from shacira_tpu_torch.models.prob_models import (
    BitEstimatorConfig, bit_estimator_init, entropy_bits)


@dataclass(frozen=True)
class LatentGridConfig:
    feature_dim: int
    resolutions: Tuple[int, ...]
    latent_dim: int = 0                   # 0 -> same as feature_dim
    multiscale_type: str = 'sum'          # 'sum' | 'cat'
    resolution_dim: int = 3
    feature_std: float = 0.0
    feature_bias: float = 0.0
    codebook_bitwidth: int = 8
    init_grid: str = 'normal'             # 'normal' | 'uniform'
    ldec: Optional[LatentDecoderConfig] = None
    ldecode_type: str = 'single'
    num_prob_layers: int = 4
    noise_freq: int = 1
    entropy_enabled: bool = False
    hash_layout: str = 'xor'              # 'xor' | 'paged'
    page_res: int = PAGE_RES              # paged layout: pages per axis

    def __post_init__(self):
        if self.ldecode_type != 'single':
            raise NotImplementedError(
                f'ldecode_type={self.ldecode_type!r}: multi/hierarchical '
                'decoders are ROADMAP Queue A item 10')
        if self.multiscale_type not in ('sum', 'cat'):
            raise NotImplementedError(self.multiscale_type)

    @property
    def effective_latent_dim(self) -> int:
        return self.feature_dim if self.latent_dim == 0 else self.latent_dim

    @property
    def spec(self) -> HashGridSpec:
        return HashGridSpec(self.resolutions, self.codebook_bitwidth,
                            self.resolution_dim, hash_layout=self.hash_layout,
                            page_res=self.page_res)

    @property
    def num_lods(self) -> int:
        return len(self.resolutions)

    @property
    def output_dim(self) -> int:
        if self.multiscale_type == 'cat':
            return self.feature_dim * self.num_lods
        return self.feature_dim

    @property
    def prob_cfg(self) -> BitEstimatorConfig:
        return BitEstimatorConfig(self.effective_latent_dim,
                                  self.num_prob_layers)

    @classmethod
    def from_geometric(cls, feature_dim, num_lods, min_grid_res, max_grid_res,
                       **kw):
        res = geometric_resolutions(min_grid_res, max_grid_res, num_lods)
        return cls(feature_dim=feature_dim, resolutions=res, **kw)

    def with_ldec(self, ldec_kwargs: dict) -> 'LatentGridConfig':
        ldec = LatentDecoderConfig(latent_dim=self.effective_latent_dim,
                                   feature_dim=self.feature_dim, **ldec_kwargs)
        return replace(self, ldec=ldec)


def latent_grid_init(generator: torch.Generator, cfg: LatentGridConfig,
                     device) -> dict:
    """Codebook ``[total_size, latent_dim]`` drawn normal(std) or
    uniform(+-std) around ``feature_bias``; decoder; entropy model."""
    shape = (cfg.spec.total_size, cfg.effective_latent_dim)
    if cfg.init_grid == 'uniform':
        cb = (torch.rand(shape, generator=generator, device=device) - 0.5) \
            * 2 * cfg.feature_std
    elif cfg.init_grid == 'normal':
        cb = torch.randn(shape, generator=generator, device=device) \
            * cfg.feature_std
    else:
        raise ValueError(cfg.init_grid)
    params = {'codebook': cb + cfg.feature_bias}
    if cfg.ldec is not None:
        params['latent_dec'] = latent_decoder_init(generator, cfg.ldec, device)
        if cfg.entropy_enabled:
            params['prob_model'] = bit_estimator_init(generator, cfg.prob_cfg,
                                                      device)
    return params


def supports_affine_fusion(cfg: LatentGridConfig) -> bool:
    """Single affine latent decoder: the fused latent-width backward."""
    return cfg.ldec is not None and latent_decoder_is_affine(cfg.ldec)


def affine_parts(params: dict, cfg: LatentGridConfig, *, use_sga: bool = False,
                 temperature: float = 1.0,
                 sga_u: Optional[torch.Tensor] = None):
    """(z, matrix, shift) for the fused encode."""
    return latent_decoder_affine_parts(
        params['latent_dec'], cfg.ldec, params['codebook'], use_sga=use_sga,
        temperature=temperature, sga_u=sga_u)


def decode_codebook(params: dict, cfg: LatentGridConfig, *,
                    use_sga: bool = False, temperature: float = 1.0,
                    sga_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize + decode the full latent table -> feature table [T, F]."""
    if cfg.ldec is None:
        return params['codebook']
    return latent_decoder_apply(params['latent_dec'], cfg.ldec,
                                params['codebook'], use_sga=use_sga,
                                temperature=temperature, sga_u=sga_u)


def interpolate(params: dict, cfg: LatentGridConfig, coords: torch.Tensor, *,
                use_sga: bool = False, temperature: float = 1.0,
                sga_u: Optional[torch.Tensor] = None,
                decoded: Optional[torch.Tensor] = None,
                affine=None) -> torch.Tensor:
    """Multiscale features at ``coords`` [..., dim] -> [..., output_dim].

    ``affine`` (z, matrix, shift) takes the fused encode; else ``decoded``
    (a pre-decoded feature table) or a fresh decode of the codebook."""
    lead = coords.shape[:-1]
    coords = coords.reshape(-1, coords.shape[-1])
    if affine is not None:
        z, matrix, shift = affine
        feats = hash_encode_affine(coords, z, matrix, shift, cfg.spec)
    else:
        if decoded is None:
            decoded = decode_codebook(params, cfg, use_sga=use_sga,
                                      temperature=temperature, sga_u=sga_u)
        feats = hash_encode(coords, decoded, cfg.spec)    # [N, L, F]
    if cfg.multiscale_type == 'cat':
        out = feats.reshape(feats.shape[0], -1)
    else:
        out = feats.sum(dim=1)
    return out.reshape(*lead, out.shape[-1])


def paged_zbar(cfg: LatentGridConfig, coords: torch.Tensor, grouping: dict,
               seg_size: int, *, affine) -> torch.Tensor:
    """Block-local latent interpolation on segment-ordered rows.

    ``coords`` [K * seg_size, 3] are the rows of K segments; ``grouping``
    (``ops/paged_hash.group_segments``) slots them into blocks sharing a
    grouping cell.  Every direct and paged LOD is interpolated in one pass
    of kernel B2 (backward B3) over the slot rows, and the result is
    permuted back.  Returns raw latents [K * seg_size, Lk, ld] in ascending
    LOD order."""
    z = affine[0]
    n2 = coords.shape[0]
    k2 = n2 // seg_size
    s2s = grouping['slotseg_to_seg']                       # [n_slotseg]
    n_slotseg = s2s.shape[0]
    rows = coords.reshape(k2, seg_size * 3)
    sv_seg = s2s < k2
    coords_s = torch.where(sv_seg[:, None],
                           rows[torch.clamp(s2s, max=k2 - 1)], 0.0)
    coords_s = coords_s.reshape(n_slotseg * seg_size, 3)
    slot_valid = sv_seg[:, None].expand(-1, seg_size).reshape(-1)
    static = ph.default_static(cfg.spec)
    zbar_s = ph.paged_interp_lods(coords_s, slot_valid,
                                  grouping['block_cell'], z, static)
    lk, ld = len(static.all_lods), z.shape[-1]
    zbar_rows = ph.permute_rows(
        zbar_s.reshape(n_slotseg, seg_size * lk * ld),
        grouping['seg_to_slotseg'], s2s)
    return zbar_rows.reshape(n2, lk, ld)


def paged_finish(cfg: LatentGridConfig, zbar: torch.Tensor,
                 coords: torch.Tensor, *, affine) -> torch.Tensor:
    """Decode the block-local latents into features on the (compacted) rows
    (``zbar @ matrix + shift``), plus the plain affine encode of any hashed
    LOD that cannot be paged (none in the lego spec).  Returns the
    multiscale features [N, output_dim]."""
    z, matrix, shift = affine
    spec = cfg.spec
    rest, direct, pag = ph.blocklocal_lods(spec)
    kernel_lods = direct + pag
    n = coords.shape[0]
    zbar = zbar.reshape(n, len(kernel_lods), z.shape[-1])
    feats = zbar @ matrix + shift                          # [N, Lk, F]
    if rest:
        feats_rest = hash_encode_affine(coords, z, matrix, shift, spec, rest)
        parts = dict(zip(rest, feats_rest.unbind(1)))
        parts.update(zip(kernel_lods, feats.unbind(1)))
        feats = torch.stack([parts[l] for l in range(spec.num_lods)], dim=1)
    if cfg.multiscale_type == 'cat':
        return feats.reshape(n, -1)
    return feats.sum(dim=1)


def ent_loss(params: dict, cfg: LatentGridConfig, noise: torch.Tensor, *,
             is_val: bool = False):
    """Rate loss: (bits per latent entry, total bits) of ``codebook +
    noise`` (``round(codebook)`` at validation); noise is U(-.5, .5)."""
    if 'prob_model' not in params:
        return 0.0, 0.0
    cb = params['codebook']
    weight = torch.round(cb) if is_val else cb + noise
    total = entropy_bits(params['prob_model'], cfg.prob_cfg, weight)
    return total / cb.shape[0], total
