"""LatentGrid -- SHACIRA's compressed multi-resolution latent hash grid.

Port of the single-decoder part of ``shacira_tpu/models/grids/latent_grid.py``
(flat and paged layouts): a concatenated multi-LOD latent table is
quantized (STE/SGA), decoded by a learned decoder into hash-grid features,
and a learned entropy model gives the rate loss.  On the paged layout the
block-local LODs are interpolated as raw latents on segment-grouped rows
(:func:`paged_zbar`, kernels B2/B3) and decoded after interpolation
(:func:`paged_finish`), which is exact for an affine decoder.  The size
accounting (:func:`grid_size_bits`) and the latent codestream
(:func:`encode_grid_stream`) run on the host through ``ops/coding.py``.
The multi and hierarchical decoders decode the whole codebook
(:func:`decode_codebook`) and interpolate it through ``hash_encode``; only
the single affine decoder takes the fused latent-width encode.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from shacira_tpu_torch.ops import coding
from shacira_tpu_torch.ops import paged_hash as ph
from shacira_tpu_torch.ops.hashgrid import (
    PAGE_RES, HashGridSpec, geometric_resolutions, hash_encode,
    hash_encode_affine, octree_resolutions, static_hash_encode)
from shacira_tpu_torch.models.latent_decoders import (
    HierarchicalLatentDecoderConfig, LatentDecoderConfig,
    MultiLatentDecoderConfig, hierarchical_latent_decoder_apply,
    hierarchical_latent_decoder_init, hierarchical_latent_decoder_size_bits,
    latent_decoder_affine_parts, latent_decoder_apply, latent_decoder_init,
    latent_decoder_is_affine, latent_decoder_size_bits,
    multi_latent_decoder_apply, multi_latent_decoder_init,
    multi_latent_decoder_size_bits, tensor_bits)
from shacira_tpu_torch.models.prob_models import (
    BitEstimatorConfig, bit_estimator_apply, bit_estimator_init,
    entropy_bits)


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
    ldecode_type: str = 'single'          # 'single' | 'multi' | 'hierarchical'
    num_decoders: int = 2                 # for 'multi'
    alpha_std: float = 1.0                # for 'multi'
    num_prob_layers: int = 4
    noise_freq: int = 1
    entropy_enabled: bool = False
    hash_layout: str = 'xor'              # 'xor' | 'paged'
    page_res: int = PAGE_RES              # paged layout: pages per axis

    def __post_init__(self):
        if self.ldecode_type not in ('single', 'multi', 'hierarchical'):
            raise ValueError(f'ldecode_type={self.ldecode_type!r}')
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

    @classmethod
    def from_octree(cls, feature_dim, base_lod, num_lods, **kw):
        return cls(feature_dim=feature_dim,
                   resolutions=octree_resolutions(base_lod, num_lods), **kw)

    def with_ldec(self, ldec_kwargs: dict, ldecode_type: str = 'single',
                  **type_kwargs) -> 'LatentGridConfig':
        ldec = LatentDecoderConfig(latent_dim=self.effective_latent_dim,
                                   feature_dim=self.feature_dim, **ldec_kwargs)
        return replace(self, ldec=ldec, ldecode_type=ldecode_type,
                       **type_kwargs)

    @property
    def multi_cfg(self) -> MultiLatentDecoderConfig:
        d = self.ldec
        return MultiLatentDecoderConfig(
            latent_dim=d.latent_dim, feature_dim=d.feature_dim,
            num_entries=self.spec.total_size, num_decoders=self.num_decoders,
            norm=d.norm, ldecode_matrix=d.ldecode_matrix, use_shift=d.use_shift,
            num_layers_dec=d.num_layers_dec, hidden_dim_dec=d.hidden_dim_dec,
            activation=d.activation, final_activation=d.final_activation,
            clamp_weights=d.clamp_weights, ldec_std=d.ldec_std,
            alpha_std=self.alpha_std, use_sga=d.use_sga,
            diff_sampling=d.diff_sampling)

    @property
    def hier_cfg(self) -> HierarchicalLatentDecoderConfig:
        spec = self.spec
        offsets = tuple(spec.lod_first_idx) + (spec.total_size,)
        return HierarchicalLatentDecoderConfig(
            num_decoders=spec.num_lods, offsets=offsets, decoder=self.ldec)


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
        if cfg.ldecode_type == 'multi':
            params['latent_dec'] = multi_latent_decoder_init(
                generator, cfg.multi_cfg, device)
        elif cfg.ldecode_type == 'hierarchical':
            params['latent_dec'] = hierarchical_latent_decoder_init(
                generator, cfg.hier_cfg, device)
        else:
            params['latent_dec'] = latent_decoder_init(generator, cfg.ldec,
                                                       device)
        if cfg.entropy_enabled:
            params['prob_model'] = bit_estimator_init(generator, cfg.prob_cfg,
                                                      device)
    return params


def supports_affine_fusion(cfg: LatentGridConfig) -> bool:
    """Single affine latent decoder: the fused latent-width backward."""
    return (cfg.ldec is not None and cfg.ldecode_type == 'single'
            and latent_decoder_is_affine(cfg.ldec))


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
    """Quantize + decode the full latent table -> feature table [T, F].
    The multi decoder mixes softly while SGA is on and hard (straight
    through) otherwise; the hierarchical one decodes LOD by LOD."""
    if cfg.ldec is None:
        return params['codebook']
    if cfg.ldecode_type == 'multi':
        return multi_latent_decoder_apply(
            params['latent_dec'], cfg.multi_cfg, params['codebook'],
            use_sga=use_sga, temperature=temperature,
            straight_through=not use_sga, sga_u=sga_u)
    if cfg.ldecode_type == 'hierarchical':
        return hierarchical_latent_decoder_apply(
            params['latent_dec'], cfg.hier_cfg, params['codebook'],
            use_sga=use_sga, temperature=temperature, sga_u=sga_u)
    return latent_decoder_apply(params['latent_dec'], cfg.ldec,
                                params['codebook'], use_sga=use_sga,
                                temperature=temperature, sga_u=sga_u)


def interpolate(params: dict, cfg: LatentGridConfig, coords: torch.Tensor, *,
                use_sga: bool = False, temperature: float = 1.0,
                sga_u: Optional[torch.Tensor] = None,
                decoded: Optional[torch.Tensor] = None,
                affine=None, static_plan=None,
                lod_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multiscale features at ``coords`` [..., dim] -> [..., output_dim].

    ``affine`` (z, matrix, shift) takes the fused encode; else ``decoded``
    (a pre-decoded feature table) or a fresh decode of the codebook,
    interpolated at ``coords`` or, with ``static_plan`` ((meta, arrays) of
    ``hashgrid.build_static_plan`` for these coords), through the plan.
    ``lod_mask`` [num_lods] 0/1 scales each LOD's features."""
    lead = coords.shape[:-1]
    coords = coords.reshape(-1, coords.shape[-1])
    if affine is not None:
        z, matrix, shift = affine
        feats = hash_encode_affine(coords, z, matrix, shift, cfg.spec)
    else:
        if decoded is None:
            decoded = decode_codebook(params, cfg, use_sga=use_sga,
                                      temperature=temperature, sga_u=sga_u)
        if static_plan is not None:
            meta, arrays = static_plan
            feats = static_hash_encode(arrays, decoded, meta)
        else:
            feats = hash_encode(coords, decoded, cfg.spec)    # [N, L, F]
    feats = _mask_lods(feats, lod_mask)
    if cfg.multiscale_type == 'cat':
        out = feats.reshape(feats.shape[0], -1)
    else:
        out = feats.sum(dim=1)
    return out.reshape(*lead, out.shape[-1])


def _mask_lods(feats: torch.Tensor,
               lod_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[N, L, F] features with LOD ``l`` scaled by ``lod_mask[l]``."""
    return feats if lod_mask is None else feats * lod_mask[None, :, None]


def paged_zbar(cfg: LatentGridConfig, coords: torch.Tensor, grouping: dict,
               seg_size: int, *, affine, occ=None) -> torch.Tensor:
    """Block-local latent interpolation on segment-ordered rows.

    ``coords`` [K * seg_size, 3] are the rows of K segments; ``grouping``
    (``ops/paged_hash.group_segments``) slots them into blocks sharing a
    grouping cell.  Every direct and paged LOD is interpolated in one pass
    of kernel B2 (backward B3) over the slot rows, and the result is
    permuted back.  Returns raw latents [K * seg_size, Lk, ld] in ascending
    LOD order; with ``occ`` (``ops/paged_hash.pack_occupancy`` of the
    occupancy grid) one more row, the per-sample fine occupancy in {0, 1}
    (fine_mode='kernel')."""
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
    static = ph.default_static(cfg.spec,
                               occ.shape[0] if occ is not None else 0)
    zbar_s = ph.paged_interp_lods(coords_s, slot_valid,
                                  grouping['block_cell'], z, static, occ)
    lk = len(static.all_lods) + (1 if static.occ_res else 0)
    ld = z.shape[-1]
    zbar_rows = ph.permute_rows(
        zbar_s.reshape(n_slotseg, seg_size * lk * ld),
        grouping['seg_to_slotseg'], s2s)
    return zbar_rows.reshape(n2, lk, ld)


def paged_finish(cfg: LatentGridConfig, zbar: torch.Tensor,
                 coords: torch.Tensor, *, affine,
                 lod_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode the block-local latents into features on the (compacted) rows
    (``zbar @ matrix + shift``), plus the plain affine encode of any hashed
    LOD that cannot be paged (none in the lego spec), ``lod_mask`` applied.
    Returns the multiscale features [N, output_dim]."""
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
    feats = _mask_lods(feats, lod_mask)
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


# ---------------------------------------------------------------------------
# Size accounting and the latent codestream (host side).  Pass a grid whose
# codebook already lies on the host (``MultiviewTrainer.size_report`` copies
# it there once per report): each function below reads it as numpy.
# ---------------------------------------------------------------------------

def _host(t) -> np.ndarray:
    """numpy view of a CPU tensor (a copy of a CUDA one)."""
    return t.detach().cpu().numpy()


def _rounded_channel(cb: np.ndarray, c: int) -> np.ndarray:
    return np.round(cb[:, c]).astype(np.int64)


def stream_side_info_bits(params: dict) -> int:
    """Bits of side information a histogram-coded latent stream needs to
    be decodable: per latent channel the symbol count (32), the alphabet
    size (16), the alphabet values (int16 each) and a 16-bit quantized CDF
    entry per symbol."""
    cb = _host(params['codebook'])
    bits = 0
    for c in range(cb.shape[1]):
        w = _rounded_channel(cb, c)
        if np.abs(w).max(initial=0) >= 2 ** 15:
            raise ValueError(f'latent magnitude {np.abs(w).max()} overflows '
                             'the int16 alphabet encoding of the side info')
        a = int(np.unique(w).shape[0])
        bits += 32 + 16 + a * 16 + a * 16
    return bits


def prob_model_size_bits(params: dict) -> int:
    """f32 bits of the BitEstimator parameters: the side information of
    the prob-model-coded stream (its decoder evaluates the model CDF)."""
    if 'prob_model' not in params:
        return 0
    return sum(t.nelement() for layer in params['prob_model'].values()
               for t in layer.values()) * 32


def _model_probs(params: dict, cfg: LatentGridConfig, uniq: np.ndarray,
                 c: int) -> np.ndarray:
    """Prob-model mass ``CDF(u + .5) - CDF(u - .5)`` of the integer symbols
    ``uniq`` of latent channel ``c`` (f32, on the model's device)."""
    pm = params['prob_model']
    dev = pm['f4']['h'].device

    def cdf(x):
        return bit_estimator_apply(
            pm, cfg.prob_cfg, torch.as_tensor(x.astype(np.float32),
                                              device=dev), single_channel=c)

    with torch.no_grad():
        return _host(cdf(uniq + 0.5) - cdf(uniq - 0.5))


def decoder_size_bits(params: dict, cfg: LatentGridConfig,
                      use_codec: bool = False) -> float:
    """Bits of the latent decoder: its parameters as stored, and for the
    multi decoder its coded per-entry assignments."""
    if cfg.ldecode_type == 'multi':
        return multi_latent_decoder_size_bits(params['latent_dec'],
                                              use_codec=use_codec)
    if cfg.ldecode_type == 'hierarchical':
        return hierarchical_latent_decoder_size_bits(params['latent_dec'])
    return latent_decoder_size_bits(params['latent_dec'])


def grid_size_bits(params: dict, cfg: LatentGridConfig, *,
                   use_codec: bool = False, use_prob_model: bool = False,
                   count_side_info: bool = False):
    """(decoder_bits, latent_bits) of the compressed grid.

    Per latent channel, the bits of the rounded codebook: the histogram
    entropy estimate, or with ``use_codec`` the length of a real arithmetic
    codestream; with ``use_prob_model`` under the BitEstimator's CDF
    instead of the histogram.  ``count_side_info`` adds what the stream
    needs to be decodable: the alphabet and quantized CDF per channel
    (:func:`stream_side_info_bits`), or the prob model's parameters
    (:func:`prob_model_size_bits`)."""
    if cfg.ldec is None:
        # an uncompressed hash grid: the raw table
        return 0, tensor_bits(params['codebook'])
    ldec_bits = decoder_size_bits(params, cfg, use_codec)
    cb = _host(params['codebook'])
    codebook_bits = 0.0
    for c in range(cb.shape[1]):
        w = _rounded_channel(cb, c)
        if use_prob_model:
            uniq, counts = np.unique(w, return_counts=True)
            probs = _model_probs(params, cfg, uniq, c)
            if use_codec:
                codebook_bits += coding.coded_size_bits(w, probs=probs)
            else:
                info = np.clip(-np.log(probs + 1e-10) / np.log(2.0), 0, 1000)
                codebook_bits += float(np.sum(info * counts))
        elif use_codec:
            codebook_bits += coding.coded_size_bits(w)
        else:
            codebook_bits += coding.entropy_bits_histogram(w)
    if count_side_info:
        codebook_bits += (prob_model_size_bits(params) if use_prob_model
                          else stream_side_info_bits(params))
    return ldec_bits, codebook_bits


def encode_grid_stream(params: dict, cfg: LatentGridConfig, *,
                       use_prob_model: bool = False) -> dict:
    """The rounded latent codebook as arithmetic codestreams, one per
    channel: symbols ``round(cb[:, c])`` over their dense alphabet, coded
    with the histogram CDF (or the BitEstimator's with
    ``use_prob_model``), with what :func:`decode_grid_stream` needs."""
    cb = _host(params['codebook'])
    channels = []
    for c in range(cb.shape[1]):
        w = _rounded_channel(cb, c)
        uniq, inv = np.unique(w, return_inverse=True)
        if use_prob_model:
            probs = np.maximum(_model_probs(params, cfg, uniq, c), 1e-10)
            probs = probs / probs.sum()
        else:
            counts = np.bincount(inv)
            probs = counts / counts.sum()
        stream = coding.ArithmeticCoder.encode(inv, probs)
        channels.append({'stream': stream, 'alphabet': uniq, 'probs': probs,
                         'n': int(w.shape[0])})
    return {'channels': channels, 'latent_dim': cb.shape[1]}


def decode_grid_stream(blob: dict) -> np.ndarray:
    """Inverse of :func:`encode_grid_stream`: ``round(codebook)`` [T, ld]."""
    cols = []
    for ch in blob['channels']:
        inv = coding.ArithmeticCoder.decode(ch['stream'], ch['probs'],
                                            ch['n'])
        cols.append(ch['alphabet'][inv])
    return np.stack(cols, axis=1).astype(np.float32)


def rounding_loss(params: dict) -> torch.Tensor:
    """mean |w - round(w)| of the codebook (a diagnostic)."""
    cb = params['codebook']
    return torch.mean(torch.abs(cb - torch.round(cb)))
