"""SHACIRA latent decoders: quantize latents, decode to features.

Port of ``shacira_tpu/models/latent_decoders.py``: the single decoder (with
the ``div`` recalibration), the identity decoder, the multi decoder (K
decoders mixed per table entry by a softmax over learned logits, hard
through ``ste_one_hot``) and the hierarchical one (a single decoder per LOD
slice).  Parameters are plain dicts of tensors with the JAX trees' layout
(``{'layers': [{'scale', 'shift'}], 'div'}``, plus ``'alpha'`` for multi,
``{'decoders': [...]}`` for hierarchical).  The SGA uniforms are an
argument, so tests can hand in the JAX-drawn array; the trainer draws them
from its ``torch.Generator``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from shacira_tpu_torch.ops import coding

EPSILON = 1e-6
# smallest positive normal f32: the lower bound of the SGA uniforms
SGA_UNIFORM_MIN = float(np.finfo(np.float32).tiny)


def get_dft_matrix(conv_dim: int, channels: int) -> np.ndarray:
    """DCT-II basis (reference get_dft_matrix)."""
    dft = np.zeros((conv_dim, channels), dtype=np.float32)
    for i in range(conv_dim):
        for j in range(channels):
            v = math.cos(math.pi / channels * (i + 0.5) * j) / math.sqrt(channels)
            dft[i, j] = v * (math.sqrt(2) if j > 0 else 1.0)
    return dft


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round (half to even) with identity gradient."""
    return x + (torch.round(x) - x).detach()


def ste_floor(x: torch.Tensor) -> torch.Tensor:
    """Floor with identity gradient."""
    return x + (torch.floor(x) - x).detach()


def sga_uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U(tiny, 1) draws for :func:`sga_quantize`."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(u, min=SGA_UNIFORM_MIN)


def sga_quantize(x: torch.Tensor, temperature: float, u: torch.Tensor,
                 diff_sampling: bool) -> torch.Tensor:
    """Stochastic Gumbel annealing quantization with pre-drawn uniforms
    ``u`` (shape of ``x``, in ``[tiny, 1)``).

    For two categories the relaxed softmax collapses to
    ``floor(x) + sigmoid(((l_c - l_f)/T + logistic(u))/T)``, as in the JAX
    package."""
    xf = torch.floor(x) if diff_sampling else ste_floor(x)
    dl = (torch.tanh(torch.clamp(x - xf, -1 + EPSILON, 1 - EPSILON))
          - torch.tanh(torch.clamp(xf + 1.0 - x, -1 + EPSILON, 1 - EPSILON)))
    dg = torch.log(u) - torch.log1p(-u)
    s1 = torch.sigmoid((dl / temperature + dg) / temperature)
    if not diff_sampling:
        s1 = s1.detach()
    return xf + s1


_ACTIVATIONS = {
    'none': lambda x: x,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'relu': torch.relu,
    'sine': lambda x: torch.sin(30.0 * x),
}


@dataclass(frozen=True)
class LatentDecoderConfig:
    latent_dim: int
    feature_dim: int
    norm: str = 'none'
    ldecode_matrix: str = 'sq'        # 'sq' | 'dft' | 'dft_fixed'
    use_shift: bool = True
    num_layers_dec: int = 0
    hidden_dim_dec: int = 0
    activation: str = 'none'
    final_activation: str = 'none'
    clamp_weights: float = 0.0
    ldec_std: float = 1.0
    use_sga: bool = False
    diff_sampling: bool = False

    def layer_dims(self) -> Tuple[Tuple[int, int], ...]:
        dims = []
        latent = self.latent_dim
        hidden = self.hidden_dim_dec if self.hidden_dim_dec else self.feature_dim
        for _ in range(self.num_layers_dec):
            out = hidden if hidden else latent
            dims.append((latent, out))
            latent = out
        dims.append((latent, self.feature_dim))
        return tuple(dims)


def latent_decoder_init(generator: torch.Generator, cfg: LatentDecoderConfig,
                        device) -> dict:
    """``scale`` ~ N(0, ldec_std), ``shift`` = 0, ``div`` = 1."""
    layers = []
    for din, dout in cfg.layer_dims():
        layer = {}
        if 'dft' in cfg.ldecode_matrix:
            layer['dft'] = torch.as_tensor(get_dft_matrix(din, dout),
                                           device=device)
            shape = (1, dout)
        else:
            shape = (din, dout)
        layer['scale'] = torch.randn(shape, generator=generator,
                                     device=device) * cfg.ldec_std
        if cfg.use_shift:
            layer['shift'] = torch.zeros((1, dout), device=device)
        layers.append(layer)
    return {'layers': layers, 'div': torch.ones((cfg.latent_dim,),
                                                device=device)}


def _quantize(weight, cfg, use_sga, temperature, sga_u):
    if use_sga:
        if sga_u is None:
            raise ValueError('SGA quantization needs its uniforms (sga_u)')
        return sga_quantize(weight, temperature, sga_u, cfg.diff_sampling)
    return ste_round(weight)


def latent_decoder_apply(params: dict, cfg: LatentDecoderConfig,
                         weight: torch.Tensor, *, use_sga: bool = False,
                         temperature: float = 1.0,
                         sga_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize + decode latents [T, latent_dim] -> [T, feature_dim]."""
    x = _quantize(weight, cfg, use_sga, temperature, sga_u) / params['div']
    act = _ACTIVATIONS[cfg.activation]
    n = len(params['layers'])
    for i, layer in enumerate(params['layers']):
        if 'dft' in cfg.ldecode_matrix:
            x = (x @ layer['dft']) * layer['scale']
        else:
            x = x @ layer['scale']
        if 'shift' in layer:
            x = x + layer['shift']
        if i < n - 1:
            x = act(x)
    x = _ACTIVATIONS[cfg.final_activation](x)
    if cfg.clamp_weights > 0.0:
        x = torch.clamp(x, -cfg.clamp_weights, cfg.clamp_weights)
    return x


def latent_decoder_is_affine(cfg: LatentDecoderConfig) -> bool:
    """True when decode is one affine map (quantize -> /div -> matmul +
    shift); such decoders fuse into ``hash_encode_affine``."""
    return (cfg.num_layers_dec == 0 and cfg.final_activation == 'none'
            and cfg.clamp_weights == 0.0)


def latent_decoder_affine_parts(params: dict, cfg: LatentDecoderConfig,
                                weight: torch.Tensor, *, use_sga: bool = False,
                                temperature: float = 1.0,
                                sga_u: Optional[torch.Tensor] = None):
    """(z, matrix, shift) with decode(weight) == z @ matrix + shift."""
    if not latent_decoder_is_affine(cfg):
        raise ValueError('decoder is not a single affine map')
    z = _quantize(weight, cfg, use_sga, temperature, sga_u) / params['div']
    layer = params['layers'][0]
    if 'dft' in cfg.ldecode_matrix:
        matrix = layer['dft'] * layer['scale']
    else:
        matrix = layer['scale']
    shift = layer.get('shift')
    if shift is None:
        shift = torch.zeros((1, matrix.shape[1]), dtype=matrix.dtype,
                            device=matrix.device)
    return z, matrix, shift


def tensor_bits(t: torch.Tensor) -> int:
    """Bits of a tensor in its stored dtype."""
    return t.nelement() * t.element_size() * 8


def latent_decoder_size_bits(params: dict) -> int:
    """Bits of every decoder parameter in its stored dtype, the fixed DFT
    basis and the frozen ``div`` vector included."""
    return (sum(tensor_bits(v) for layer in params['layers']
                for v in layer.values())
            + tensor_bits(params['div']))


def scale_norm(params: dict) -> torch.Tensor:
    """Frobenius norm of the single decode matrix (scales the grid lr)."""
    return torch.linalg.norm(params['layers'][0]['scale'])


def recalibrate_div(params: dict, latents: torch.Tensor, norm: str) -> dict:
    """``params`` with ``div`` recalibrated from the latents [T, ld]:
    'max' -> per channel max(|min|, |max|), 'std' -> per channel std
    (population), 'none' -> unchanged."""
    if norm == 'max':
        new_div = torch.maximum(torch.abs(latents.min(dim=0).values),
                                torch.abs(latents.max(dim=0).values))
    elif norm == 'std':
        new_div = latents.std(dim=0, correction=0)
    elif norm == 'none':
        return params
    else:
        raise ValueError(f'unknown norm {norm}')
    return {**params, 'div': new_div}


# ---------------------------------------------------------------------------
# Identity decoder: a table that is already decoded (decode-once inference).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DecoderIdentityConfig:
    latent_dim: int = 1


def decoder_identity_apply(params, cfg, weight, **_):
    return weight


# ---------------------------------------------------------------------------
# Multi decoder: K decoders and a per-entry soft or hard assignment.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MultiLatentDecoderConfig:
    latent_dim: int
    feature_dim: int
    num_entries: int
    num_decoders: int = 2
    norm: str = 'none'
    ldecode_matrix: str = 'sq'
    use_shift: bool = False
    num_layers_dec: int = 0
    hidden_dim_dec: int = 0
    activation: str = 'none'
    final_activation: str = 'none'
    clamp_weights: float = 0.0
    ldec_std: float = 1.0
    alpha_std: float = 1.0
    use_sga: bool = False
    diff_sampling: bool = False

    def layer_dims(self) -> Tuple[Tuple[int, int], ...]:
        return LatentDecoderConfig(
            self.latent_dim, self.feature_dim,
            num_layers_dec=self.num_layers_dec,
            hidden_dim_dec=self.hidden_dim_dec).layer_dims()


def multi_latent_decoder_init(generator: torch.Generator,
                              cfg: MultiLatentDecoderConfig, device) -> dict:
    """K decode matrices per layer [K, in, out] (``[K, 1, out]`` scales of
    the DFT basis), shifts [K, 1, out] and assignment logits ``alpha`` [K,
    num_entries] ~ N(0, alpha_std)."""
    layers = []
    k = cfg.num_decoders
    for din, dout in cfg.layer_dims():
        layer = {}
        if 'dft' in cfg.ldecode_matrix:
            layer['dft'] = torch.as_tensor(get_dft_matrix(din, dout),
                                           device=device)
            shape = (k, 1, dout)
        else:
            shape = (k, din, dout)
        layer['scale'] = torch.randn(shape, generator=generator,
                                     device=device) * cfg.ldec_std
        if cfg.use_shift:
            layer['shift'] = torch.zeros((k, 1, dout), device=device)
        layers.append(layer)
    alpha = torch.randn((k, cfg.num_entries), generator=generator,
                        device=device) * cfg.alpha_std
    return {'layers': layers, 'alpha': alpha,
            'div': torch.ones((cfg.latent_dim,), device=device)}


def ste_one_hot(alpha: torch.Tensor) -> torch.Tensor:
    """Hard one-hot [K, T] of the argmax over decoders, straight-through
    gradient."""
    hard = torch.nn.functional.one_hot(torch.argmax(alpha, dim=0),
                                       alpha.shape[0]).t().to(alpha.dtype)
    return alpha + (hard - alpha).detach()


def multi_latent_decoder_apply(params: dict, cfg: MultiLatentDecoderConfig,
                               weight: torch.Tensor, *, use_sga: bool = False,
                               temperature: float = 1.0,
                               straight_through: bool = True,
                               sga_u: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Quantize + decode with a mixture of K decoders: ``out_t = sum_k
    a_kt (x_t @ S_k) + sum_k a_kt shift_k``, ``a = softmax(alpha / T)``
    over decoders (hard one-hot with ``straight_through``)."""
    alpha = torch.softmax(params['alpha'] / temperature, dim=0)   # [K, T]
    if straight_through:
        alpha = ste_one_hot(alpha)
    x = _quantize(weight, cfg, use_sga, temperature, sga_u) / params['div']
    act = _ACTIVATIONS[cfg.activation]
    n = len(params['layers'])
    for i, layer in enumerate(params['layers']):
        if 'dft' in cfg.ldecode_matrix:
            base = x @ layer['dft']                                  # [T, F]
            mixed = torch.einsum('kt,kf->tf', alpha,
                                 layer['scale'][:, 0, :]) * base
        else:
            mixed = torch.einsum('tl,klf,kt->tf', x, layer['scale'], alpha)
        if 'shift' in layer:
            mixed = mixed + torch.einsum('kt,kf->tf', alpha,
                                         layer['shift'][:, 0, :])
        x = act(mixed) if i < n - 1 else mixed
    x = _ACTIVATIONS[cfg.final_activation](x)
    if cfg.clamp_weights > 0.0:
        x = torch.clamp(x, -cfg.clamp_weights, cfg.clamp_weights)
    return x


def multi_latent_decoder_size_bits(params: dict,
                                   use_codec: bool = False) -> float:
    """Bits of every parameter but ``alpha`` as stored, ``div`` at 32 bits
    an entry, plus the entropy-coded argmax assignments (a real
    arithmetic codestream with ``use_codec``, else the histogram
    estimate)."""
    fp = sum(tensor_bits(v) for layer in params['layers']
             for v in layer.values())
    fp += params['div'].nelement() * 32
    assign = torch.argmax(params['alpha'], dim=0).cpu().numpy()
    if use_codec:
        return fp + coding.coded_size_bits(assign)
    return fp + coding.entropy_bits_histogram(assign)


# ---------------------------------------------------------------------------
# Hierarchical decoder: an independent single decoder per LOD slice.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HierarchicalLatentDecoderConfig:
    num_decoders: int                      # = num_lods
    offsets: Tuple[int, ...]               # LOD slice boundaries, len L + 1
    decoder: LatentDecoderConfig


def hierarchical_latent_decoder_init(generator: torch.Generator,
                                     cfg: HierarchicalLatentDecoderConfig,
                                     device) -> dict:
    return {'decoders': [latent_decoder_init(generator, cfg.decoder, device)
                         for _ in range(cfg.num_decoders)]}


def hierarchical_latent_decoder_apply(params: dict,
                                      cfg: HierarchicalLatentDecoderConfig,
                                      weight: torch.Tensor, *,
                                      use_sga: bool = False,
                                      temperature: float = 1.0,
                                      sga_u: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """Decoder ``l`` on rows ``offsets[l]:offsets[l + 1]`` (and on the same
    rows of ``sga_u``)."""
    outs = []
    for l in range(cfg.num_decoders):
        sl = slice(cfg.offsets[l], cfg.offsets[l + 1])
        outs.append(latent_decoder_apply(
            params['decoders'][l], cfg.decoder, weight[sl], use_sga=use_sga,
            temperature=temperature,
            sga_u=None if sga_u is None else sga_u[sl]))
    return torch.cat(outs, dim=0)


def hierarchical_latent_decoder_size_bits(params: dict) -> int:
    return sum(latent_decoder_size_bits(d) for d in params['decoders'])
