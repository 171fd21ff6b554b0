"""Learned entropy model (Balle-style univariate CDF) for rate estimation.

Port of ``shacira_tpu/models/prob_models.py``.  ``BitEstimator``: four
``Bitparm`` layers ``x * softplus(h) + b (+ tanh(x) * tanh(a))`` with a
final sigmoid; bits of ``w`` are ``-log2(CDF(w + .5) - CDF(w - .5))``.
``BitEstimatorN``: the width-N per-channel CDF model, grouped 1x1 layers
whose weights pass through sigmoid (mixing) and tanh (gates).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BitEstimatorConfig:
    channels: int
    num_layers: int = 4
    is_symmetric: bool = False
    is_unimodal: bool = False


def bit_estimator_init(generator: torch.Generator, cfg: BitEstimatorConfig,
                       device) -> dict:
    """Layers f1..f4 with parameters drawn from N(0, 0.01)."""
    def normal():
        return torch.randn((1, cfg.channels), generator=generator,
                           device=device) * 0.01

    params = {}
    for i in range(1, 5):
        layer = {'h': normal(),
                 'b': (torch.zeros((1, cfg.channels), device=device)
                       if cfg.is_symmetric else normal())}
        if i < 4:
            layer['a'] = normal()
        params[f'f{i}'] = layer
    return params


def _softplus(x):
    # log1p(exp(-|x|)) + max(x, 0): no linear cut-over, like jax.nn.softplus
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0)


def _bitparm_apply(layer, cfg: BitEstimatorConfig, x, final: bool,
                   single_channel=None):
    def sel(p):
        return p if single_channel is None else p[:, single_channel]

    h, b = sel(layer['h']), sel(layer['b'])
    if final:
        return torch.sigmoid(x * _softplus(h) + b)
    a = sel(layer['a'])
    if cfg.is_unimodal:
        a = torch.abs(a)
    x = x * _softplus(h) + b
    return x + torch.tanh(x) * torch.tanh(a)


def bit_estimator_apply(params: dict, cfg: BitEstimatorConfig,
                        x: torch.Tensor, single_channel=None) -> torch.Tensor:
    """CDF(x) for x [..., channels], or x [...] of the one channel
    ``single_channel``; ``num_layers`` gates f1..f3."""
    for i in range(1, 4):
        if cfg.num_layers > i:
            x = _bitparm_apply(params[f'f{i}'], cfg, x, final=False,
                               single_channel=single_channel)
    return _bitparm_apply(params['f4'], cfg, x, final=True,
                          single_channel=single_channel)


@dataclass(frozen=True)
class BitEstimatorNConfig:
    channels: int
    width: int = 4


def bit_estimator_n_init(generator: torch.Generator, cfg: BitEstimatorNConfig,
                         device) -> dict:
    """Layers f1..f4, every parameter drawn from N(0, 0.01) but f4's bias
    (zeros)."""
    c, w = cfg.channels, cfg.width

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device) * 0.01

    return {'f1': {'w': normal(c, w), 'b': normal(c, w), 'g': normal(c, w)},
            'f2': {'m': normal(c, w, w), 'b': normal(c, w),
                   'g': normal(c, w)},
            'f3': {'m': normal(c, w, w), 'b': normal(c, w),
                   'g': normal(c, w)},
            'f4': {'w': normal(c, w), 'b': torch.zeros((c,), device=device)}}


def bit_estimator_n_apply(params: dict, cfg: BitEstimatorNConfig,
                          x: torch.Tensor, single_channel=None
                          ) -> torch.Tensor:
    """CDF(x) for x [..., channels], or x [...] of the one channel
    ``single_channel``."""
    if single_channel is not None:
        k = single_channel
        params = {name: {p: v[k:k + 1] for p, v in layer.items()}
                  for name, layer in params.items()}
        x = x[..., None]
    f1 = params['f1']
    h = torch.sigmoid(f1['w']) * x[..., None] + f1['b']      # [..., C, W]
    h = h + torch.tanh(f1['g']) * torch.tanh(h)
    for name in ('f2', 'f3'):
        f = params[name]
        h = torch.einsum('...cw,cvw->...cv', h, torch.sigmoid(f['m'])) \
            + f['b']
        h = h + torch.tanh(f['g']) * torch.tanh(h)
    f4 = params['f4']
    out = torch.sigmoid(torch.sum(torch.sigmoid(f4['w']) * h, dim=-1)
                        + f4['b'])
    return out[..., 0] if single_channel is not None else out


def entropy_bits(params: dict, cfg: BitEstimatorConfig, weight: torch.Tensor,
                 clamp_max: float = 50.0) -> torch.Tensor:
    """Total estimated bits ``sum(clamp(-log2(p + 1e-10), 0, clamp_max))``
    with ``p = CDF(w + .5) - CDF(w - .5)``."""
    prob = (bit_estimator_apply(params, cfg, weight + 0.5)
            - bit_estimator_apply(params, cfg, weight - 0.5))
    bits = torch.clamp(-torch.log(prob + 1e-10) / torch.log(
        torch.full((), 2.0, device=weight.device)), 0.0, clamp_max)
    return torch.sum(bits)

