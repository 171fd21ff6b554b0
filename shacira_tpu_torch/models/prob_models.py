"""Learned entropy model (Balle-style univariate CDF) for rate estimation.

Port of ``BitEstimator`` in ``shacira_tpu/models/prob_models.py``: four
``Bitparm`` layers ``x * softplus(h) + b (+ tanh(x) * tanh(a))`` with a
final sigmoid; bits of ``w`` are ``-log2(CDF(w + .5) - CDF(w - .5))``.
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


def _bitparm_apply(layer, cfg: BitEstimatorConfig, x, final: bool):
    h, b = layer['h'], layer['b']
    if final:
        return torch.sigmoid(x * _softplus(h) + b)
    a = layer['a']
    if cfg.is_unimodal:
        a = torch.abs(a)
    x = x * _softplus(h) + b
    return x + torch.tanh(x) * torch.tanh(a)


def bit_estimator_apply(params: dict, cfg: BitEstimatorConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """CDF(x) for x [..., channels]; ``num_layers`` gates f1..f3."""
    for i in range(1, 4):
        if cfg.num_layers > i:
            x = _bitparm_apply(params[f'f{i}'], cfg, x, final=False)
    return _bitparm_apply(params['f4'], cfg, x, final=True)


def entropy_bits(params: dict, cfg: BitEstimatorConfig, weight: torch.Tensor,
                 clamp_max: float = 50.0) -> torch.Tensor:
    """Total estimated bits ``sum(clamp(-log2(p + 1e-10), 0, clamp_max))``
    with ``p = CDF(w + .5) - CDF(w - .5)``."""
    prob = (bit_estimator_apply(params, cfg, weight + 0.5)
            - bit_estimator_apply(params, cfg, weight - 0.5))
    bits = torch.clamp(-torch.log(prob + 1e-10) / torch.log(
        torch.full((), 2.0, device=weight.device)), 0.0, clamp_max)
    return torch.sum(bits)

