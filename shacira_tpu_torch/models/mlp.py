"""Basic MLP decode head.

Port of ``shacira_tpu/models/mlp.py``: ``num_layers`` hidden layers plus an
output layer, torch-default ``nn.Linear`` initialization.  Weights are kept
``[din, dout]`` as in the JAX tree (``x @ w + b``), so parameters carry
across without transposes.  ``compute_dtype`` casts the input, weights and
biases per layer explicitly (not through ``torch.autocast``), so bf16
rounding happens where the JAX package rounds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_ACTIVATIONS = {
    'none': lambda x: x,
    'identity': lambda x: x,
    'relu': torch.relu,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'lrelu': lambda x: F.leaky_relu(x, 0.01),
}


@dataclass(frozen=True)
class MLPConfig:
    input_dim: int
    output_dim: int
    hidden_dim: int = 128
    num_layers: int = 1            # hidden layers
    activation: str = 'relu'
    bias: bool = True
    skip: Tuple[int, ...] = ()
    layer_type: str = 'none'

    def __post_init__(self):
        if self.layer_type not in ('none', 'linear'):
            raise NotImplementedError(
                f'layer_type={self.layer_type!r}: normalized layers are '
                'ROADMAP Queue A item 10')
        if self.activation not in _ACTIVATIONS:
            raise NotImplementedError(f'activation {self.activation!r}')

    def layer_dims(self) -> Tuple[Tuple[int, int], ...]:
        dims = []
        for i in range(self.num_layers):
            if i == 0:
                dims.append((self.input_dim, self.hidden_dim))
            elif i in self.skip:
                dims.append((self.hidden_dim + self.input_dim, self.hidden_dim))
            else:
                dims.append((self.hidden_dim, self.hidden_dim))
        dims.append((self.hidden_dim, self.output_dim))
        return tuple(dims)


def mlp_init(generator: torch.Generator, cfg: MLPConfig, device) -> dict:
    """torch.nn.Linear default init: W, b ~ U(-k, k), k = 1/sqrt(din)."""
    layers = []
    for din, dout in cfg.layer_dims():
        bound = 1.0 / np.sqrt(din)

        def uniform(shape):
            u = torch.rand(shape, generator=generator, device=device)
            return u * (2 * bound) - bound

        layer = {'w': uniform((din, dout))}
        if cfg.bias:
            layer['b'] = uniform((dout,))
        layers.append(layer)
    return {'layers': layers}


def mlp_apply(params: dict, cfg: MLPConfig, x: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Forward pass; with ``compute_dtype`` every layer runs in that type
    and the caller casts the result back."""
    act = _ACTIVATIONS[cfg.activation]
    layers = params['layers']

    def cast(t):
        return t.to(compute_dtype) if compute_dtype is not None else t

    x = cast(x)
    h = x
    for i, layer in enumerate(layers[:-1]):
        if i in cfg.skip and i > 0:
            h = torch.cat([x, h], dim=-1)
        h = h @ cast(layer['w'])
        if 'b' in layer:
            h = h + cast(layer['b'])
        h = act(h)
    out = h @ cast(layers[-1]['w'])
    if 'b' in layers[-1]:
        out = out + cast(layers[-1]['b'])
    return out
