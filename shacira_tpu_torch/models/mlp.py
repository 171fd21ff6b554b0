"""Basic MLP decode head.

Port of ``shacira_tpu/models/mlp.py``: ``num_layers`` hidden layers plus an
output layer, torch-default ``nn.Linear`` initialization, optionally
followed by a weight-init transform ('orthonormal', 'svd', 'spectral',
'identity'), and weight-normalized layer types (Frobenius, L1, L-inf,
spectral by 8 power iterations) applied in the forward pass.  Weights are
kept ``[din, dout]`` as in the JAX tree (``x @ w + b``), so parameters
carry across without transposes.  ``compute_dtype`` casts the input,
weights and biases per layer explicitly (not through ``torch.autocast``),
so bf16 rounding happens where the JAX package rounds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from shacira_tpu_torch.models.latent_decoders import tensor_bits

def full_sort(x: torch.Tensor) -> torch.Tensor:
    """'fullsort': sorts the feature dimension."""
    return torch.sort(x, dim=-1).values


def min_max(x: torch.Tensor) -> torch.Tensor:
    """'minmax': sorts each pair of features (an even feature count)."""
    shape = x.shape
    x2 = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    lo = torch.amin(x2, dim=-1, keepdim=True)
    hi = torch.amax(x2, dim=-1, keepdim=True)
    return torch.cat([lo, hi], dim=-1).reshape(shape)


_ACTIVATIONS = {
    'none': lambda x: x,
    'identity': lambda x: x,
    'relu': torch.relu,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'sin': torch.sin,
    'sine': lambda x: torch.sin(30.0 * x),
    'sinescaled': lambda x: torch.sin(30.0 * x),
    'fullsort': full_sort,
    'minmax': min_max,
    'lrelu': lambda x: F.leaky_relu(x, 0.01),
    'softplus': F.softplus,
}


def get_activation(name: str):
    return _ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# Normalized linear layers: the weight is normalized in the forward pass.
# ---------------------------------------------------------------------------

def normalize_frobenius(w: torch.Tensor) -> torch.Tensor:
    return w / torch.sqrt(torch.sum(torch.abs(w) ** 2))


def normalize_l1(w: torch.Tensor) -> torch.Tensor:
    """Columns scaled so their absolute sums are <= 1."""
    scale = torch.clamp(1.0 / torch.sum(torch.abs(w), dim=0), max=1.0)
    return w * scale[None, :]


def normalize_linf(w: torch.Tensor) -> torch.Tensor:
    """Rows scaled so their absolute sums are <= 1."""
    scale = torch.clamp(1.0 / torch.sum(torch.abs(w), dim=1), max=1.0)
    return w * scale[:, None]


def spectral_normalize(w: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """``w`` over its largest singular value, estimated by ``iters`` power
    iterations from the normalized all-ones vector."""
    v = torch.full((w.shape[1],), 1.0 / np.sqrt(w.shape[1]),
                   dtype=w.dtype, device=w.device)
    for _ in range(iters):
        u = w @ v
        u = u / (torch.linalg.norm(u) + 1e-12)
        v = w.t() @ u
        v = v / (torch.linalg.norm(v) + 1e-12)
    sigma = u @ w @ v
    return w / (sigma + 1e-12)


_LAYER_NORMALIZERS = {
    'none': None,
    'linear': None,
    'frobenius_norm': normalize_frobenius,
    'l_1_norm': normalize_l1,
    'l_inf_norm': normalize_linf,
    'spectral_norm': spectral_normalize,
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
    layer_type: str = 'none'       # 'none' | 'frobenius_norm' | ...

    def __post_init__(self):
        if self.layer_type not in _LAYER_NORMALIZERS:
            raise ValueError(f'layer_type={self.layer_type!r}')
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f'activation {self.activation!r}')

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


def mlp_init(generator: torch.Generator, cfg: MLPConfig, device,
             weight_init: str = 'none') -> dict:
    """torch.nn.Linear default init: W, b ~ U(-k, k), k = 1/sqrt(din);
    then ``weight_init`` ('none' or a key of :data:`WEIGHT_INITS`)
    transforms each weight."""
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
    if weight_init != 'none':
        fn = WEIGHT_INITS[weight_init]
        for layer in layers:
            layer['w'] = fn(generator, layer['w'])
    return {'layers': layers}


def init_orthonormal(generator: torch.Generator, w: torch.Tensor):
    """A random orthonormal matrix of w's shape (Haar: QR of a Gaussian,
    columns sign-corrected by diag(R))."""
    n = max(w.shape)
    a = torch.randn((n, n), generator=generator, device=w.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q[:w.shape[0], :w.shape[1]].to(w.dtype)


def init_svd(generator: torch.Generator, w: torch.Tensor):
    """U @ V^T of w's SVD: the nearest orthogonal matrix."""
    u, _, vt = torch.linalg.svd(w, full_matrices=False)
    return (u @ vt).to(w.dtype)


def init_spectral(generator: torch.Generator, w: torch.Tensor):
    """w over its largest singular value."""
    return (w / torch.linalg.svdvals(w).max()).to(w.dtype)


def init_identity(generator: torch.Generator, w: torch.Tensor):
    """The identity, zero-padded when rectangular."""
    return torch.eye(w.shape[0], w.shape[1], dtype=w.dtype, device=w.device)


WEIGHT_INITS = {
    'orthonormal': init_orthonormal,
    'svd': init_svd,
    'spectral': init_spectral,
    'identity': init_identity,
}


def mlp_apply(params: dict, cfg: MLPConfig, x: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Forward pass; with ``compute_dtype`` every layer runs in that type
    and the caller casts the result back."""
    act = _ACTIVATIONS[cfg.activation]
    normalizer = _LAYER_NORMALIZERS[cfg.layer_type]
    layers = params['layers']

    def cast(t):
        return t.to(compute_dtype) if compute_dtype is not None else t

    def weight(layer):
        w = layer['w']
        return cast(normalizer(w) if normalizer is not None else w)

    x = cast(x)
    h = x
    for i, layer in enumerate(layers[:-1]):
        if i in cfg.skip and i > 0:
            h = torch.cat([x, h], dim=-1)
        h = h @ weight(layer)
        if 'b' in layer:
            h = h + cast(layer['b'])
        h = act(h)
    out = h @ weight(layers[-1])
    if 'b' in layers[-1]:
        out = out + cast(layers[-1]['b'])
    return out


def mlp_size_bits(params: dict) -> int:
    """Bits of the weights and biases in their stored dtype (f32: the
    ``compute_dtype`` cast happens at apply time and is not stored)."""
    return sum(tensor_bits(v) for layer in params['layers']
               for v in layer.values())
