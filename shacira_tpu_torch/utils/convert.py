"""Carry parameters and Adam state over from the JAX package.

The JAX trees (``grid/{codebook, latent_dec/{layers[0]/{scale, shift}, div},
prob_model/...}``, ``decoder_density``, ``decoder_color``) arrive as nested
dicts and lists of numpy arrays (``jax.tree.map(np.asarray, tree)``).  The
port keeps the same layout, MLP weights included (``[din, dout]``, applied
as ``x @ w``), so the conversion only moves arrays into tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), device=device)


def params_from_jax(tree, device='cpu'):
    """Nested dict/list of arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _to_tensor(tree, device)


def adam_state_from_jax(mu, nu, count, device='cpu') -> dict:
    """The JAX ``AdamState(mu, nu, count)`` -> the port's Adam state."""
    return {'mu': params_from_jax(mu, device), 'nu': params_from_jax(nu, device),
            'count': int(np.asarray(count))}
