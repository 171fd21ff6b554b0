"""Differential operators for implicit fields: the gradient of a scalar
field ``f(coords [N, 3]) -> [N, 1]`` by autodiff, central differences or
the 4-tap tetrahedron stencil.  Port of ``shacira_tpu/ops/differential.py``
(used for SDF normals)."""
from __future__ import annotations

import torch


def autodiff_gradient(f, coords: torch.Tensor) -> torch.Tensor:
    """d f / d coords [N, 3] through autograd, for a pointwise ``f`` (each
    output row depends on its own input row only).  Where nothing of ``f``
    depends on the coordinates the gradient is zero, as JAX's is."""
    with torch.enable_grad():
        x = coords.detach().requires_grad_(True)
        out = f(x)
        g = None
        if out.requires_grad:
            (g,) = torch.autograd.grad(out[..., 0].sum(), x,
                                       allow_unused=True)
    return torch.zeros_like(coords) if g is None else g


def finitediff_gradient(f, coords: torch.Tensor,
                        eps: float = 5e-4) -> torch.Tensor:
    """Central differences along the axes (6 evaluations)."""
    offs = torch.eye(3, device=coords.device) * eps
    return torch.cat([(f(coords + offs[i]) - f(coords - offs[i])) / (2 * eps)
                      for i in range(3)], dim=-1)


def tetrahedron_gradient(f, coords: torch.Tensor,
                         eps: float = 5e-4) -> torch.Tensor:
    """The tetrahedron stencil (4 evaluations instead of 6)."""
    k = torch.tensor([[1.0, -1.0, -1.0], [-1.0, -1.0, 1.0],
                      [-1.0, 1.0, -1.0], [1.0, 1.0, 1.0]],
                     device=coords.device)
    g = 0.0
    for i in range(4):
        g = g + k[i] * f(coords + k[i] * eps)
    return g / (4.0 * eps)
