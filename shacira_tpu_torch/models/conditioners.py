"""FiLM conditioners: feature-wise linear modulation.

Port of ``shacira_tpu/models/conditioners.py`` on the port's MLP: a
conditioning code ``cond`` yields a per-feature scale and shift of the
decoder's activations.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from shacira_tpu_torch.models.mlp import MLPConfig, mlp_apply, mlp_init


@dataclass(frozen=True)
class FiLMConfig:
    cond_dim: int
    feature_dim: int
    hidden_dim: int = 64

    @property
    def mlp_cfg(self) -> MLPConfig:
        return MLPConfig(self.cond_dim, 2 * self.feature_dim,
                         hidden_dim=self.hidden_dim, num_layers=1)


def film_init(generator: torch.Generator, cfg: FiLMConfig, device) -> dict:
    return {'mlp': mlp_init(generator, cfg.mlp_cfg, device)}


def film_apply(params: dict, cfg: FiLMConfig, features: torch.Tensor,
               cond: torch.Tensor) -> torch.Tensor:
    """features [..., F] modulated by cond [..., C]:
    ``features * (1 + gamma) + beta``."""
    gamma, beta = torch.chunk(mlp_apply(params['mlp'], cfg.mlp_cfg, cond), 2,
                              dim=-1)
    return features * (1.0 + gamma) + beta
