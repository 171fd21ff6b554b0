"""Positional embedding (NeRF-style): sin/cos at ``num_freq`` octaves with
optional raw-input concatenation.  Port of
``shacira_tpu/models/embedders.py``."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PositionalEmbedderConfig:
    num_freq: int
    input_dim: int
    max_freq_log2: int = None  # defaults to num_freq - 1
    log_sampling: bool = True
    include_input: bool = True

    @property
    def output_dim(self) -> int:
        out = 2 * self.num_freq * self.input_dim
        if self.include_input:
            out += self.input_dim
        return out


def positional_embed(cfg: PositionalEmbedderConfig,
                     coords: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., output_dim]: [input,] sin(x b_k), cos(x b_k)."""
    max_log2 = (cfg.max_freq_log2 if cfg.max_freq_log2 is not None
                else cfg.num_freq - 1)
    lin = torch.linspace(0.0, float(max_log2), cfg.num_freq,
                         device=coords.device)
    if cfg.log_sampling:
        bands = 2.0 ** lin
    else:
        bands = torch.linspace(1.0, 2.0 ** max_log2, cfg.num_freq,
                               device=coords.device)
    xb = coords[..., None, :] * bands[:, None].to(coords.dtype)   # [..., F, D]
    sin = torch.sin(xb).reshape(*coords.shape[:-1], -1)
    cos = torch.cos(xb).reshape(*coords.shape[:-1], -1)
    out = [sin, cos]
    if cfg.include_input:
        out = [coords] + out
    return torch.cat(out, dim=-1)
