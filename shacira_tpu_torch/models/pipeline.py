"""Pipeline -- a neural field paired with an optional tracer -- and
decode-once inference.

Port of ``shacira_tpu/models/pipeline.py``.  Inference decodes the latent
codebook once (rounded latents) and hands the feature table to the field
functions through their ``decoded=`` argument, so repeated queries skip
quantize and decode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from shacira_tpu_torch.models.grids import latent_grid as lg


@dataclass
class Pipeline:
    """nef apply and optional tracer: ``tracer_fn(params, *args)`` when a
    tracer is set, else ``nef_fn(params, *args)``."""
    nef_fn: Callable
    tracer_fn: Optional[Callable] = None

    def __call__(self, params, *args, **kwargs):
        if self.tracer_fn is not None:
            return self.tracer_fn(params, *args, **kwargs)
        return self.nef_fn(params, *args, **kwargs)


@torch.no_grad()
def decode_once(params: dict, grid_cfg: lg.LatentGridConfig) -> torch.Tensor:
    """The decoded feature table [T, F] of the rounded latents, for
    ``decoded=`` of ``nerf_rgba`` and ``latent_grid.interpolate``."""
    return lg.decode_codebook(params['grid'], grid_cfg)
