"""SDF metrics and sampling utilities.

Port of ``shacira_tpu/ops/sdf.py``: the sign-agreement IoU and the point
draws of the SDF datasets (surface / near-surface / uniform), host-side
numpy from a ``np.random.RandomState``, so a seed gives the same pool as
the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def compute_sdf_iou(pred, gts) -> float:
    """Sign-agreement IoU x100 of predicted and true distances (arrays or
    tensors)."""
    inside_pred = _host(pred) < 0
    inside_gts = _host(gts) < 0
    union = np.sum(inside_pred | inside_gts)
    inter = np.sum(inside_pred & inside_gts)
    return 100.0 * float(inter) / max(float(union), 1.0)


def sample_uniform(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Uniform samples in [-1, 1]^3."""
    return rng.uniform(-1, 1, (n, 3)).astype(np.float32)


def sample_near_surface(rng: np.random.RandomState, surface_pts: np.ndarray,
                        n: int, variance: float = 0.01) -> np.ndarray:
    """Gaussian perturbations of randomly chosen surface points."""
    idx = rng.randint(0, len(surface_pts), n)
    return (surface_pts[idx]
            + rng.randn(n, 3).astype(np.float32) * np.sqrt(variance))


def sample_surface_sphere(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Uniform points on the unit sphere."""
    v = rng.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)
