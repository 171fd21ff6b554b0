"""Per-channel blend and normalize functions of a render buffer.

Port of ``shacira_tpu/core/channel_fn.py`` on tensors: every
:class:`~shacira_tpu_torch.core.renderbuffer.RenderBuffer` channel carries a
blend function (how two buffers composite: alpha-over for rgb, slerp for
normals, logical-or for hit masks) and a normalize function (how raw
values map to [0, 1] for display).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

_EPS = 1e-8


# -- normalize functions ----------------------------------------------------

def identity(c):
    return c


def normalize(c, min_val=None, max_val=None):
    """Min-max normalize to [0, 1]; bounds default to the data range."""
    lo = torch.min(c) if min_val is None else min_val
    hi = torch.max(c) if max_val is None else max_val
    return (c - lo) / torch.clamp(torch.as_tensor(hi - lo, device=c.device),
                                  min=_EPS)


def normalize_linear_scale(c, min_val=None, max_val=None, linear_scale=1.0):
    return normalize(c * linear_scale, min_val=min_val, max_val=max_val)


def normalize_log_scale(c, min_val=None, max_val=None):
    return normalize(torch.log(torch.clamp(c, min=_EPS) + 1.0),
                     min_val=min_val, max_val=max_val)


def normalize_vector(c):
    """Unit-normalize direction vectors along the last axis."""
    return c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True),
                           min=_EPS)


# -- blend functions: blend(c1, c2, alpha1, alpha2), c1 in front -------------

def blend_linear(c1, c2, alpha1, alpha2):
    """c1 + c2 (1 - c1): the alpha channel's own compositing rule."""
    return c1 + c2 * (1.0 - c1)


def blend_alpha_composite_over(c1, c2, alpha1, alpha2):
    """Painter's-algorithm alpha-over (the rgb default)."""
    a_out = alpha1 + alpha2 * (1.0 - alpha1)
    num = c1 * alpha1 + c2 * alpha2 * (1.0 - alpha1)
    return torch.where(a_out > 0, num / torch.clamp(a_out, min=_EPS),
                       torch.zeros_like(c1))


def blend_alpha_lerp(c1, c2, alpha1, alpha2):
    return c1 * alpha1 + c2 * (1.0 - alpha1)


def blend_alpha_slerp(c1, c2, alpha1, alpha2):
    """Spherical lerp over the unit hypersphere (directional channels such
    as normals); alpha1 is the interpolation weight.  Where the two
    directions are (anti)parallel, a linear blend of the units."""
    t = alpha1
    u1 = normalize_vector(c1)
    u2 = normalize_vector(c2)
    dot = torch.clamp(torch.sum(u1 * u2, dim=-1, keepdim=True), -1.0, 1.0)
    omega = torch.arccos(dot)
    sin_omega = torch.sin(omega)
    safe = torch.abs(sin_omega) > _EPS
    denom = torch.where(safe, sin_omega, torch.ones_like(sin_omega))
    w1 = torch.where(safe, torch.sin(t * omega) / denom, t)
    w2 = torch.where(safe, torch.sin((1.0 - t) * omega) / denom, 1.0 - t)
    return w1 * u1 + w2 * u2


def blend_normal(c1, c2, alpha1, alpha2):
    """Front pixel wins (categorical channels)."""
    return c1


def blend_multiply(c1, c2, alpha1, alpha2):
    return c1 * c2


def blend_screen(c1, c2, alpha1, alpha2):
    return 1.0 - (1.0 - c1) * (1.0 - c2)


def blend_add(c1, c2, alpha1, alpha2):
    return c1 + c2


def blend_sub(c1, c2, alpha1, alpha2):
    return c1 - c2


def blend_logical_and(c1, c2, alpha1, alpha2):
    return (c1.bool() & c2.bool()).to(c1.dtype)


def blend_logical_or(c1, c2, alpha1, alpha2):
    return (c1.bool() | c2.bool()).to(c1.dtype)


# -- channel descriptors ----------------------------------------------------

@dataclass
class Channel:
    """How a RenderBuffer channel blends, normalizes and is bounded."""
    blend_fn: Callable = blend_alpha_composite_over
    normalize_fn: Callable = normalize
    min_val: Optional[Any] = None
    max_val: Optional[Any] = None


def create_default_channel() -> Channel:
    return Channel()


def channels_starter_kit() -> Dict[str, Channel]:
    """The standard channel kit."""
    return dict(
        rgb=Channel(blend_alpha_composite_over, identity, 0.0, 1.0),
        alpha=Channel(blend_linear, normalize, 0.0, 1.0),
        depth=Channel(blend_normal,
                      functools.partial(normalize_linear_scale,
                                        linear_scale=1000.0), 0.0),
        normal=Channel(blend_alpha_slerp, normalize_vector),
        hit=Channel(blend_logical_or, identity),
        err=Channel(blend_add, normalize),
        gt=Channel(blend_alpha_composite_over, identity, 0.0, 1.0),
    )
