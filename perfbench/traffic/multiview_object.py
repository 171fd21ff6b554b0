"""Traffic kind ``multiview_object``: views of the lego-like composite
object of the repository's ``tools/make_synthetic_data.py`` (boxes,
spheres, a torus and cylinders on a checkered base), copied; the mix's
parameters are :func:`perfbench.harness.scene.multiview`'s."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import scene

# (kind, centre, sizes, albedo) of the composite object
PARTS = (
    ('box', (0.0, -0.45, 0.0), (0.55, 0.08, 0.55), (0.15, 0.45, 0.15)),
    ('box', (-0.25, -0.22, -0.2), (0.18, 0.14, 0.18), (0.8, 0.15, 0.1)),
    ('box', (-0.25, 0.04, -0.2), (0.14, 0.12, 0.14), (0.9, 0.7, 0.1)),
    ('sphere', (0.3, -0.1, 0.25), (0.22,), (0.2, 0.3, 0.85)),
    ('torus', (0.25, 0.28, -0.25), (0.18, 0.06), (0.85, 0.5, 0.1)),
    ('cyl', (-0.3, 0.32, 0.3), (0.08, 0.2), (0.6, 0.2, 0.7)),
    ('cyl', (0.05, -0.2, 0.0), (0.05, 0.25), (0.2, 0.8, 0.8)),
    ('sphere', (-0.05, 0.45, 0.05), (0.12,), (0.95, 0.9, 0.85)),
)


def sdf_np(p):
    """Signed distance and albedo of the object at p [..., 3]."""
    def box(p, c, b):
        q = np.abs(p - c) - b
        return (np.linalg.norm(np.maximum(q, 0), axis=-1)
                + np.minimum(q.max(-1), 0.0))

    def sphere(p, c, r):
        return np.linalg.norm(p - c, axis=-1) - r

    def torus(p, c, R, r):
        q = p - c
        qx = np.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - R
        return np.sqrt(qx ** 2 + q[..., 1] ** 2) - r

    def cyl(p, c, r, hh):
        q = p - c
        d = np.stack([np.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - r,
                      np.abs(q[..., 1]) - hh], -1)
        return (np.minimum(np.maximum(d[..., 0], d[..., 1]), 0.0)
                + np.linalg.norm(np.maximum(d, 0), axis=-1))

    fns = {'box': lambda c, s: box(p, c, s),
           'sphere': lambda c, s: sphere(p, c, *s),
           'torus': lambda c, s: torus(p, c, *s),
           'cyl': lambda c, s: cyl(p, c, *s)}
    d = np.full(p.shape[:-1], 1e9, np.float32)
    col = np.zeros(p.shape[:-1] + (3,), np.float32)
    for kind, c, s, a in PARTS:
        dist = fns[kind](c, s)
        m = dist < d
        d = np.where(m, dist, d)
        col[m] = a
    checker = ((np.floor(p[..., 0] * 8) + np.floor(p[..., 2] * 8)) % 2)
    base = ((np.abs(p[..., 1] + 0.45) < 0.1) & (col[..., 1] > 0.4)
            & (col[..., 0] < 0.2))
    col[base] *= (0.6 + 0.4 * checker[base])[..., None]
    return d, col


def sdf(p: torch.Tensor, with_albedo: bool = False):
    """:func:`sdf_np` on the device: distance [...] (and albedo
    [..., 3])."""
    x, y, z = p.unbind(-1)
    d = torch.full_like(x, 1e9)
    col = torch.zeros_like(p) if with_albedo else None
    for kind, c, s, a in PARTS:
        qx, qy, qz = x - c[0], y - c[1], z - c[2]
        if kind == 'box':
            ax, ay, az = qx.abs() - s[0], qy.abs() - s[1], qz.abs() - s[2]
            dist = (torch.sqrt(ax.clamp(min=0) ** 2 + ay.clamp(min=0) ** 2
                               + az.clamp(min=0) ** 2)
                    + torch.maximum(torch.maximum(ax, ay), az).clamp(max=0))
        elif kind == 'sphere':
            dist = torch.sqrt(qx * qx + qy * qy + qz * qz) - s[0]
        elif kind == 'torus':
            rx = torch.sqrt(qx * qx + qz * qz) - s[0]
            dist = torch.sqrt(rx * rx + qy * qy) - s[1]
        else:
            a0 = torch.sqrt(qx * qx + qz * qz) - s[0]
            a1 = qy.abs() - s[1]
            dist = (torch.maximum(a0, a1).clamp(max=0)
                    + torch.sqrt(a0.clamp(min=0) ** 2 + a1.clamp(min=0) ** 2))
        m = dist < d
        d = torch.where(m, dist, d)
        if with_albedo:
            col = torch.where(m[..., None], col.new_tensor(a), col)
    if not with_albedo:
        return d
    checker = torch.remainder(torch.floor(x * 8) + torch.floor(z * 8), 2)
    base = (((y + 0.45).abs() < 0.1) & (col[..., 1] > 0.4)
            & (col[..., 0] < 0.2))
    col = torch.where(base[..., None], col * (0.6 + 0.4 * checker)[..., None],
                      col)
    return d, col


def make(t: dict, seed: int, device) -> scene.Views:
    return scene.multiview(t, seed, device, sdf)
