"""Mesh utilities: OBJ loading, surface sampling, point-to-mesh SDF.

Port of ``shacira_tpu/ops/mesh.py``.  Dataset preprocessing, run once
offline on the host, so it stays vectorized numpy as in the JAX package:
an OBJ reader, area-weighted barycentric surface samples, the closest
point on each triangle and the signed distance of points to a mesh (sign
from the nearest face's normal).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader -> (vertices [V, 3] f32, faces [F, 3] int32),
    polygons fan-triangulated."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith('v '):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith('f '):
                idx = [int(tok.split('/')[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def normalize_mesh(verts: np.ndarray, mode: str = 'sphere') -> np.ndarray:
    """Centre the bounding box and scale into the unit sphere ('sphere') or
    cube, shrunk by 1e-3."""
    vmin, vmax = verts.min(0), verts.max(0)
    center = (vmin + vmax) / 2
    v = verts - center
    if mode == 'sphere':
        v = v / np.linalg.norm(v, axis=-1).max()
    else:
        v = v / np.abs(v).max()
    return (v * (1.0 - 1e-3)).astype(np.float32)


def face_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


def sample_surface(rng: np.random.RandomState, verts: np.ndarray,
                   faces: np.ndarray, n: int) -> np.ndarray:
    """``n`` area-weighted barycentric surface samples [n, 3] f32."""
    areas = face_areas(verts, faces)
    probs = areas / areas.sum()
    fidx = rng.choice(len(faces), size=n, p=probs)
    u = rng.rand(n, 1).astype(np.float32)
    v = rng.rand(n, 1).astype(np.float32)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    a = verts[faces[fidx, 0]]
    b = verts[faces[fidx, 1]]
    c = verts[faces[fidx, 2]]
    return (a + u * (b - a) + v * (c - a)).astype(np.float32)


def _point_triangle_closest(p, a, b, c):
    """Closest point on triangle (a, b, c) to p, vectorized over the
    leading axes (the vertex, edge and face regions)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.sum(ab * ap, -1)
    d2 = np.sum(ac * ap, -1)
    bp = p - b
    d3 = np.sum(ab * bp, -1)
    d4 = np.sum(ac * bp, -1)
    cp = p - c
    d5 = np.sum(ab * cp, -1)
    d6 = np.sum(ac * cp, -1)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom = np.where(np.abs(va + vb + vc) < 1e-20, 1e-20, va + vb + vc)
    v = vb / denom
    w = vc / denom
    out = a + v[..., None] * ab + w[..., None] * ac
    # vertex regions
    out = np.where(((d1 <= 0) & (d2 <= 0))[..., None], a, out)
    out = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b, out)
    out = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c, out)
    # edge regions
    t_ab = np.clip(d1 / np.where(np.abs(d1 - d3) < 1e-20, 1e-20, d1 - d3),
                   0, 1)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    out = np.where(on_ab[..., None], a + t_ab[..., None] * ab, out)
    t_ac = np.clip(d2 / np.where(np.abs(d2 - d6) < 1e-20, 1e-20, d2 - d6),
                   0, 1)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    out = np.where(on_ac[..., None], a + t_ac[..., None] * ac, out)
    num = d4 - d3
    den = (d4 - d3) + (d5 - d6)
    t_bc = np.clip(num / np.where(np.abs(den) < 1e-20, 1e-20, den), 0, 1)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    out = np.where(on_bc[..., None], b + t_bc[..., None] * (c - b), out)
    return out


def points_to_sdf(points: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                  chunk: int = 2048) -> np.ndarray:
    """Signed distance [N] f32 of points to a triangle mesh: the distance
    to the closest face, signed by that face's geometric normal."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    n = np.cross(b - a, c - a)
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-20)
    out = np.zeros(len(points), np.float32)
    for s in range(0, len(points), chunk):
        p = points[s:s + chunk]                               # [P, 3]
        cp = _point_triangle_closest(p[:, None, :], a[None], b[None], c[None])
        diff = p[:, None, :] - cp                             # [P, F, 3]
        d2 = np.sum(diff * diff, -1)
        fi = np.argmin(d2, axis=1)
        rows = np.arange(len(p))
        dist = np.sqrt(d2[rows, fi])
        sign = np.sign(np.sum(diff[rows, fi] * n[fi], -1))
        sign = np.where(sign == 0, 1.0, sign)
        out[s:s + chunk] = (dist * sign).astype(np.float32)
    return out
