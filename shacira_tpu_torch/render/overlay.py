"""Software overlay rasterizer for vectorial debug layers.

The port's copy of ``shacira_tpu/render/overlay.py`` (numpy, on the host):
project world-space lines and points of ``PrimitivesPack`` layers through
the pinhole model that generated the rays (``offline.lookat_rays``),
sample them at sub-pixel steps and alpha-blend them into a rendered frame,
with an optional depth test against the frame's depth buffer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from shacira_tpu_torch.core.primitives import PrimitivesPack
from shacira_tpu_torch.render.offline import CameraConfig


@dataclass
class PinholeCamera:
    """World->pixel projection matching ``offline.lookat_rays`` exactly
    (a point on the ray of pixel (j, i) projects back to (j, i))."""
    origin: np.ndarray
    right: np.ndarray
    up: np.ndarray
    fwd: np.ndarray
    f: float
    height: int
    width: int
    znear: float = 1e-3

    @staticmethod
    def from_lookat(origin, target, cfg: CameraConfig,
                    up=(0.0, 1.0, 0.0)) -> 'PinholeCamera':
        origin = np.asarray(origin, np.float32)
        target = np.asarray(target, np.float32)
        up = np.asarray(up, np.float32)
        fwd = target - origin
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        cup = np.cross(right, fwd)
        f = 0.5 * cfg.height / np.tan(0.5 * np.deg2rad(cfg.fov))
        return PinholeCamera(origin, right, cup, fwd, float(f),
                             cfg.height, cfg.width)

    def to_camera(self, pts: np.ndarray) -> np.ndarray:
        """World points [N, 3] -> camera coords [N, 3] (z = view depth)."""
        d = np.asarray(pts, np.float32) - self.origin
        return np.stack([d @ self.right, d @ self.up, d @ self.fwd], -1)

    def project(self, pts: np.ndarray):
        """[N, 3] world -> (col, row, depth, in_front) pixel coords (float)."""
        c = self.to_camera(pts)
        z = np.maximum(c[:, 2], self.znear)
        col = c[:, 0] / z * self.f + self.width / 2 - 0.5
        row = -c[:, 1] / z * self.f + self.height / 2 - 0.5
        return col, row, c[:, 2], c[:, 2] > self.znear


def _blend_into(img, flat_idx, rgba, depth_img, sample_depth):
    """Alpha-blend rgba samples into img at flat pixel indices (dedup so a
    primitive never double-blends one pixel; later layers draw over)."""
    h, w, _ = img.shape
    keep = (flat_idx >= 0) & (flat_idx < h * w)
    if depth_img is not None:
        d = depth_img.reshape(-1)[np.clip(flat_idx, 0, h * w - 1)]
        # treat zero/invalid depth as background (always draw)
        keep &= (d <= 0) | (sample_depth <= d + 1e-3)
    flat_idx, rgba = flat_idx[keep], rgba[keep]
    if len(flat_idx) == 0:
        return
    uniq, first = np.unique(flat_idx, return_index=True)
    rgba = rgba[first]
    flat = img.reshape(-1, 3)
    a = rgba[:, 3:4]
    flat[uniq] = flat[uniq] * (1.0 - a) + rgba[:, :3] * a


def _clip_segments(cam: PinholeCamera, start, end):
    """Clip segments to the z > znear half-space (parametric)."""
    cs, ce = cam.to_camera(start), cam.to_camera(end)
    zs, ze = cs[:, 2], ce[:, 2]
    both_behind = (zs <= cam.znear) & (ze <= cam.znear)
    dz = ze - zs
    t_cross = np.where(np.abs(dz) > 1e-12, (cam.znear - zs) / np.where(
        np.abs(dz) > 1e-12, dz, 1.0), 0.0)
    t0 = np.where(zs <= cam.znear, t_cross, 0.0)
    t1 = np.where(ze <= cam.znear, t_cross, 1.0)
    s3 = start + t0[:, None] * (end - start)
    e3 = start + t1[:, None] * (end - start)
    return s3, e3, ~both_behind


def rasterize_lines(img, cam: PinholeCamera, start, end, color,
                    depth: Optional[np.ndarray] = None,
                    max_samples: int = 1024):
    """Draw line segments into img [H, W, 3] (in place).

    Each segment is sampled at one point per pixel of screen length (capped
    at ``max_samples``), depth-interpolated, and alpha-blended.
    """
    start = np.atleast_2d(np.asarray(start, np.float32))
    end = np.atleast_2d(np.asarray(end, np.float32))
    color = np.broadcast_to(np.atleast_2d(np.asarray(color, np.float32)),
                            (start.shape[0], 4))
    s3, e3, vis = _clip_segments(cam, start, end)
    if not np.any(vis):
        return
    s3, e3, color = s3[vis], e3[vis], color[vis]
    x0, y0, d0, _ = cam.project(s3)
    x1, y1, d1, _ = cam.project(e3)
    span = np.maximum(np.abs(x1 - x0), np.abs(y1 - y0))
    m = int(np.clip(np.ceil(span.max() + 1), 2, max_samples))
    t = np.linspace(0.0, 1.0, m, dtype=np.float32)[None, :]     # [1, M]
    # cap each segment's own sample count at its span (avoids oversampling
    # short segments into repeated pixels; dedup handles the rest)
    xs = x0[:, None] + t * (x1 - x0)[:, None]
    ys = y0[:, None] + t * (y1 - y0)[:, None]
    # perspective-correct depth along the segment: interpolate 1/z
    inv = 1.0 / np.maximum(d0, cam.znear)[:, None] + t * (
        1.0 / np.maximum(d1, cam.znear) - 1.0 / np.maximum(d0, cam.znear)
    )[:, None]
    ds = 1.0 / np.maximum(inv, 1e-6)
    ix = np.round(xs).astype(np.int64)
    iy = np.round(ys).astype(np.int64)
    inside = (ix >= 0) & (ix < cam.width) & (iy >= 0) & (iy < cam.height)
    flat = np.where(inside, iy * cam.width + ix, -1).reshape(-1)
    rgba = np.broadcast_to(color[:, None, :], (*xs.shape, 4)).reshape(-1, 4)
    _blend_into(img, flat, rgba, depth, ds.reshape(-1))


def rasterize_points(img, cam: PinholeCamera, pos, color,
                     depth: Optional[np.ndarray] = None,
                     point_size: float = 1.0):
    """Splat points as (2r+1)^2 squares, alpha-blended with depth test."""
    pos = np.atleast_2d(np.asarray(pos, np.float32))
    color = np.broadcast_to(np.atleast_2d(np.asarray(color, np.float32)),
                            (pos.shape[0], 4))
    x, y, d, front = cam.project(pos)
    x, y, d, color = x[front], y[front], d[front], color[front]
    if len(x) == 0:
        return
    r = max(0, int(round((point_size - 1) / 2)))
    offs = np.arange(-r, r + 1)
    ox, oy = np.meshgrid(offs, offs, indexing='ij')
    ix = np.round(x)[:, None] + ox.reshape(-1)[None, :]
    iy = np.round(y)[:, None] + oy.reshape(-1)[None, :]
    inside = (ix >= 0) & (ix < cam.width) & (iy >= 0) & (iy < cam.height)
    flat = np.where(inside, iy * cam.width + ix, -1).astype(np.int64)
    k = flat.shape[1]
    rgba = np.broadcast_to(color[:, None, :], (len(x), k, 4)).reshape(-1, 4)
    ds = np.broadcast_to(d[:, None], (len(x), k)).reshape(-1)
    _blend_into(img, flat.reshape(-1), rgba, depth, ds)


def draw_layers(rgb: np.ndarray, cam: PinholeCamera,
                layers: Dict[str, PrimitivesPack],
                depth: Optional[np.ndarray] = None) -> np.ndarray:
    """Composite data layers over a rendered frame (in layer order, each
    drawn over the last); returns a new image.  ``depth`` [H, W]: a layer
    pixel farther than the frame's surface is hidden (zero depth is
    background)."""
    out = np.array(rgb, np.float32, copy=True)
    for pack in layers.values():
        ln = pack.world_lines()
        if ln is not None:
            rasterize_lines(out, cam, ln[0], ln[1], ln[2], depth)
        pt = pack.world_points()
        if pt is not None:
            rasterize_points(out, cam, pt[0], pt[1], depth,
                             point_size=pack.point_size)
    return out
