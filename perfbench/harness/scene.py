"""Blender-synthetic-shaped multiview scenes of analytic objects: the
camera rig, a sphere tracer and the views as the trainer takes them.

An object is its signed distance function, ``sdf(p)`` -> distance and
``sdf(p, with_albedo=True)`` -> (distance, albedo), given by the traffic
kind that draws it (``perfbench/traffic/<kind>.py``).  It is sphere-traced
with Lambertian shading on a white background.  :func:`render_views`
renders it on the device in batches of views; :func:`render_view_np` is
the same renderer in NumPy, kept as the plain version the tests hold the
device renderer to.  The views are handed to the trainer as a Blender
loader would: 8-bit colours blended over white, camera positions divided
by the scene's ``aabb_scale``, one ray a pixel through its centre.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

LIGHT = (0.5, 0.8, 0.3)
AMBIENT = 0.35
TRACE_ITERS = 96
FAR = 8.0

# ---------------------------------------------------------------------------
# camera rig
# ---------------------------------------------------------------------------

def rig(views: int, seed: int, radius: float, elevation) -> np.ndarray:
    """[views, 4, 4] camera-to-world poses (Blender convention) around
    the origin: azimuths evenly spaced, elevations uniform in
    ``elevation`` from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed % 2 ** 32)
    lo, hi = elevation
    out = np.zeros((views, 4, 4), np.float32)
    for v in range(views):
        theta = 2 * np.pi * (v / views)
        elev = lo + (hi - lo) * rng.rand()
        pos = np.asarray([radius * np.cos(theta) * np.cos(elev),
                          radius * np.sin(elev),
                          radius * np.sin(theta) * np.cos(elev)], np.float32)
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, pos
        out[v] = c2w
    return out


def focal(res: int, camera_angle_x: float) -> float:
    return 0.5 * res / math.tan(0.5 * camera_angle_x)


# ---------------------------------------------------------------------------
# NumPy renderer (the plain version)
# ---------------------------------------------------------------------------

def render_view_np(sdf_np, c2w, h, w, fx):
    """RGBA [h, w, 4] of one view of the object ``sdf_np`` (p [..., 3] ->
    (distance, albedo)): sphere tracing, Lambertian shading."""
    j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing='ij')
    dirs = np.stack([(i + 0.5 - w / 2) / fx, -(j + 0.5 - h / 2) / fx,
                     -np.ones_like(i)], -1)
    d = dirs @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape).copy()
    p = o.copy()
    t = np.zeros(d.shape[:-1], np.float32)
    hit = np.zeros(d.shape[:-1], bool)
    for _ in range(TRACE_ITERS):
        dist, _ = sdf_np(p)
        hit |= dist < 1e-3
        t += np.where(hit, 0.0, np.clip(dist, 1e-4, 0.3))
        p = o + d * t[..., None]
        if t.max() > FAR:
            break
    _, albedo = sdf_np(p)
    grads = []
    for ax in range(3):
        dp = np.zeros(3, np.float32)
        dp[ax] = 1e-3
        grads.append(sdf_np(p + dp)[0] - sdf_np(p - dp)[0])
    n = np.stack(grads, -1)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    light = np.asarray(LIGHT) / np.linalg.norm(LIGHT)
    diff = np.clip((n * light).sum(-1), 0, 1)
    rgb = albedo * (AMBIENT + (1 - AMBIENT) * diff[..., None])
    rgba = np.concatenate([np.where(hit[..., None], rgb, 1.0),
                           hit[..., None].astype(np.float32)], -1)
    return np.clip(rgba, 0, 1)


# ---------------------------------------------------------------------------
# device renderer
# ---------------------------------------------------------------------------

def render_views(sdf, c2w: torch.Tensor, h: int, w: int, fx: float
                 ) -> torch.Tensor:
    """RGBA [B, h, w, 4] of B views of the object ``sdf`` on c2w's device,
    as :func:`render_view_np` renders each (a view stops marching once its
    farthest ray passes ``FAR``)."""
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev),
                          indexing='ij')
    dirs = torch.stack([(i + 0.5 - w / 2) / fx, -(j + 0.5 - h / 2) / fx,
                        -torch.ones_like(i)], -1)
    d = torch.einsum('hwk,bjk->bhwj', dirs, c2w[:, :3, :3])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = c2w[:, None, None, :3, 3].expand_as(d)
    t = torch.zeros(d.shape[:-1], device=dev)
    hit = torch.zeros(d.shape[:-1], dtype=torch.bool, device=dev)
    stopped = torch.zeros((d.shape[0], 1, 1), dtype=torch.bool, device=dev)
    p = o
    for k in range(TRACE_ITERS):
        dist = sdf(p)
        hit = hit | ((dist < 1e-3) & ~stopped)
        step = torch.where(hit | stopped, 0.0, dist.clamp(1e-4, 0.3))
        t = t + step
        p = torch.where(stopped[..., None], p, o + d * t[..., None])
        stopped = stopped | (t.amax((1, 2)) > FAR)[:, None, None]
        # a stopped view changes no more: end once all have stopped
        if k % 8 == 7 and bool(stopped.all()):
            break
    _, albedo = sdf(p, with_albedo=True)
    n = torch.stack([sdf(p + e) - sdf(p - e) for e in
                     torch.eye(3, device=dev) * 1e-3], -1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-8)
    light = torch.tensor(LIGHT, device=dev) / math.sqrt(
        sum(v * v for v in LIGHT))
    diff = (n * light).sum(-1).clamp(0, 1)
    rgb = albedo * (AMBIENT + (1 - AMBIENT) * diff[..., None])
    rgba = torch.cat([torch.where(hit[..., None], rgb, 1.0),
                      hit[..., None].float()], -1)
    return rgba.clamp(0, 1)


def pixel_rays(c2w: torch.Tensor, h: int, w: int, fx: float):
    """(origins, directions) [B, h * w, 3] float32: the pixel-centre rays
    of each pose."""
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                          torch.arange(w, dtype=torch.float64, device=dev),
                          indexing='ij')
    cam = torch.stack([(i + 0.5 - w / 2) / fx, -(j + 0.5 - h / 2) / fx,
                       -torch.ones_like(i)], -1).reshape(-1, 3)
    d = torch.einsum('nk,bjk->bnj', cam, c2w[:, :3, :3].double())
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = c2w[:, None, :3, 3].expand(-1, h * w, 3)
    return o.float().contiguous(), d.float()


# ---------------------------------------------------------------------------
# the training views
# ---------------------------------------------------------------------------

@dataclass
class Views:
    """A multiview training set on the host (the fields of the program's
    ``MultiviewData``)."""
    rgb: np.ndarray        # [V, H*W, 3] float32
    rays_o: np.ndarray     # [V, H*W, 3] float32
    rays_d: np.ndarray     # [V, H*W, 3] float32
    masks: np.ndarray      # [V, H*W, 1] bool
    h: int
    w: int
    dist_min: float
    dist_max: float

    @property
    def num_views(self) -> int:
        return self.rgb.shape[0]


def multiview(t: dict, seed: int, device, sdf) -> Views:
    """``views`` views of ``res`` x ``res`` of the object ``sdf``, cameras
    at ``radius`` with elevations uniform in ``elevation``, field of view
    ``camera_angle_x``, positions divided by ``aabb_scale``; rendered on
    the device in batches of ``render_batch`` views and held on the host
    as ``MultiviewData`` holds a loaded Blender scene."""
    res, views = int(t['res']), int(t['views'])
    fx = focal(res, float(t['camera_angle_x']))
    poses = rig(views, seed, float(t['radius']), t['elevation'])
    n = res * res
    rgb = np.empty((views, n, 3), np.float32)
    rays_o = np.empty((views, n, 3), np.float32)
    rays_d = np.empty((views, n, 3), np.float32)
    masks = np.empty((views, n, 1), bool)
    batch = int(t.get('render_batch', 4))
    for a in range(0, views, batch):
        c2w = torch.as_tensor(poses[a:a + batch], device=device)
        rgba = render_views(sdf, c2w, res, res, fx)
        # an 8-bit RGBA image blended over white, as the loader reads it
        q = torch.round(rgba * 255.0).clamp(0, 255) / 255.0
        alpha = q[..., 3:4]
        col = (q[..., :3] * alpha + (1 - alpha)).clamp(0, 1)
        norm = c2w.clone()
        norm[:, :3, 3] /= float(t['aabb_scale'])
        o, d = pixel_rays(norm, res, res, fx)
        b = slice(a, a + c2w.shape[0])
        for host, dev in ((rgb, col), (masks, alpha > 0.5), (rays_o, o),
                          (rays_d, d)):
            torch.from_numpy(host[b]).copy_(dev.reshape(host[b].shape))
    return Views(rgb, rays_o, rays_d, masks, res, res,
                 float(t['dist'][0]), float(t['dist'][1]))
