"""Offline renderer: lookat cameras, batched tracing, turntables, image
files.

Port of ``CameraConfig``, ``lookat_rays``, ``render_rays``, ``turntable``
and ``save_gif`` of ``shacira_tpu/render/offline.py``; ``save_png`` lives in
the image app (``apps/train_image.py``, as in the JAX package) and is
re-exported here.  The JAX package splits a PRNG key per ray batch;
here every batch draws its march jitter from one ``torch.Generator``,
seeded 0 per frame unless the caller passes one.  A turntable composites
overlay layers (``render/overlay.py``) over each frame with its depth
buffer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from shacira_tpu_torch.apps.train_image import save_png  # noqa: F401
from shacira_tpu_torch.core.rays import make_rays
from shacira_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class CameraConfig:
    width: int = 512
    height: int = 512
    fov: float = 30.0              # degrees, full vertical fov
    dist_min: float = 0.0
    dist_max: float = 6.0


def lookat_rays(origin, target, cfg: CameraConfig, up=(0.0, 1.0, 0.0)):
    """Pinhole rays (origins, dirs) [H*W, 3] f32 of a camera at ``origin``
    looking at ``target``."""
    origin = np.asarray(origin, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    cup = np.cross(right, fwd)

    h, w = cfg.height, cfg.width
    f = 0.5 * h / np.tan(0.5 * np.deg2rad(cfg.fov))
    jj, ii = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing='ij')
    u = (ii + 0.5 - w / 2) / f
    v = -(jj + 0.5 - h / 2) / f
    dirs = (u[..., None] * right + v[..., None] * cup + fwd)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = np.broadcast_to(origin, dirs.shape)
    return (o.reshape(-1, 3).astype(np.float32),
            dirs.reshape(-1, 3).astype(np.float32))


@torch.no_grad()
def render_rays(trace_fn: Callable, rays_o: np.ndarray, rays_d: np.ndarray,
                cfg: CameraConfig, batch: int = 16384,
                generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Full-frame render in ray batches of ``batch`` (the tail padded, so
    every batch has one shape): ``trace_fn(rays, generator)`` -> dict of
    tensors; returns the same keys as numpy arrays over the frame's rays."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    n = rays_o.shape[0]
    pad = (-n) % batch
    if pad:
        rays_o = np.concatenate([rays_o, rays_o[:pad]])
        rays_d = np.concatenate([rays_d, rays_d[:pad]])
    outs = {}
    for s in range(0, len(rays_o), batch):
        rays = make_rays(torch.as_tensor(rays_o[s:s + batch], device=dev),
                         torch.as_tensor(rays_d[s:s + batch], device=dev),
                         cfg.dist_min, cfg.dist_max)
        for key, v in trace_fn(rays, generator).items():
            outs.setdefault(key, []).append(v.cpu().numpy())
    return {key: np.concatenate(v)[:n] for key, v in outs.items()}


def turntable(trace_fn: Callable, cfg: CameraConfig, num_angles: int = 16,
              radius: float = 3.0, elevation: float = 0.65,
              target=(0.0, 0.0, 0.0),
              generator: Optional[torch.Generator] = None, layers=None,
              device=None):
    """360-degree turntable: yields ``num_angles`` [H, W, 3] frames from
    cameras on a circle of ``radius`` at height ``elevation``.  ``layers``
    ({name: PrimitivesPack}) are composited over each frame with the
    frame's depth buffer."""
    for a in range(num_angles):
        theta = 2 * np.pi * a / num_angles
        origin = np.asarray([radius * np.cos(theta), elevation,
                             radius * np.sin(theta)], np.float32)
        ro, rd = lookat_rays(origin, target, cfg)
        out = render_rays(trace_fn, ro, rd, cfg, generator=generator,
                          device=device)
        frame = out['rgb'].reshape(cfg.height, cfg.width, 3)
        if layers:
            from shacira_tpu_torch.render.overlay import (PinholeCamera,
                                                          draw_layers)
            cam = PinholeCamera.from_lookat(origin, target, cfg)
            depth = out.get('depth')
            if depth is not None:
                depth = depth.reshape(cfg.height, cfg.width)
            frame = draw_layers(frame, cam, layers, depth=depth)
        yield frame


def _uint8(img01: np.ndarray) -> np.ndarray:
    return np.clip(img01 * 255.0, 0, 255).astype(np.uint8)


def save_gif(frames, path: str, fps: int = 10):
    """Frames [H, W, 3] in [0, 1] as a looping GIF."""
    from PIL import Image
    imgs = [Image.fromarray(_uint8(f)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
