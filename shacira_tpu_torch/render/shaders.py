"""Matcap and shadow shaders for SDF renders.

Port of ``shacira_tpu/render/shaders.py``: spherical-envmap matcap UVs
and a bilinear texture fetch; a ground plane at ``min_y`` with shadow rays
toward a point light, traced against the scene, and a gaussian-smoothed
shadow map.  Buffers are the dicts of ``tracers/sdf_tracer`` (hit, depth,
xyz, normal, rgb).  The shadow rays' jitter is off unless a
``torch.Generator`` is passed.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from shacira_tpu_torch.core.rays import Rays, make_rays


def spherical_envmap(ray_dir: torch.Tensor,
                     normal: torch.Tensor) -> torch.Tensor:
    """Matcap UVs [..., 2] in [0, 1]: the screen-space ray reflected about
    the normal, projected to sphere coordinates."""
    rds = torch.cat([ray_dir[..., :2], -ray_dir[..., 2:]], dim=-1)
    dot = torch.sum(normal * rds, dim=-1, keepdim=True)
    r = rds - 2.0 * dot * normal
    r = torch.cat([r[..., :2], r[..., 2:] - 1.0], dim=-1)
    m = 2.0 * torch.sqrt(torch.sum(r ** 2, dim=-1, keepdim=True))
    vn = 1.0 - (r[..., :2] / torch.clamp(m, min=1e-12) + 0.5)
    vn = torch.clamp(vn, 0.0, 1.0)
    return torch.nan_to_num(vn)


def sample_texture_bilinear(tex: torch.Tensor,
                            uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``tex`` [H, W, C] at ``uv`` [..., 2] in [0, 1],
    u along the first axis (the matcap's transposed layout)."""
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * (h - 1)
    y = uv[..., 1] * (w - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, h - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, w - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    t00 = tex[x0, y0]
    t01 = tex[x0, y0 + 1]
    t10 = tex[x0 + 1, y0]
    t11 = tex[x0 + 1, y0 + 1]
    return ((t00 * (1 - fx) * (1 - fy)) + (t01 * (1 - fx) * fy)
            + (t10 * fx * (1 - fy)) + (t11 * fx * fy))


def matcap_shader(rb: dict, rays: Rays, matcap, mm=None) -> dict:
    """rb with 'rgb' replaced by the matcap fetch at each normal.

    ``matcap``: [H, W, 3] texture in [0, 1] (array or tensor), transposed
    as :func:`load_matcap` gives it; ``mm``: an optional [3, 3] rotation
    of the view direction."""
    view = rays.dirs
    if mm is not None:
        view = view @ torch.as_tensor(mm, dtype=view.dtype,
                                      device=view.device).T
    uv = spherical_envmap(view, rb['normal'])
    tex = torch.as_tensor(matcap, dtype=torch.float32, device=view.device)
    return {**rb, 'rgb': sample_texture_bilinear(tex, uv)[..., :3]}


def load_matcap(path: str):
    """A matcap texture file [W, H, 3] in the transposed layout."""
    from shacira_tpu_torch.datasets.image import load_rgb
    return load_rgb(path).transpose(1, 0, 2)


def _gaussian_blur_1d(img: torch.Tensor, sigma: float,
                      axis: int) -> torch.Tensor:
    """Blur along one axis of a 2D map: a normalized gaussian of radius
    ``max(1, int(3 sigma))``, the borders extended by their edge values."""
    radius = max(1, int(3 * sigma))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)
    rows = img.movedim(axis, -1)
    shape = rows.shape
    rows = F.pad(rows.reshape(-1, 1, shape[-1]), (radius, radius),
                 mode='replicate')
    out = F.conv1d(rows, k.flip(0)[None, None])
    return out.reshape(shape).movedim(-1, axis)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable gaussian blur of an [H, W] map."""
    return _gaussian_blur_1d(_gaussian_blur_1d(img, sigma, 0), sigma, 1)


def shadow_shader(rb: dict, rays: Rays, trace_hit_fn, point_light,
                  min_y: float, image_shape=None,
                  generator: Optional[torch.Generator] = None) -> dict:
    """Ground-plane and point-light shadow shading.

    Args:
        rb: buffer dict with 'hit' [N], 'depth' [N, 1], 'xyz' [N, 3],
            'normal' [N, 3], 'rgb' [N, 3].
        trace_hit_fn: (Rays) -> hit [N] bool, the shadow rays traced
            against the scene.
        point_light: [3] light position; min_y: the ground plane's height.
        image_shape: (H, W) to smooth the shadow map over the image.
        generator: jitter of the shadow directions (N(0, 0.01)); none
            without it.
    The shadow rays' far bound is ``rays.dist_max[0]``, read to the host
    once.
    """
    o, d = rays.origins, rays.dirs
    dev = o.device
    rate = -d[:, 1]
    delta = o[:, 1] - min_y
    plane_t = delta / torch.where(torch.abs(rate) < 1e-5, 1e-5, rate)
    plane_hit = (torch.abs(rate) >= 1e-5) & (plane_t > 0) & (plane_t < 500)
    depth = rb['depth'][..., 0]
    plane_hit = plane_hit & (~rb['hit'] | (plane_t < depth))

    hit = rb['hit'] & ~plane_hit
    depth = torch.where(plane_hit, plane_t, depth)
    xyz = torch.where(plane_hit[:, None], o + d * plane_t[:, None], rb['xyz'])
    up = torch.zeros(3, device=dev)
    up[1] = 1.0
    normal = torch.where(plane_hit[:, None], up, rb['normal'])

    light = torch.as_tensor(point_light, dtype=torch.float32).to(dev)
    shadow_o = xyz + 0.01 * normal
    shadow_d = light[None, :] - shadow_o
    if generator is not None:
        shadow_d = shadow_d + torch.randn(shadow_o.shape, generator=generator,
                                          device=dev) * 0.01
    shadow_d = shadow_d / torch.linalg.norm(shadow_d, dim=-1, keepdim=True)
    light_facing = torch.sum(shadow_d * normal, dim=-1) > 0.0

    shadow_rays = make_rays(shadow_o, shadow_d, 0.0,
                            float(rays.dist_max.reshape(-1)[0]))
    shadow = trace_hit_fn(shadow_rays) & light_facing & (hit | plane_hit)

    shadow_map = torch.clamp((1.0 - shadow.float()) + 0.7, 0.0, 1.0)
    if image_shape is not None:
        shadow_map = gaussian_blur(shadow_map.reshape(image_shape),
                                   2.0).reshape(-1)
    rgb = rb['rgb'] * shadow_map[:, None]
    rgb = torch.where(plane_hit[:, None], 0.8 * shadow_map[:, None], rgb)
    return {**rb, 'rgb': rgb, 'hit': hit | plane_hit, 'depth': depth[:, None],
            'xyz': xyz, 'normal': normal, 'shadow': shadow}
