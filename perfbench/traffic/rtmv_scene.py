"""Traffic kind ``rtmv_scene``: a scene in RTMV's layout (Tremblay et al.,
"RTMV: A Ray-Traced Multi-View Synthetic Dataset for Novel View
Synthesis", 2022: ``NNNNN.exr`` views holding R, G, B, A and a
ray-distance depth channel ``Z``, each beside a ``NNNNN.json`` camera) of
the lego-like object of the ``multiview_object`` kind, seen from the camera
rig of the repository's ``tools/make_synthetic_data.write_rtmv_scene``,
rendered on the device and read by the program's own RTMV loader
(``datasets/rtmv.load_rtmv``: the ratio split, the normalization in the
train split's frame, the distance bounds and the depth point cloud), as
the app reads an RTMV scene.

The mix's parameters: ``views`` views of ``res`` x ``res`` read at
``mip``, field of view ``camera_angle_x``, cameras at ``radius`` around
the object, azimuths ``2 pi turns v / views``, elevations uniform in
``elevation`` from ``RandomState(seed)``, ``bg_color`` for the loader,
``render_batch`` views rendered at once.

The loader reads a view at ``mip`` as every ``2^mip``-th row and column
of it, with the intrinsics scaled by ``2^-mip``.  Only those pixels are
rendered and written, as views of ``res / 2^mip`` with the intrinsics so
scaled, and the scene is loaded at mip 0: the arrays ``load_rtmv(...,
mip)`` makes of the whole views, bit for bit, from ``4^-mip`` of the
bytes (:func:`write_scene` writes either).
"""
from __future__ import annotations

import json
import math
import os
import tempfile

import numpy as np
import torch

from perfbench.harness import bench, scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rig(t: dict, seed: int) -> np.ndarray:
    """[views, 4, 4] camera-to-world poses (Blender convention) of
    ``write_rtmv_scene``'s rig."""
    views = int(t['views'])
    rng = np.random.RandomState(seed % 2 ** 32)
    lo, hi = t['elevation']
    r = float(t['radius'])
    out = np.zeros((views, 4, 4), np.float32)
    for v in range(views):
        theta = 2 * np.pi * (v / views) * float(t['turns'])
        elev = lo + (hi - lo) * rng.rand()
        pos = np.asarray([r * np.cos(theta) * np.cos(elev),
                          r * np.sin(elev),
                          r * np.sin(theta) * np.cos(elev)], np.float32)
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, pos
        out[v] = c2w
    return out


def render(sdf, c2w: torch.Tensor, res: int, fx: float, stride: int):
    """(RGBA [B, n, n, 4], ray distance [B, n, n]) of the pixels ``(stride
    j, stride i)`` of B views of ``res`` x ``res`` (``n = res / stride``):
    the sphere tracer and shading of ``scene.render_view_np``, each ray
    marched on its own (it stops at a hit or past ``scene.FAR``), so a
    pixel's value does not depend on which others are rendered; the
    distance is 0 where the ray hits nothing."""
    dev = c2w.device
    px = torch.arange(0, res, stride, dtype=torch.float32, device=dev)
    j, i = torch.meshgrid(px, px, indexing='ij')
    cam = ((i + 0.5 - res / 2) / fx, -(j + 0.5 - res / 2) / fx,
           -torch.ones_like(i))
    rot = c2w[:, None, None, :3, :3]
    d = sum(cam[k][None, ..., None] * rot[..., k] for k in range(3))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = c2w[:, None, None, :3, 3].expand_as(d)
    t = torch.zeros(d.shape[:-1], device=dev)
    hit = torch.zeros(d.shape[:-1], dtype=torch.bool, device=dev)
    p = o
    for _ in range(scene.TRACE_ITERS):
        dist = sdf(p)
        done = hit | (t > scene.FAR)
        hit = hit | ((dist < 1e-3) & ~done)
        t = t + torch.where(hit | done, 0.0, dist.clamp(1e-4, 0.3))
        p = o + d * t[..., None]
    _, albedo = sdf(p, with_albedo=True)
    n = torch.stack([sdf(p + e) - sdf(p - e) for e in
                     torch.eye(3, device=dev) * 1e-3], -1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-8)
    light = torch.tensor(scene.LIGHT, device=dev) / math.sqrt(
        sum(v * v for v in scene.LIGHT))
    diff = (n * light).sum(-1).clamp(0, 1)
    rgb = albedo * (scene.AMBIENT + (1 - scene.AMBIENT) * diff[..., None])
    rgba = torch.cat([torch.where(hit[..., None], rgb, 1.0),
                      hit[..., None].float()], -1).clamp(0, 1)
    return rgba, torch.where(hit, t, 0.0)


def write_scene(outdir: str, t: dict, seed: int, device, stride: int = 1):
    """Write the scene's views in RTMV's layout under ``outdir``: every
    ``stride``-th row and column of each ``res`` x ``res`` view, with the
    intrinsics scaled by ``1 / stride``."""
    from shacira_tpu_torch.ops.exr import write_exr
    sdf = bench.kind(ROOT, 'multiview_object').sdf
    res = int(t['res'])
    fx = 0.5 * res / math.tan(0.5 * float(t['camera_angle_x']))
    poses = rig(t, seed)
    batch = int(t.get('render_batch', 10))
    s = 1.0 / stride
    intrinsics = {'fx': fx * s, 'fy': fx * s, 'cx': res / 2.0 * s,
                  'cy': res / 2.0 * s}
    for a in range(0, len(poses), batch):
        c2w = torch.as_tensor(poses[a:a + batch], device=device)
        rgba, depth = render(sdf, c2w, res, fx, stride)
        rgba, depth = rgba.cpu().numpy(), depth.cpu().numpy()
        for k in range(c2w.shape[0]):
            v = a + k
            write_exr(os.path.join(outdir, f'{v:05d}.exr'),
                      {'R': rgba[k, ..., 0], 'G': rgba[k, ..., 1],
                       'B': rgba[k, ..., 2], 'A': rgba[k, ..., 3],
                       'Z': depth[k]})
            with open(os.path.join(outdir, f'{v:05d}.json'), 'w') as f:
                # the loader transposes on read (RTMV stores row-major)
                json.dump({'camera_data': {'cam2world': poses[v].T.tolist(),
                                           'intrinsics': intrinsics}}, f)


def make(t: dict, seed: int, device):
    """The train split of the scene for ``seed``, as ``load_rtmv`` reads it
    at the mix's ``mip`` (the program's ``MultiviewData``)."""
    from shacira_tpu_torch.datasets.rtmv import load_rtmv
    with tempfile.TemporaryDirectory(prefix='rtmv_scene_') as tmp:
        write_scene(tmp, t, seed, device, stride=2 ** int(t['mip']))
        return load_rtmv(tmp, 'train', mip=0, bg_color=t['bg_color'])
