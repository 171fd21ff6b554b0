"""NeRF-synthetic (Blender) dataset: transforms.json parsing + ray generation.

Port of ``shacira_tpu/datasets/nerf_synthetic.py`` (host-side numpy): INGP
metadata (camera_angle_x / x_fov, cx / cy, scale / offset / aabb_scale),
per-view rays in the Blender camera convention, alpha -> mask + background
blend, flattened to ``(views, H*W, ...)``.  PIL is imported only when
images are loaded.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class MultiviewData:
    rgb: np.ndarray        # [V, H*W, 3]
    rays_o: np.ndarray     # [V, H*W, 3]
    rays_d: np.ndarray     # [V, H*W, 3]
    masks: np.ndarray      # [V, H*W, 1] bool
    h: int
    w: int
    dist_min: float = 0.0
    dist_max: float = 6.0
    # depth point cloud in normalized [-1,1] scene coords (RTMV RGB-D); the
    # trainer seeds its occupancy grid from it
    pointcloud: Optional[np.ndarray] = None
    # similarity transform applied to the camera origins; None = identity
    norm_center: Optional[np.ndarray] = None
    norm_scale: float = 1.0

    @property
    def num_views(self) -> int:
        return self.rgb.shape[0]


def pinhole_rays(pose_c2w: np.ndarray, h: int, w: int, fx: float, fy: float,
                 x0: float = 0.0, y0: float = 0.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel rays of one camera-to-world pose: pixel centers at
    (i + .5, j + .5), camera dir ((u - W/2 - x0)/fx, -(v - H/2 - y0)/fy, -1)
    normalized and rotated to world."""
    j, i = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing='ij')
    u = i + 0.5 - w / 2 - x0
    v = j + 0.5 - h / 2 - y0
    dirs = np.stack([u / fx, -v / fy, -np.ones_like(u)], axis=-1)
    world_d = dirs @ pose_c2w[:3, :3].T
    world_d /= np.linalg.norm(world_d, axis=-1, keepdims=True)
    world_o = np.broadcast_to(pose_c2w[:3, 3], world_d.shape)
    return (world_o.reshape(-1, 3).astype(np.float32),
            world_d.reshape(-1, 3).astype(np.float32))


def load_nerf_synthetic(root: str, split: str = 'train',
                        bg_color: str = 'white', mip: int = 0,
                        max_views: Optional[int] = None) -> MultiviewData:
    """Load a Blender-synthetic scene (transforms_{split}.json)."""
    from PIL import Image

    tpath = os.path.join(root, f'transforms_{split}.json')
    if not os.path.exists(tpath):
        tpath = os.path.join(root, 'transforms.json')
    with open(tpath) as f:
        metadata = json.load(f)
    frames = metadata['frames']
    if max_views:
        frames = frames[:max_views]

    imgs, poses = [], []
    for frame in frames:
        fpath = frame['file_path']
        if not os.path.splitext(fpath)[1]:
            fpath += '.png'
        with Image.open(os.path.join(root, fpath)) as img:
            if mip:
                img = img.resize((img.width // (2 ** mip),
                                  img.height // (2 ** mip)), Image.LANCZOS)
            imgs.append(np.asarray(img, np.float32) / 255.0)
        poses.append(np.asarray(frame['transform_matrix'], np.float32))
    imgs = np.stack(imgs)
    poses = np.stack(poses)
    h, w = imgs.shape[1:3]

    if 'x_fov' in metadata:
        fx = (0.5 * w) / np.tan(0.5 * float(metadata['x_fov']) * np.pi / 180.0)
        fy = ((0.5 * h) / np.tan(0.5 * float(metadata['y_fov']) * np.pi / 180.0)
              if 'y_fov' in metadata else fx)
    elif 'camera_angle_x' in metadata:
        fx = (0.5 * w) / np.tan(0.5 * float(metadata['camera_angle_x']))
        fy = ((0.5 * h) / np.tan(0.5 * float(metadata['camera_angle_y']))
              if 'camera_angle_y' in metadata else fx)
    else:
        raise ValueError('no focal information in transforms metadata')
    x0 = (float(metadata['cx']) / (2 ** mip) - w // 2) if 'cx' in metadata else 0.0
    y0 = (float(metadata['cy']) / (2 ** mip) - h // 2) if 'cy' in metadata else 0.0

    offset = np.asarray(metadata.get('offset', [0, 0, 0]), np.float32)
    scale = float(metadata.get('scale', 1.0))
    aabb_scale = float(metadata.get('aabb_scale', 1.25))
    poses[:, :3, 3] /= aabb_scale
    poses[:, :3, 3] *= scale
    poses[:, :3, 3] += offset

    rays = [pinhole_rays(pose, h, w, fx, fy, x0, y0) for pose in poses]
    rays_o = np.stack([r[0] for r in rays])
    rays_d = np.stack([r[1] for r in rays])

    rgbs = imgs[..., :3]
    if imgs.shape[-1] == 4:
        alpha = imgs[..., 3:4]
        masks = alpha > 0.5
        if bg_color == 'black':
            rgbs = np.clip(rgbs - (1 - alpha), 0.0, 1.0)
        else:
            rgbs = np.clip(rgbs * alpha + (1 - alpha), 0.0, 1.0)
    else:
        masks = np.ones_like(rgbs[..., 0:1], bool)
    return MultiviewData(
        rgb=rgbs.reshape(len(frames), -1, 3).astype(np.float32),
        rays_o=rays_o, rays_d=rays_d,
        masks=masks.reshape(len(frames), -1, 1), h=h, w=w)


class RaySampler:
    """Per-step random ray batches: one view, ``num_rays`` uniform pixels."""

    def __init__(self, data: MultiviewData, num_rays: int, seed: int = 0):
        self.data = data
        self.num_rays = num_rays
        self.rng = np.random.RandomState(seed)

    def sample(self):
        v = self.rng.randint(self.data.num_views)
        idx = self.rng.randint(0, self.data.rgb.shape[1], size=self.num_rays)
        return {'rgb': self.data.rgb[v, idx],
                'rays_o': self.data.rays_o[v, idx],
                'rays_d': self.data.rays_d[v, idx]}
