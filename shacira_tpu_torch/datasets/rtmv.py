"""RTMV dataset (EXR RGB-D multiview).

Port of ``shacira_tpu/datasets/rtmv.py`` (host-side numpy): ``NNNNN.exr``
images with a ray-distance depth channel and ``NNNNN.json`` cameras, split
train / val / test by ratio, the scene normalized by the depth point
cloud's center and scale (camera-sphere fallback without depth), ray
distance bounds that cover the unit cube from every camera, and the depth
point cloud (at most 500,000 points, subsampled with seed 0) for seeding
the occupancy grid.  The normalization frame always comes from the train
files, so every split shares one coordinate system.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from shacira_tpu_torch.datasets.nerf_synthetic import (
    MultiviewData, pinhole_rays)

TRAIN_RATIO, VAL_RATIO = 0.7, 0.15
MAX_POINTS = 500000


def _read_exr(path: str) -> np.ndarray:
    """[H, W, C] float32: the native codec (``ops/exr.py``: uncompressed
    files), then cv2 (with OPENCV_IO_ENABLE_OPENEXR), then imageio, each
    imported only when the one before it cannot read the file."""
    try:
        from shacira_tpu_torch.ops.exr import read_exr_rgba
        return read_exr_rgba(path)
    except Exception:
        pass    # compressed or exotic layout: try cv2, then imageio
    os.environ.setdefault('OPENCV_IO_ENABLE_OPENEXR', '1')
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH)
        if img is not None:
            if img.ndim == 3 and img.shape[-1] >= 3:
                img[..., :3] = img[..., 2::-1]  # BGR -> RGB
            return np.asarray(img, np.float32)
    except Exception:
        pass
    import imageio.v2 as imageio
    return np.asarray(imageio.imread(path), np.float32)


def load_rtmv(root: str, split: str = 'train', mip: int = 0,
              bg_color: str = 'white',
              max_views: Optional[int] = None) -> MultiviewData:
    """Load split ``split`` of the RTMV scene under ``root``."""
    files = sorted(f[:-4] for f in os.listdir(root) if f.endswith('.exr'))
    n = len(files)
    if n == 0:
        raise FileNotFoundError(f'no .exr views under {root}')
    n_train = int(n * TRAIN_RATIO)
    n_val = int(n * VAL_RATIO)
    sel = {'train': files[:n_train],
           'val': files[n_train:n_train + n_val],
           'test': files[n_train + n_val:]}[split]
    if max_views:
        sel = sel[:max_views]

    def load_view(base):
        img = _read_exr(os.path.join(root, base + '.exr'))
        with open(os.path.join(root, base + '.json')) as f:
            cam = json.load(f)['camera_data']
        pose = np.asarray(cam['cam2world'], np.float32).T
        if mip:
            step = 2 ** mip
            img = img[::step, ::step]
        rgba = img[..., :4] if img.shape[-1] >= 4 else img[..., :3]
        depth = img[..., -1] if img.shape[-1] >= 5 else None
        return rgba, depth, pose, cam['intrinsics']

    imgs, depths, poses, intr = [], [], [], None
    for base in sel:
        rgba, depth, pose, intr = load_view(base)
        imgs.append(rgba)
        depths.append(depth)
        poses.append(pose)
    imgs = np.stack(imgs)
    poses = np.stack(poses)
    h, w = imgs.shape[1:3]
    s = 1.0 / (2 ** mip)
    fx, fy = intr['fx'] * s, intr['fy'] * s
    x0 = intr['cx'] * s - w // 2
    y0 = intr['cy'] * s - h // 2

    # directions before the normalization, which moves only the cameras
    dirs_all = [pinhole_rays(pose, h, w, fx, fy, x0, y0)[1] for pose in poses]

    def view_pointcloud(img_v, depth_v, pose_v, dirs_v):
        if depth_v is None:
            return None
        alpha_ok = (img_v[..., 3] > 0.5) if img_v.shape[-1] >= 4 \
            else np.ones(img_v.shape[:2], bool)
        hit = (alpha_ok & (depth_v > 0) & np.isfinite(depth_v)).reshape(-1)
        if not hit.any():
            return None
        if dirs_v is None:
            dirs_v = pinhole_rays(pose_v, h, w, fx, fy, x0, y0)[1]
        t = depth_v.reshape(-1)[hit]
        return pose_v[:3, 3][None, :] + dirs_v[hit] * t[:, None]

    # the frame comes from the train files, loaded here if not selected
    cache = {b: i for i, b in enumerate(sel)}
    frame_files = files[:n_train] if n_train else files
    pc, frame_cams = [], []
    for base in frame_files:
        if base in cache:
            i = cache[base]
            img_v, depth_v, pose_v, dirs_v = (imgs[i], depths[i], poses[i],
                                              dirs_all[i])
        else:
            img_v, depth_v, pose_v, _ = load_view(base)
            dirs_v = None
        frame_cams.append(pose_v[:3, 3])
        p = view_pointcloud(img_v, depth_v, pose_v, dirs_v)
        if p is not None:
            pc.append(p)
    pointcloud = None
    if pc:
        points = np.concatenate(pc, axis=0)
        center = points.mean(axis=0)
        scale = np.abs(points - center).max() / 0.9   # content within +-0.9
        pointcloud = ((points - center) / scale).astype(np.float32)
        if pointcloud.shape[0] > MAX_POINTS:
            keep = np.random.RandomState(0).choice(
                pointcloud.shape[0], MAX_POINTS, replace=False)
            pointcloud = pointcloud[keep]
    else:
        centers = np.stack(frame_cams)
        center = centers.mean(axis=0)
        scale = np.abs(centers - center).max() / 2.0
    poses[:, :3, 3] = (poses[:, :3, 3] - center) / scale

    # ray bounds covering the unit cube from every camera
    cam_r = np.linalg.norm(poses[:, :3, 3], axis=-1)
    margin = float(np.sqrt(3.0))
    dist_min = max(0.0, float(cam_r.min()) - margin)
    dist_max = float(cam_r.max()) + margin

    rays_o = np.stack([np.broadcast_to(pose[:3, 3], (h * w, 3))
                       for pose in poses]).astype(np.float32)
    rays_d = np.stack(dirs_all)
    rgbs = np.clip(imgs[..., :3], 0.0, 1.0)
    if imgs.shape[-1] >= 4:
        alpha = np.clip(imgs[..., 3:4], 0.0, 1.0)
        masks = alpha > 0.5
        if bg_color == 'white':
            rgbs = np.clip(rgbs * alpha + (1 - alpha), 0.0, 1.0)
    else:
        masks = np.ones_like(rgbs[..., :1], bool)
    return MultiviewData(
        rgb=rgbs.reshape(len(sel), -1, 3).astype(np.float32),
        rays_o=rays_o, rays_d=rays_d,
        masks=masks.reshape(len(sel), -1, 1), h=h, w=w,
        dist_min=dist_min, dist_max=dist_max, pointcloud=pointcloud,
        norm_center=np.asarray(center, np.float32),
        norm_scale=float(scale))
