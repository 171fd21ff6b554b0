"""Image processing: sRGB conversion, mip downsampling and RGBD
back-projection.

The port's copy of ``shacira_tpu/ops/image_processing.py`` (numpy, on the
host, like the datasets that use it).
"""
from __future__ import annotations

import numpy as np


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    """Linear RGB -> sRGB."""
    img = np.clip(img, 0.0, 1.0)
    return np.where(img <= 0.0031308, img * 12.92,
                    1.055 * np.power(img, 1 / 2.4) - 0.055)


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    img = np.clip(img, 0.0, 1.0)
    return np.where(img <= 0.04045, img / 12.92,
                    np.power((img + 0.055) / 1.055, 2.4))


def resize_mip(img: np.ndarray, mip: int) -> np.ndarray:
    """Box-filter downsample by 2**mip."""
    for _ in range(mip):
        h, w = img.shape[:2]
        h2, w2 = h // 2 * 2, w // 2 * 2
        img = img[:h2, :w2]
        img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                      + img[0::2, 1::2] + img[1::2, 1::2])
    return img


def rgbd_to_pointcloud(rgb: np.ndarray, depth: np.ndarray,
                       rays_o: np.ndarray, rays_d: np.ndarray,
                       max_depth: float = 1e6):
    """Back-project per-pixel depths along rays.

    Returns (points [M,3], colors [M,3]) for pixels with valid depth."""
    d = depth.reshape(-1)
    valid = (d > 0) & (d < max_depth) & np.isfinite(d)
    pts = (rays_o.reshape(-1, 3)[valid]
           + rays_d.reshape(-1, 3)[valid] * d[valid, None])
    return pts.astype(np.float32), rgb.reshape(-1, 3)[valid].astype(np.float32)
