"""Image quality metrics.

Port of ``shacira_tpu/ops/image.py``: float PSNR, clamped (uint8-quantized)
PSNR and MSE, and Gaussian-weighted SSIM.  Plain tensor ops on the images'
device (the JAX package computes them outside any Pallas kernel).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(rgb: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Float PSNR of images in [0, 1]: ``10 log10(1 / mse)``."""
    mse = torch.mean((rgb[..., :3] - gts[..., :3]) ** 2)
    return 10.0 * torch.log10(1.0 / mse)


def _uint8(img: torch.Tensor) -> torch.Tensor:
    # float -> uint8 truncates toward zero, as the JAX package's cast does
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def clamped_mse(rgb: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """MSE of the clamped, uint8-quantized images."""
    d = _uint8(rgb)[..., :3].float() - _uint8(gts)[..., :3].float()
    return torch.mean(d ** 2)


def clamped_psnr(rgb: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """PSNR after clamping and uint8 quantization:
    ``20 log10(255) - 10 log10(mse_uint8)``."""
    return 20.0 * np.log10(255.0) - 10.0 * torch.log10(clamped_mse(rgb, gts))


def _gaussian_taps(sigma: float = 1.5, truncate: float = 3.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)       # 5: 11 taps
    x = np.arange(2 * radius + 1) - radius
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(rgb: torch.Tensor, gts: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Gaussian-weighted SSIM (sigma 1.5, 11 taps, 'valid' filtering, the
    unbiased ``N / (N - 1)`` covariance), per channel, averaged: skimage's
    defaults.  ``rgb``, ``gts`` [H, W, C] in [0, 1]."""
    x = torch.as_tensor(rgb, dtype=torch.float32)
    y = torch.as_tensor(gts, dtype=torch.float32, device=x.device)
    g = torch.as_tensor(_gaussian_taps(), device=x.device)
    size = g.shape[0]
    kh, kw = g.view(1, 1, size, 1), g.view(1, 1, 1, size)

    def filt(img):               # separable, per channel: [H, W, C] -> [C, H', W']
        img = img.permute(2, 0, 1)[:, None]
        return F.conv2d(F.conv2d(img, kh), kw)[:, 0]

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x, mu_y = filt(x), filt(y)
    mu_xx, mu_yy, mu_xy = filt(x * x), filt(y * y), filt(x * y)
    cov_norm = size ** 2 / (size ** 2 - 1)
    vx = cov_norm * (mu_xx - mu_x * mu_x)
    vy = cov_norm * (mu_yy - mu_y * mu_y)
    vxy = cov_norm * (mu_xy - mu_x * mu_y)
    num = (2 * mu_x * mu_y + c1) * (2 * vxy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (vx + vy + c2)
    return torch.mean(num / den)


def mse(rgb: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    return torch.mean((rgb - gts) ** 2)
