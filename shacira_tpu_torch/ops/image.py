"""Image quality metrics.  Port of the PSNR of ``shacira_tpu/ops/image.py``;
SSIM waits for ROADMAP Queue A item 7b."""
from __future__ import annotations

import torch


def psnr(rgb: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Float PSNR of images in [0, 1]: ``10 log10(1 / mse)``."""
    mse = torch.mean((rgb[..., :3] - gts[..., :3]) ** 2)
    return 10.0 * torch.log10(1.0 / mse)
