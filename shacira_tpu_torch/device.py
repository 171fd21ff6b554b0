"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  With no GPU
and no explicit request the port raises instead of dropping quietly to the
CPU: a CPU run must be a deliberate choice (the tests make it).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the first CUDA device; raise when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run the '
                'port on the CPU')
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'{device} requested but CUDA is unavailable')
        # float32 matrix products (the head with AMP off, the affine decode)
        # stay true float32, not TF32, so they match the reference's sums
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
