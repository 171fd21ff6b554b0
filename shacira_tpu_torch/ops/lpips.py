"""LPIPS(VGG) perceptual metric.

Port of ``shacira_tpu/ops/lpips.py`` (the ``lpips`` package's
``LPIPS(net='vgg')`` computation):

    x, y in [0,1] HWC  ->  scaled to [-1,1]  ->  LPIPS channel-normalize
    -> VGG16 conv features after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
    -> unit-normalize each feature map across channels
    -> squared difference, 1x1 learned linear layer (non-negative weights)
    -> spatial mean, sum over the 5 layers.

Weights are bring-your-own: an ``.npz`` in the JAX package's layout (HWIO
conv kernels ``conv{i}_w``, biases ``conv{i}_b``, linear layers ``lin{l}``;
``shacira_tpu/ops/lpips.py::export_weights_npz`` says how one is made from
the ``lpips`` package), given as a path or by the ``SHACIRA_LPIPS_WEIGHTS``
variable.  :func:`load_lpips_weights` turns the conv kernels to OIHW for
``F.conv2d``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# LPIPS input scaling layer constants (lpips.ScalingLayer).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 feature config: conv channel widths per block ('M' = 2x2 maxpool).
_VGG16_CFG = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
              512, 512, 512, 'M', 512, 512, 512)
# Indices (into the conv list) after which LPIPS taps features:
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3.
_TAP_CONVS = (1, 3, 6, 9, 12)
_TAP_CHANNELS = (64, 128, 256, 512, 512)

ENV_VAR = 'SHACIRA_LPIPS_WEIGHTS'


def random_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights in the ``.npz`` layout (HWIO kernels), for tests: the
    JAX package's draws for the same seed."""
    rng = np.random.RandomState(seed)
    w = {}
    cin = 3
    i = 0
    for c in _VGG16_CFG:
        if c == 'M':
            continue
        w[f'conv{i}_w'] = (rng.randn(3, 3, cin, c)
                           / np.sqrt(9 * cin)).astype(np.float32)
        w[f'conv{i}_b'] = np.zeros(c, np.float32)
        cin = c
        i += 1
    for li, c in enumerate(_TAP_CHANNELS):
        w[f'lin{li}'] = rng.uniform(0, 1, (c,)).astype(np.float32)
    return w


def prepare_weights(raw: Dict[str, np.ndarray],
                    device='cpu') -> Dict[str, torch.Tensor]:
    """Weights in the ``.npz`` layout -> tensors on ``device``, the conv
    kernels turned from HWIO to OIHW."""
    out = {}
    for k, v in raw.items():
        v = np.asarray(v, np.float32)
        if k.endswith('_w'):
            v = v.transpose(3, 2, 0, 1)
        out[k] = torch.as_tensor(np.ascontiguousarray(v), device=device)
    return out


def load_lpips_weights(path: Optional[str] = None,
                       device='cpu') -> Dict[str, torch.Tensor]:
    """Load an LPIPS-VGG weight ``.npz`` (``path`` or the
    ``SHACIRA_LPIPS_WEIGHTS`` variable) onto ``device``; raise when there
    is none."""
    path = path or os.environ.get(ENV_VAR)
    if not path or not os.path.exists(path):
        raise RuntimeError(
            'LPIPS weights not found. Export them once with '
            'export_weights_npz() of the JAX package (shacira_tpu/ops/'
            'lpips.py) on a machine with torchvision+lpips installed, then '
            f'set {ENV_VAR}=/path/to/lpips_vgg.npz')
    with np.load(path) as data:
        return prepare_weights({k: data[k] for k in data.files}, device)


def _vgg_taps(weights: Dict[str, torch.Tensor], x: torch.Tensor):
    """VGG16 features of NCHW ``x``: the 5 LPIPS tap activations."""
    taps = []
    i = 0
    for c in _VGG16_CFG:
        if c == 'M':
            x = F.max_pool2d(x, 2, 2)
            continue
        x = torch.relu(F.conv2d(x, weights[f'conv{i}_w'],
                                weights[f'conv{i}_b'], padding=1))
        if i in _TAP_CONVS:
            taps.append(x)
        i += 1
    return taps


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)


@torch.no_grad()
def lpips(rgb, gts, weights: Optional[Dict[str, torch.Tensor]] = None
          ) -> float:
    """LPIPS(VGG) between two ``[H, W, 3]`` images in [0, 1] (mapped to
    [-1, 1] before the network), on the weights' device.  ``weights`` come
    from :func:`load_lpips_weights` or :func:`prepare_weights`; by default
    the ``SHACIRA_LPIPS_WEIGHTS`` file."""
    if weights is None:
        weights = load_lpips_weights()
    dev = weights['lin0'].device
    sh = torch.as_tensor(_SHIFT, device=dev).view(1, 3, 1, 1)
    sc = torch.as_tensor(_SCALE, device=dev).view(1, 3, 1, 1)

    def prep(img):
        img = torch.as_tensor(img, dtype=torch.float32, device=dev)
        return ((2.0 * img[..., :3] - 1.0).permute(2, 0, 1)[None] - sh) / sc

    fx, fy = _vgg_taps(weights, prep(rgb)), _vgg_taps(weights, prep(gts))
    total = torch.zeros((), device=dev)
    for li, (a, b) in enumerate(zip(fx, fy)):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2      # [1,C,H,W]
        lin = torch.clamp(weights[f'lin{li}'], min=0.0)         # 1x1, >= 0
        total = total + torch.mean(torch.sum(d * lin.view(1, -1, 1, 1),
                                             dim=1))
    return float(total)
