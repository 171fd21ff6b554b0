"""RenderBuffer: multi-channel render output with blending.

Port of ``shacira_tpu/core/renderbuffer.py`` on tensors: a dict of
per-pixel channels (``[N, k]`` or ``[N]``) with per-channel blending
(``core/channel_fn.py``), concatenation and image export; ``save_exr``
writes through the port's codec (``ops/exr.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from shacira_tpu_torch.core import channel_fn as cf


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


@dataclass
class RenderBuffer:
    channels: Dict[str, torch.Tensor]

    def __getattr__(self, name):
        ch = object.__getattribute__(self, 'channels')
        if name in ch:
            return ch[name]
        raise AttributeError(name)

    @property
    def rgb(self):
        return self.channels.get('rgb')

    @property
    def alpha(self):
        return self.channels.get('alpha')

    def blend(self, other: 'RenderBuffer', kit=None) -> 'RenderBuffer':
        """Composite self (front) over other (back) with the per-channel
        blend kit: alpha-over for rgb, slerp for normals, logical-or for
        hit, front-wins for depth, linear for alpha.  A channel only one
        side has passes through."""
        kit = kit if kit is not None else cf.channels_starter_kit()
        a1, a2 = self.alpha, other.alpha
        out = {}
        for k in set(self.channels) | set(other.channels):
            x = self.channels.get(k)
            y = other.channels.get(k)
            if x is None:
                out[k] = y
            elif y is None:
                out[k] = x
            else:
                ch = kit.get(k, cf.create_default_channel())
                out[k] = ch.blend_fn(x, y, a1, a2)
        return RenderBuffer(out)

    def normalized(self, kit=None) -> 'RenderBuffer':
        """Every channel mapped to displayable [0, 1] by its normalize
        function."""
        kit = kit if kit is not None else cf.channels_starter_kit()
        return RenderBuffer({
            k: kit.get(k, cf.create_default_channel()).normalize_fn(v)
            for k, v in self.channels.items()})

    @staticmethod
    def cat(buffers) -> 'RenderBuffer':
        keys = buffers[0].channels.keys()
        return RenderBuffer({k: torch.cat([b.channels[k] for b in buffers])
                             for k in keys})

    def reshape_image(self, h: int, w: int) -> Dict[str, np.ndarray]:
        """Channels as host images: ``[N, k]`` -> ``[h, w, k]``, ``[N]`` ->
        ``[h, w]``."""
        out = {}
        for k, v in self.channels.items():
            v = _np(v)
            out[k] = v.reshape(h, w, v.shape[-1]) if v.ndim == 2 \
                else v.reshape(h, w)
        return out

    def image(self, h: int, w: int) -> np.ndarray:
        return _np(self.rgb).reshape(h, w, 3)

    def exr_dict(self, h: int, w: int) -> Dict[str, np.ndarray]:
        """Float32 channel dict for EXR export: every channel as
        ``[h, w, k]`` planes."""
        out = {}
        for k, v in self.channels.items():
            arr = _np(v).astype(np.float32)
            if arr.ndim == 1:
                arr = arr[:, None]
            out[k] = arr.reshape(h, w, arr.shape[-1])
        return out

    def save_exr(self, path: str, h: int, w: int) -> bool:
        """Write an EXR through ``ops/exr.py``: rgb as R, G, B, a 3-channel
        ``k`` as ``k.R/G/B``, others as ``k`` or ``k.i``; returns True."""
        from shacira_tpu_torch.ops.exr import write_exr
        planes = {}
        for k, v in self.exr_dict(h, w).items():
            if v.shape[-1] == 3:
                for i, suffix in enumerate('RGB'):
                    planes[f'{k}.{suffix}' if k != 'rgb' else suffix] = \
                        v[..., i]
            else:
                for i in range(v.shape[-1]):
                    planes[k if v.shape[-1] == 1 else f'{k}.{i}'] = v[..., i]
        write_exr(path, planes)
        return True
