"""Traffic kind ``photo``: one ``h`` x ``w`` kodak-like photo, 8-bit, from
the repository's ``tools/make_synthetic_data.py`` (``synth_photo``),
copied."""
from __future__ import annotations

import numpy as np


def _value_noise(rng, h, w, cells):
    g = rng.rand(cells + 1, cells + 1)
    ys = np.linspace(0, cells, h, endpoint=False)
    xs = np.linspace(0, cells, w, endpoint=False)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    fy = fy * fy * (3 - 2 * fy)
    fx = fx * fx * (3 - 2 * fx)
    a = g[np.ix_(y0, x0)]
    b = g[np.ix_(y0, x0 + 1)]
    c = g[np.ix_(y0 + 1, x0)]
    d = g[np.ix_(y0 + 1, x0 + 1)]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy


def synth_photo(h: int, w: int, seed: int) -> np.ndarray:
    """Kodak-like broadband image in [0, 1], float32 [h, w, 3]: 1/f value
    noise, an illumination gradient, hard-edged discs and bars, fine
    texture."""
    rng = np.random.RandomState(seed % 2 ** 32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w))
        amp = 1.0
        for octv in (4, 8, 16, 32, 64, 128):
            acc += amp * _value_noise(rng, h, w, octv)
            amp *= 0.55
        img[..., c] = acc / acc.max()
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing='ij')
    img *= (0.6 + 0.4 * np.cos(np.pi * (xx * 0.7 + yy * 0.3)))[..., None]
    for _ in range(24):
        cy, cx = rng.rand(2) * [h, w]
        r = rng.rand() * 0.08 * min(h, w) + 4
        col = rng.rand(3) * 0.9 + 0.05
        mask = (yy * h - cy) ** 2 + (xx * w - cx) ** 2 < r * r
        img[mask] = 0.65 * img[mask] + 0.35 * col
    for _ in range(16):
        ang = rng.rand() * np.pi
        d = np.cos(ang) * (xx - rng.rand()) + np.sin(ang) * (yy - rng.rand())
        mask = np.abs(d) < rng.rand() * 0.01 + 0.002
        img[mask] = 1.0 - img[mask]
    img += (rng.rand(h, w, 1) - 0.5) * 0.04
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def make(t: dict, seed: int, device) -> np.ndarray:
    img = synth_photo(int(t['h']), int(t['w']), seed)
    return (np.round(img * 255.0) / 255.0).astype(np.float32)
