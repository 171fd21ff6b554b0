"""RandomViewDataset: random spherical cameras (synthetic views).

Port of ``shacira_tpu/datasets/random_view.py``: camera positions drawn
uniformly on a sphere (from ``np.random.RandomState(seed)``, so the views
equal the JAX package's), each looking at the origin, with its rays; no
ground-truth pixels.
"""
from __future__ import annotations

import numpy as np

from shacira_tpu_torch.render.offline import CameraConfig, lookat_rays


class RandomViewDataset:
    def __init__(self, num_views: int = 8, radius: float = 3.0,
                 camera: CameraConfig = CameraConfig(), seed: int = 0):
        self.num_views = num_views
        self.radius = radius
        self.camera = camera
        self.rng = np.random.RandomState(seed)

    def sample_view(self):
        """(rays_o [H*W, 3], rays_d [H*W, 3], origin) of one random view."""
        v = self.rng.randn(3)
        v /= np.linalg.norm(v)
        origin = v * self.radius
        ro, rd = lookat_rays(origin, [0, 0, 0], self.camera)
        return ro, rd, origin

    def __iter__(self):
        for _ in range(self.num_views):
            yield self.sample_view()
