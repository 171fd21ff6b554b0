"""Object transforms: model matrices for scene objects.

The port's copy of ``shacira_tpu/core/transforms.py`` (numpy):
composable translate / rotate / scale producing 4x4 model matrices and
their inverses, plus point and ray transforms.
"""
from __future__ import annotations

import numpy as np


class ObjectTransform:
    def __init__(self, matrix: np.ndarray = None):
        self.m = np.eye(4, dtype=np.float32) if matrix is None else matrix

    def translate(self, t) -> 'ObjectTransform':
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = t
        return ObjectTransform(m @ self.m)

    def scale(self, s) -> 'ObjectTransform':
        m = np.diag(np.asarray([*(np.broadcast_to(s, (3,))), 1.0], np.float32))
        return ObjectTransform(m @ self.m)

    def rotate(self, axis: str, angle_rad: float) -> 'ObjectTransform':
        c, s = np.cos(angle_rad), np.sin(angle_rad)
        i, j = {'x': (1, 2), 'y': (0, 2), 'z': (0, 1)}[axis]
        m = np.eye(4, dtype=np.float32)
        m[i, i] = c
        m[j, j] = c
        m[i, j] = -s if axis != 'y' else s
        m[j, i] = s if axis != 'y' else -s
        return ObjectTransform(m @ self.m)

    def inverse(self) -> 'ObjectTransform':
        return ObjectTransform(np.linalg.inv(self.m).astype(np.float32))

    def apply_points(self, pts: np.ndarray) -> np.ndarray:
        return pts @ self.m[:3, :3].T + self.m[:3, 3]

    def apply_rays(self, origins: np.ndarray, dirs: np.ndarray):
        return (self.apply_points(origins), dirs @ self.m[:3, :3].T)
