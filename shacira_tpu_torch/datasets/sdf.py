"""SDF training datasets.

Port of ``shacira_tpu/datasets/sdf.py``: pools of (coords, sdf) samples
drawn as a mix of surface / near-surface / uniform points, from an
analytic SDF, a triangle mesh or a mesh's narrowband octree, and batches
drawn from the pool.  Host-side numpy with the JAX package's draws in the
same order from one ``np.random.RandomState``, so a seed gives the same
pool and the same batches.  The narrowband filter runs the port's octree
(``ops/spc.py``) on CPU tensors, which keeps exactly the points the JAX
package keeps.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from shacira_tpu_torch.ops import mesh as mesh_ops
from shacira_tpu_torch.ops import sdf as sdf_ops
from shacira_tpu_torch.ops import spc


class SDFDataset:
    """Pool of SDF samples with batch draws.  ``num_samples`` keeps the
    whole (coords, sdf) pool and makes :meth:`resample` subsample a working
    set of that size; batches draw from the working set."""

    def __init__(self, coords: np.ndarray, sdf: np.ndarray, batch_size: int,
                 seed: int = 0, num_samples: Optional[int] = None):
        self.pool_coords = np.asarray(coords, np.float32)
        self.pool_sdf = np.asarray(sdf, np.float32).reshape(-1, 1)
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.rng = np.random.RandomState(seed)
        self.resample()

    @property
    def pool_size(self) -> int:
        return len(self.pool_coords)

    def resample(self) -> None:
        """Draw a fresh working set from the pool."""
        if self.num_samples is None or self.num_samples >= self.pool_size:
            self.coords, self.sdf = self.pool_coords, self.pool_sdf
            return
        idx = self.rng.permutation(self.pool_size)[:self.num_samples]
        self.coords, self.sdf = self.pool_coords[idx], self.pool_sdf[idx]

    def __len__(self):
        return max(1, len(self.coords) // self.batch_size)

    def batch(self, _i=None) -> Tuple[np.ndarray, np.ndarray]:
        """``batch_size`` rows drawn with replacement: coords [B, 3], sdf
        [B, 1]."""
        idx = self.rng.randint(0, len(self.coords), self.batch_size)
        return self.coords[idx], self.sdf[idx]


def from_analytic(sdf_fn: Callable[[np.ndarray], np.ndarray],
                  num_samples: int = 100000, batch_size: int = 4096,
                  modes: Sequence[str] = ('rand', 'near', 'near'),
                  surface_pts: Optional[np.ndarray] = None,
                  seed: int = 0) -> SDFDataset:
    """Pool of an analytic SDF: per mode ``num_samples // len(modes)``
    uniform points ('rand') or perturbations of ``surface_pts`` (of uniform
    points without them; 'near', 'trace'), clipped to [-1, 1]."""
    rng = np.random.RandomState(seed)
    pts = []
    per = num_samples // len(modes)
    for mode in modes:
        if mode == 'rand':
            pts.append(sdf_ops.sample_uniform(rng, per))
        elif mode in ('near', 'trace'):
            base = (surface_pts if surface_pts is not None
                    else sdf_ops.sample_uniform(rng, per))
            pts.append(sdf_ops.sample_near_surface(rng, base, per))
        else:
            raise ValueError(mode)
    coords = np.clip(np.concatenate(pts), -1, 1)
    return SDFDataset(coords, sdf_fn(coords), batch_size, seed)


def _mesh_arrays(path_or_arrays):
    if isinstance(path_or_arrays, str):
        return mesh_ops.load_obj(path_or_arrays)
    return path_or_arrays


def from_mesh(path_or_arrays, num_samples: int = 100000,
              batch_size: int = 4096,
              modes: Sequence[str] = ('rand', 'near', 'near', 'trace',
                                      'trace'),
              seed: int = 0) -> SDFDataset:
    """Pool of a triangle mesh (an OBJ path or (verts, faces)), normalized
    into the unit sphere: uniform points and perturbed surface samples,
    their distances from :func:`ops.mesh.points_to_sdf`."""
    verts, faces = _mesh_arrays(path_or_arrays)
    verts = mesh_ops.normalize_mesh(verts)
    rng = np.random.RandomState(seed)
    per = num_samples // len(modes)
    pts = []
    for mode in modes:
        if mode == 'rand':
            pts.append(sdf_ops.sample_uniform(rng, per))
        elif mode in ('near', 'trace'):
            surf = mesh_ops.sample_surface(rng, verts, faces, per)
            pts.append(np.clip(
                sdf_ops.sample_near_surface(rng, surf, per), -1, 1))
        else:
            raise ValueError(mode)
    coords = np.concatenate(pts)
    sdf = mesh_ops.points_to_sdf(coords, verts, faces)
    return SDFDataset(coords, sdf, batch_size, seed)


def from_octree_narrowband(path_or_arrays, level: int = 6,
                           samples_per_voxel: int = 32,
                           num_samples: Optional[int] = 100000,
                           batch_size: int = 4096,
                           modes: Sequence[str] = ('rand', 'rand', 'near',
                                                   'near', 'trace'),
                           seed: int = 0) -> SDFDataset:
    """Narrowband pool of a mesh: its surface quantized into a sparse
    octree at ``level``; 'rand' draws ``samples_per_voxel`` uniform points
    in each occupied leaf, 'near' / 'trace' surface samples (perturbed by
    N(0, 1/res) for 'near'); every candidate in an empty cell is dropped.
    :meth:`SDFDataset.resample` subsamples ``num_samples`` of the pool."""
    verts, faces = _mesh_arrays(path_or_arrays)
    verts = mesh_ops.normalize_mesh(verts)
    rng = np.random.RandomState(seed)
    surf = mesh_ops.sample_surface(rng, verts, faces, max(20000, 8 ** level))
    octree = spc.Octree.from_pointcloud(torch.from_numpy(surf), level)
    corners = octree.points(level).numpy()               # [M, 3] int64
    res = 2 ** level

    pts = []
    n_rand = None
    for mode in modes:
        if mode == 'rand':
            u = rng.rand(len(corners), samples_per_voxel, 3)
            p = (corners[:, None, :] + u) / res * 2.0 - 1.0
            p = p.reshape(-1, 3).astype(np.float32)
            pts.append(p)
            n_rand = len(p)
        elif mode in ('near', 'trace'):
            n = n_rand or samples_per_voxel * max(1, len(corners))
            s = mesh_ops.sample_surface(rng, verts, faces, n)
            if mode == 'near':
                s = s + rng.randn(*s.shape).astype(np.float32) / res
            pts.append(np.clip(s, -1, 1).astype(np.float32))
        else:
            raise ValueError(mode)
    coords = np.concatenate(pts)
    cells = spc.quantize_points(torch.from_numpy(coords), level)
    hit = spc.query_cells(octree.level_codes[level], cells) >= 0
    coords = coords[hit.numpy()]
    sdf = mesh_ops.points_to_sdf(coords, verts, faces)
    return SDFDataset(coords, sdf, batch_size, seed, num_samples=num_samples)
