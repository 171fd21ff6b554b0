"""SDF demo: NeuralSDF trained on an analytic composite scene.

Port of the JAX package's SDF drive, ``tools/run_sdf_demo.py``: the same
scene (the lego-like arrangement of boxes, spheres, a torus and cylinders
that the synthetic NeRF scenes render), surface points by rejection and
projection along the finite-difference gradient, a 200,000-point pool of
uniform and near-surface samples, the same grid and head (5 LODs of F = 4
at 2^12, res 8..64, 'cat', hidden 64, the raw position as input), batches
of 4096 in chunks of 100, the IoU over 8 batches and a 256 x 256
normal-shaded render.  Writes ``sdf_metrics.json`` (``iou``, ``iters``,
``wall_s``, ``config``) and ``sdf_normals.png`` into ``--out``.

Usage:
    python -m shacira_tpu_torch.apps.sdf_demo [--iters N] [--out DIR]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from shacira_tpu_torch.apps.train_image import save_png
from shacira_tpu_torch.datasets import sdf as sdf_ds
from shacira_tpu_torch.models.grids.latent_grid import LatentGridConfig
from shacira_tpu_torch.models.nefs.sdf import NeuralSDFConfig
from shacira_tpu_torch.trainers.sdf_trainer import SDFTrainer, SDFTrainerConfig

CONFIG = ('NGLOD-style: 5 LODs fd4 bw12 res 8..64, hidden 64, '
          'composite analytic scene, 4096-pt batches')


def scene_sdf(p: np.ndarray) -> np.ndarray:
    """Signed distance [N] f32 of the composite scene at p [N, 3] f32 (the
    distance part of ``tools/make_synthetic_data._scene_sdf``)."""
    def box(p, c, b):
        q = np.abs(p - c) - b
        return (np.linalg.norm(np.maximum(q, 0), axis=-1)
                + np.minimum(q.max(-1), 0.0))

    def sphere(p, c, r):
        return np.linalg.norm(p - c, axis=-1) - r

    def torus(p, c, R, r):
        q = p - c
        qx = np.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - R
        return np.sqrt(qx ** 2 + q[..., 1] ** 2) - r

    def cyl(p, c, r, hh):
        q = p - c
        d = np.stack([np.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - r,
                      np.abs(q[..., 1]) - hh], -1)
        return (np.minimum(np.maximum(d[..., 0], d[..., 1]), 0.0)
                + np.linalg.norm(np.maximum(d, 0), axis=-1))

    parts = [box(p, (0.0, -0.45, 0.0), (0.55, 0.08, 0.55)),
             box(p, (-0.25, -0.22, -0.2), (0.18, 0.14, 0.18)),
             box(p, (-0.25, 0.04, -0.2), (0.14, 0.12, 0.14)),
             sphere(p, (0.3, -0.1, 0.25), 0.22),
             torus(p, (0.25, 0.28, -0.25), 0.18, 0.06),
             cyl(p, (-0.3, 0.32, 0.3), 0.08, 0.2),
             cyl(p, (0.05, -0.2, 0.0), 0.05, 0.25),
             sphere(p, (-0.05, 0.45, 0.05), 0.12)]
    d = np.full(p.shape[:-1], 1e9, np.float32)
    for dist in parts:
        d = np.where(dist < d, dist, d)
    return d


def surface_points(seed: int = 0) -> np.ndarray:
    """Up to 20,000 points within 0.05 of the surface, projected onto it
    along the scene's central-difference gradient."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.8, 0.8, (200000, 3)).astype(np.float32)
    near = pts[np.abs(scene_sdf(pts)) < 0.05][:20000]
    eps = 1e-3
    grads = np.stack([(scene_sdf(near + e) - scene_sdf(near - e)) / (2 * eps)
                      for e in np.eye(3, dtype=np.float32) * eps], -1)
    grads /= np.maximum(np.linalg.norm(grads, axis=-1, keepdims=True), 1e-8)
    return near - grads * scene_sdf(near)[:, None]


def build_dataset(seed: int = 0) -> sdf_ds.SDFDataset:
    return sdf_ds.from_analytic(scene_sdf, num_samples=200000,
                                batch_size=4096,
                                surface_pts=surface_points(seed), seed=seed)


def model_config() -> NeuralSDFConfig:
    grid = LatentGridConfig.from_geometric(
        feature_dim=4, num_lods=5, min_grid_res=8, max_grid_res=64,
        latent_dim=0, multiscale_type='cat', resolution_dim=3,
        feature_std=0.01, codebook_bitwidth=12, init_grid='normal')
    return NeuralSDFConfig(grid=grid, hidden_dim=64, num_layers=1,
                           position_input=True)


def trainer_config() -> SDFTrainerConfig:
    return SDFTrainerConfig(epochs=100, chunk_size=100, lr=1e-3, grid_lr=2e-2)


def build_trainer(ds, seed: int = 0, device=None) -> SDFTrainer:
    return SDFTrainer(trainer_config(), model_config(), ds, seed=seed,
                      device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=2000)
    ap.add_argument('--out', type=str, default='_results/sdf_demo')
    ap.add_argument('--device', type=str, default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    tr = build_trainer(build_dataset(), device=args.device)
    t0 = time.time()
    tr.train(num_iterations=args.iters,
             log_fn=lambda e: print(e, flush=True))
    wall = time.time() - t0
    m = tr.validate(num_batches=8)
    img = tr.render(res=(256, 256), shading='normal')

    os.makedirs(args.out, exist_ok=True)
    out = {'iou': float(m['iou']), 'iters': args.iters,
           'wall_s': round(wall, 1), 'config': CONFIG}
    with open(os.path.join(args.out, 'sdf_metrics.json'), 'w') as f:
        json.dump(out, f, indent=2)
    save_png(os.path.join(args.out, 'sdf_normals.png'),
             np.clip(img * 0.5 + 0.5, 0, 1))
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
