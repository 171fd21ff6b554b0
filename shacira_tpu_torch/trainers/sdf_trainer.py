"""SDF trainer: NeuralSDF fitted to a pool of signed distances.

Port of ``shacira_tpu/trainers/sdf_trainer.py``.  The JAX trainer runs
each chunk of ``chunk_size`` steps under ``lax.scan`` on batches drawn on
the host beforehand; here the same batches are drawn in the same order
from the dataset's ``RandomState``, copied to the device once a chunk
(pinned, without waiting), and one eager step follows another.  The step
reads nothing back: the host reads the chunk's last loss once, at its end.

The step: ``sum over the loss LODs of sum((pred - gt)^2) / N``, the
prediction at LOD ``l`` from the features of LODs ``<= l``; the grid's
backward is one launch of kernel B1 per loss LOD (``ops/hashgrid.py``);
Adam with the decoder at ``lr``, the grid at ``grid_lr`` and weight decay
``weight_decay`` on the grid.  The LOD-growth curriculum is chosen once a
chunk, from the epoch of the chunk's first step, as in the JAX package.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from shacira_tpu_torch import optim
from shacira_tpu_torch.accel import occupancy as occ
from shacira_tpu_torch.core.rays import make_rays
from shacira_tpu_torch.core.schedulers import grow_loss_lods
from shacira_tpu_torch.device import resolve_device
from shacira_tpu_torch.models.nefs.sdf import (
    NeuralSDFConfig, neural_sdf, neural_sdf_init)
from shacira_tpu_torch.ops.differential import autodiff_gradient
from shacira_tpu_torch.ops.sdf import compute_sdf_iou
from shacira_tpu_torch.render import offline, shaders
from shacira_tpu_torch.tracers import sdf_tracer


@dataclass
class SDFTrainerConfig:
    epochs: int = 10
    lr: float = 0.001
    grid_lr: float = 0.02
    weight_decay: float = 0.0
    optimizer_type: str = 'adam'
    loss_lods: Tuple[int, ...] = ()   # empty -> the finest LOD only
    grow_every: int = -1              # epochs between LOD-growth stages
    # 'onebyone' | 'increase' | 'shrink' | 'finetocoarse' | 'onlylast'
    growth_strategy: str = 'increase'
    chunk_size: int = 50
    log_every: int = 1


class SDFTrainer:
    def __init__(self, cfg: SDFTrainerConfig, model_cfg: NeuralSDFConfig,
                 dataset, seed: int = 0, device=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.set_params(neural_sdf_init(self.generator, model_cfg,
                                        self.device))
        self.iteration = 0
        num_lods = model_cfg.grid.num_lods
        self.loss_lods = (tuple(cfg.loss_lods) if cfg.loss_lods
                          else (num_lods - 1,))

    def set_params(self, params: dict, opt_state: Optional[dict] = None):
        """Install a parameter tree (and optionally an Adam state)."""
        self.labels = optim.label_params(params, optim.shacira_label_fn)
        for path, leaf in optim.tree_leaves_with_path(params):
            leaf.requires_grad_(self.labels[path] != 'frozen')
        self.params = params
        self.opt_state = (opt_state if opt_state is not None
                          else optim.adam_init(params))

    def _current_loss_lods(self) -> Tuple[int, ...]:
        """The loss LODs of the growth curriculum at the trainer's epoch."""
        cfg = self.cfg
        if cfg.grow_every <= 0:
            return self.loss_lods
        epoch = self.iteration // max(1, len(self.dataset))
        return tuple(grow_loss_lods(epoch, self.model_cfg.grid.num_lods,
                                    cfg.grow_every, cfg.growth_strategy))

    def lod_masks(self, loss_lods) -> torch.Tensor:
        """[len(loss_lods), num_lods] f32: LOD ``l``'s mask keeps the
        features of LODs ``<= l``; built on the device (a copy from the
        host would wait for the stream)."""
        ar = torch.arange(self.model_cfg.grid.num_lods, device=self.device)
        return torch.stack([(ar <= l).float() for l in loss_lods])

    def loss(self, params: dict, coords: torch.Tensor, gts: torch.Tensor,
             masks: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for m in masks:
            pred = neural_sdf(params, self.model_cfg, coords, lod_mask=m)
            total = total + torch.sum((pred - gts) ** 2)
        return total / coords.shape[0]

    def step(self, coords: torch.Tensor, gts: torch.Tensor,
             masks: torch.Tensor) -> torch.Tensor:
        """One training step in place on ``params`` / ``opt_state``;
        returns the loss (on the device)."""
        cfg = self.cfg
        trained = [(path, leaf) for path, leaf
                   in optim.tree_leaves_with_path(self.params)
                   if leaf.requires_grad]
        loss = self.loss(self.params, coords, gts, masks)
        grads = torch.autograd.grad(loss, [leaf for _, leaf in trained],
                                    allow_unused=True)
        lrs = {'decoder': cfg.lr, 'grid': cfg.grid_lr, 'latent_dec': cfg.lr,
               'prob_models': 1e-4, 'rest': cfg.lr}
        with record_function('step/adam'):
            optim.adam_update(
                {path: g for (path, _), g in zip(trained, grads)},
                self.opt_state, self.params, self.labels, lrs,
                {'grid': cfg.weight_decay})
        return loss.detach()

    def draw_chunk(self, n: int):
        """``n`` batches from the dataset, in order: coords [n, B, 3] and
        sdf [n, B, 1] on the device, one copy each."""
        bs = self.dataset.batch_size
        coords = np.empty((n, bs, 3), np.float32)
        sdfs = np.empty((n, bs, 1), np.float32)
        for i in range(n):
            coords[i], sdfs[i] = self.dataset.batch()

        def upload(a):
            t = torch.from_numpy(a)
            if self.device.type == 'cuda':
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)
        return upload(coords), upload(sdfs)

    def train(self, num_iterations: Optional[int] = None, log_fn=None):
        """Train ``num_iterations`` steps (default: ``epochs`` over the
        dataset) in chunks of ``chunk_size``; ``log_fn`` gets the chunk's
        last loss after each chunk."""
        cfg = self.cfg
        total = (num_iterations if num_iterations is not None
                 else cfg.epochs * len(self.dataset))
        t0 = time.time()
        done = 0
        while done < total:
            n = min(cfg.chunk_size, total - done)
            coords, sdfs = self.draw_chunk(n)
            masks = self.lod_masks(self._current_loss_lods())
            for i in range(n):
                loss = self.step(coords[i], sdfs[i], masks)
            self.iteration += n
            done += n
            if log_fn:
                log_fn({'iteration': self.iteration,
                        'l2_loss': float(loss),
                        'elapsed': time.time() - t0})
        return {'iterations': self.iteration}

    @torch.no_grad()
    def render(self, camera_origin=(-1.8, 1.2, -1.8), res=(256, 256),
               shading: str = 'normal', matcap=None,
               point_light=(1.5, 4.0, 1.5), min_y: float = -1.0,
               num_steps: int = 128) -> np.ndarray:
        """Sphere-trace a lookat view of the field: 'normal' shading,
        'matcap' (needs a texture, ``shaders.load_matcap``) or 'shadow' (a
        ground plane at ``min_y`` and shadow rays toward ``point_light``).
        Returns [H, W, 3] float32."""
        mcfg = self.model_cfg
        # the render needs no parameter gradient
        params = optim.tree_map(torch.Tensor.detach, self.params)
        h, w = res
        cam = offline.CameraConfig(width=w, height=h)
        ro, rd = offline.lookat_rays(camera_origin, (0.0, 0.0, 0.0), cam)
        rays = make_rays(torch.as_tensor(ro, device=self.device),
                         torch.as_tensor(rd, device=self.device),
                         cam.dist_min, cam.dist_max)
        ocfg = occ.OccupancyGridConfig(level=4)
        ostate = occ.occupancy_init(ocfg, self.device, occupied=True)
        tcfg = sdf_tracer.SDFTracerConfig(num_steps=num_steps)

        def sdf_fn(c):
            return neural_sdf(params, mcfg, c)

        rb = sdf_tracer.trace(sdf_fn, ostate, ocfg, tcfg, rays)
        rb = sdf_tracer.shade_normals(
            lambda x: autodiff_gradient(sdf_fn, x), rb)
        if shading == 'matcap':
            if matcap is None:
                raise ValueError('matcap shading needs a texture '
                                 '(shaders.load_matcap)')
            rb = shaders.matcap_shader(rb, rays, matcap)
            rb['rgb'] = rb['rgb'] * rb['alpha']
        elif shading == 'shadow':
            rb = shaders.shadow_shader(
                rb, rays,
                lambda sr: sdf_tracer.trace(sdf_fn, ostate, ocfg, tcfg,
                                            sr)['hit'],
                point_light, min_y=min_y, image_shape=(h, w))
        elif shading != 'normal':
            raise ValueError(shading)
        return rb['rgb'].reshape(h, w, 3).cpu().numpy()

    @torch.no_grad()
    def validate(self, num_batches: int = 4) -> Dict[str, float]:
        """Mean sign IoU over ``num_batches`` fresh batches of the pool
        (drawn from the dataset's generator, as training draws)."""
        ious = []
        for _ in range(num_batches):
            coords, gts = self.dataset.batch()
            pred = neural_sdf(self.params, self.model_cfg,
                              torch.as_tensor(coords, device=self.device))
            ious.append(compute_sdf_iou(pred, gts))
        return {'iou': float(np.mean(ious))}
