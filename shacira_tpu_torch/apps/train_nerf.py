"""NeRF training app (PyTorch/CUDA).

Port of ``shacira_tpu/apps/train_nerf.py`` for every grid backbone
(``--grid-type``: LatentGrid, HashGrid, OctreeGrid, CodebookOctreeGrid,
TriplanarGrid) on Blender-format or RTMV data
(``--multiview-dataset-format rtmv``): loads a scene, trains with pruning
and periodic
validation and resume-state checkpoints (``--save-every``), optionally
under the profiler (``--profile``), saves ``resume_state.ckpt`` and
``model_best.ckpt``, evaluates PSNR, SSIM (and LPIPS with
``SHACIRA_LPIPS_WEIGHTS``) on every held-out view, adds the compressed size
report and writes ``metrics.json``, then ``val_view0.png`` and a 360-degree
``turntable.gif`` (not with ``--metrics-only``; ``--overlay-layers true``
draws the occupied cells and the axes over it).  ``--resume`` continues
from ``resume_state.ckpt``, ``--pretrained`` starts from a model file, and
``--valid-only`` evaluates ``model_best.ckpt`` without training.  An
``ExperimentLogger`` in the log directory takes the training scalars, the
validation records, the ``render/view0`` images of ``--render-tb-every``
and the final metrics.

Usage:
    python -m shacira_tpu_torch.apps.train_nerf --config configs/nerf_lego.yaml \
        --dataset-path /data/nerf_synthetic/lego
"""
from __future__ import annotations

import json
import logging
import os
import sys

import numpy as np
import torch

from shacira_tpu_torch import config as cfg_mod
from shacira_tpu_torch.core.primitives import axes_gizmo, occupancy_wireframe
from shacira_tpu_torch.datasets.nerf_synthetic import load_nerf_synthetic
from shacira_tpu_torch.datasets.rtmv import load_rtmv
from shacira_tpu_torch.render import offline
from shacira_tpu_torch.tracers import rf_tracer
from shacira_tpu_torch.trainers.multiview_trainer import MultiviewTrainer
from shacira_tpu_torch.utils import checkpoint
from shacira_tpu_torch.utils.logging import ExperimentLogger
from shacira_tpu_torch.utils.perf import trace_to

log = logging.getLogger('shacira_tpu_torch')


def build_trainer(args, data, val_data=None, log_dir=None,
                  logger=None, mesh=None) -> MultiviewTrainer:
    """Trainer for parsed args on loaded data (data-parallel over ``mesh``,
    on its device, when given)."""
    return MultiviewTrainer(
        cfg_mod.build_nerf_trainer_config(args),
        cfg_mod.build_nerf_model_config(args),
        cfg_mod.build_tracer_config(args), data,
        num_rays=args.num_rays_sampled_per_img, seed=args.seed,
        device=None if mesh is not None else args.device,
        val_dataset=val_data, log_dir=log_dir, logger=logger, mesh=mesh)


def _install_params(trainer, path: str):
    """The params of the model file ``path`` into ``trainer``."""
    params = checkpoint.load_model(path, device=trainer.device)['params']
    checkpoint.check_like(params, trainer.params, path)
    trainer.set_params(params, trainer.opt_state)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format='%(asctime)s | %(message)s')
    args = cfg_mod.parse_args(cfg_mod.build_nerf_parser(), argv)
    if not args.dataset_path:
        raise SystemExit('--dataset-path is required')
    log_dir = os.path.join(args.log_dir, args.exp_name)
    os.makedirs(log_dir, exist_ok=True)
    logger = ExperimentLogger(log_dir, exp_name=args.exp_name)
    try:
        return _run(args, log_dir, logger)
    finally:
        logger.close()


def _run(args, log_dir: str, logger: ExperimentLogger) -> int:
    """Train (or reload), evaluate and write the results of ``main``."""
    def load(split):
        if args.multiview_dataset_format == 'rtmv':
            return load_rtmv(args.dataset_path, split=split, mip=args.mip,
                             bg_color=args.bg_color, max_views=args.max_views)
        return load_nerf_synthetic(args.dataset_path, split=split,
                                   bg_color=args.bg_color, mip=args.mip,
                                   max_views=args.max_views)

    data = load(args.dataset_split)
    log.info('Loaded %d %s views of %dx%d', data.num_views,
             args.dataset_split, data.h, data.w)
    try:
        val_data = load('val')
        log.info('Loaded %d val views', val_data.num_views)
    except (FileNotFoundError, ValueError):
        val_data = None
        log.warning('No val split found; validating on the training split')

    trainer = build_trainer(args, data, val_data, log_dir, logger)
    if args.pretrained:
        _install_params(trainer, args.pretrained)
        log.info('Loaded pretrained model from %s', args.pretrained)
    resume_path = os.path.join(log_dir, 'resume_state.ckpt')
    if args.resume and os.path.exists(resume_path):
        checkpoint.restore_trainer(trainer, resume_path)
        log.info('Resumed at iteration %d', trainer.iteration)

    best_path = os.path.join(log_dir, 'model_best.ckpt')
    if not args.valid_only:
        def log_entry(e):
            log.info(' | '.join(f'{k} {v:.4g}' if isinstance(v, float)
                                else f'{k} {v}' for k, v in e.items()))

        with trace_to(os.path.join(log_dir, 'profile')
                      if args.profile else None):
            trainer.train(log_fn=log_entry)
        checkpoint.save_trainer(trainer, resume_path)
        best = (trainer.val_best_params if trainer.val_best_params is not None
                else trainer.params)
        checkpoint.save_model(
            best_path, best, model_format=args.model_format,
            configs={'model': trainer.model_cfg, 'tracer': trainer.tracer_cfg,
                     'trainer': trainer.cfg})
    elif os.path.exists(best_path):
        _install_params(trainer, best_path)
        log.info('valid-only: loaded model_best.ckpt')
    elif not args.pretrained:
        raise FileNotFoundError(
            f'--valid-only evaluates a trained model, and there is no '
            f'{best_path} and no --pretrained')

    # every view of the held-out split
    eval_data = val_data if val_data is not None else data
    val_views = list(range(eval_data.num_views))
    metrics = trainer.evaluate(view_indices=val_views, dataset=eval_data)
    metrics['split'] = 'val' if val_data is not None else args.dataset_split
    metrics['views'] = 'all'
    metrics['num_eval_views'] = len(val_views)
    metrics.update(trainer.size_report(use_codec=True))
    log.info('Validation (%s): PSNR %.2f | SSIM %.4f', metrics['split'],
             metrics['psnr'], metrics['ssim'])
    logger.record({'final': True, **metrics})
    with open(os.path.join(log_dir, 'metrics.json'), 'w') as f:
        json.dump(metrics, f, indent=2)

    if not args.metrics_only:
        offline.save_png(os.path.join(log_dir, 'val_view0.png'),
                         trainer.render_view(val_views[0], dataset=eval_data))
        offline.save_gif(render_turntable(trainer, args),
                         os.path.join(log_dir, 'turntable.gif'))
    return 0


def render_turntable(trainer, args, num_angles: int = None, res: int = None):
    """``num_angles`` frames of a 360-degree turntable (``res`` pixels
    square, default the dataset's size) around the trained field: the
    codebook decoded once (an alternative backbone in eval mode on the
    trainer's structure), the field traced in 16,384-ray batches with the
    trainer's tracer config, as the JAX app renders it.  With
    ``--overlay-layers`` each frame carries the wireframe of up to 2048
    occupied cells and the axes gizmo, depth-tested."""
    d = trainer.dataset
    if num_angles is None:
        num_angles = args.num_angles
    if res is None:
        res = args.turntable_res or max(d.h, d.w)
    cam = offline.CameraConfig(width=res, height=res, fov=30.0,
                               dist_min=float(d.dist_min),
                               dist_max=float(d.dist_max))
    tcfg = trainer.eval_tracer_cfg
    field_fn = trainer.eval_field_fn()

    def trace_fn(rays, generator: torch.Generator):
        return rf_tracer.trace(field_fn, trainer.occ_state,
                               trainer.model_cfg.occ_cfg, tcfg, rays,
                               generator)

    layers = None
    if args.overlay_layers:
        layers = {'occupancy': occupancy_wireframe(trainer.occ_state['occ'],
                                                   max_cells=2048),
                  'axes': axes_gizmo(0.5)}
    origin = np.asarray(args.camera_origin, np.float32)
    radius = float(np.linalg.norm(origin[[0, 2]]))
    return list(offline.turntable(trace_fn, cam, num_angles=num_angles,
                                  radius=radius, elevation=float(origin[1]),
                                  layers=layers, device=trainer.device))


if __name__ == '__main__':
    sys.exit(main())
