"""NeRF training app (PyTorch/CUDA).

Port of ``shacira_tpu/apps/train_nerf.py`` without checkpointing, size
report and turntable (later slices): loads a Blender-synthetic scene,
trains with pruning, evaluates float PSNR on the held-out split and writes
``metrics.json``.

Usage:
    python -m shacira_tpu_torch.apps.train_nerf --config configs/nerf_lego.yaml \
        --dataset-path /data/nerf_synthetic/lego
"""
from __future__ import annotations

import json
import logging
import os
import sys

from shacira_tpu_torch import config as cfg_mod
from shacira_tpu_torch.datasets.nerf_synthetic import load_nerf_synthetic
from shacira_tpu_torch.trainers.multiview_trainer import MultiviewTrainer

log = logging.getLogger('shacira_tpu_torch')


def build_trainer(args, data, val_data=None) -> MultiviewTrainer:
    """Trainer for parsed args on loaded data."""
    return MultiviewTrainer(
        cfg_mod.build_nerf_trainer_config(args),
        cfg_mod.build_nerf_model_config(args),
        cfg_mod.build_tracer_config(args), data,
        num_rays=args.num_rays_sampled_per_img, seed=args.seed,
        device=args.device, val_dataset=val_data)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format='%(asctime)s | %(message)s')
    args = cfg_mod.parse_args(cfg_mod.build_nerf_parser(), argv)
    if not args.dataset_path:
        raise SystemExit('--dataset-path is required')
    if args.multiview_dataset_format != 'standard':
        raise NotImplementedError('RTMV data: ROADMAP Queue A item 11')
    log_dir = os.path.join(args.log_dir, args.exp_name)
    os.makedirs(log_dir, exist_ok=True)

    def load(split):
        return load_nerf_synthetic(args.dataset_path, split=split,
                                   bg_color=args.bg_color, mip=args.mip,
                                   max_views=args.max_views)

    data = load(args.dataset_split)
    log.info('Loaded %d %s views of %dx%d', data.num_views,
             args.dataset_split, data.h, data.w)
    try:
        val_data = load('val')
    except (FileNotFoundError, ValueError):
        val_data = None
        log.warning('No val split found; validating on the training split')

    trainer = build_trainer(args, data, val_data)
    if not args.valid_only:
        def log_entry(e):
            log.info(' | '.join(f'{k} {v:.4g}' if isinstance(v, float)
                                else f'{k} {v}' for k, v in e.items()))
        trainer.train(log_fn=log_entry)

    eval_data = val_data if val_data is not None else data
    metrics = trainer.evaluate(view_indices=range(eval_data.num_views),
                               dataset=eval_data)
    metrics['split'] = 'val' if val_data is not None else args.dataset_split
    metrics['num_eval_views'] = eval_data.num_views
    log.info('Validation (%s): PSNR %.2f', metrics['split'], metrics['psnr'])
    with open(os.path.join(log_dir, 'metrics.json'), 'w') as f:
        json.dump(metrics, f, indent=2)
    return 0


if __name__ == '__main__':
    sys.exit(main())
