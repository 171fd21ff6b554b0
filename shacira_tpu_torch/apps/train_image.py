"""Image INR training app (PyTorch/CUDA).

Port of ``shacira_tpu/apps/train_image.py``: loads a directory of images and
trains one SHACIRA INR per image in turn, each in its own log directory
(``<log dir>/<exp name>/<image name>``) with ``metrics.json``,
``predicted.png`` (not with ``--metrics-only``), ``model_best.ckpt`` (the
validation best when validation ran, else the train-loss best) and
``resume_state.ckpt``; then the aggregate ``metrics.json`` and a
``complete`` marker.  ``--resume`` continues at the image index it reached
and from each image's resume state, ``--pretrained`` starts from a model
file, ``--profile`` writes a trace of each run, and ``--valid-only``
reloads each ``model_best.ckpt``, decodes the codebook once and reports
PSNR and the compressed size.

Usage:
    python -m shacira_tpu_torch.apps.train_image --config configs/kodak.yaml \
        --dataset-path DIR [--epochs N] [--device cpu]
"""
from __future__ import annotations

import json
import logging
import os
import sys

import numpy as np
import torch

from shacira_tpu_torch import config as cfg_mod
from shacira_tpu_torch.datasets.image import MultiImageDataset
from shacira_tpu_torch.ops.image import clamped_psnr
from shacira_tpu_torch.trainers.image_trainer import ImageTrainer
from shacira_tpu_torch.utils import checkpoint
from shacira_tpu_torch.utils.logging import ExperimentLogger
from shacira_tpu_torch.utils.perf import trace_to

log = logging.getLogger('shacira_tpu_torch')


def save_png(path: str, img01: np.ndarray) -> None:
    """An [H, W, 3] image in [0, 1] as an 8-bit PNG."""
    from PIL import Image
    arr = np.clip(img01 * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def build_trainer(args, ds, log_dir=None, logger=None,
                  mesh=None) -> ImageTrainer:
    """Trainer for parsed args on one image's dataset (data-parallel over
    ``mesh``, on its device, when given)."""
    return ImageTrainer(cfg_mod.build_image_trainer_config(args),
                        cfg_mod.build_image_model_config(args), ds,
                        seed=args.seed, log_dir=log_dir, logger=logger,
                        device=None if mesh is not None else args.device,
                        mesh=mesh)


def _load_params(trainer, path: str) -> dict:
    params = checkpoint.load_model(path, device=trainer.device)['params']
    checkpoint.check_like(params, trainer.params, path)
    return params


def train_one_image(args, ds, log_dir_cur: str, mesh=None, logger=None):
    """Train one image; with ``mesh`` (``parallel/mesh.py``) every rank
    calls this and rank 0 writes the files."""
    trainer = build_trainer(args, ds, log_dir_cur, logger, mesh)
    if args.pretrained:
        trainer.set_params(_load_params(trainer, args.pretrained),
                           trainer.opt_state)
        log.info('Loaded pretrained model from %s', args.pretrained)
    resume_path = os.path.join(log_dir_cur, 'resume_state.ckpt')
    if args.resume and os.path.exists(resume_path):
        checkpoint.restore_trainer(trainer, resume_path)
        log.info('Resumed image run at epoch %d', trainer.epoch)

    def log_entry(e):
        if 'valid_psnr' in e:
            log.info('epoch %d | valid PSNR %.2f (best %.2f)', e['epoch'],
                     e['valid_psnr'], e['best_val_psnr'])
        elif 'bpp' in e:
            log.info('epoch %d | PSNR %.2f | BPP %.3f | total %.2f kB | '
                     'loss %.3e', e['epoch'], e['psnr'], e['bpp'],
                     e['total_size_kb'], e['rgb_loss'])
        else:
            log.info('epoch %d | PSNR %.2f | loss %.3e', e['epoch'],
                     e.get('psnr', 0.0), e.get('rgb_loss', 0.0))

    remaining = trainer.cfg.epochs - trainer.epoch
    with trace_to(os.path.join(log_dir_cur, 'profile')
                  if args.profile else None):
        out = trainer.train(epochs=max(0, remaining), log_fn=log_entry)
    if not trainer.is_writer:
        return out
    if not args.metrics_only:
        save_png(os.path.join(log_dir_cur, 'predicted.png'),
                 trainer.render(trainer.best_params))
    best = (trainer.val_best_params if trainer.val_best_params is not None
            else trainer.best_params)
    checkpoint.save_model(os.path.join(log_dir_cur, 'model_best.ckpt'),
                          best, model_format=args.model_format,
                          configs={'model': trainer.model_cfg,
                                   'trainer': trainer.cfg})
    checkpoint.save_trainer(trainer, resume_path)
    return out


def validate_one_image(args, ds, log_dir_cur: str):
    """``--valid-only``: ``model_best.ckpt`` rendered with its codebook
    decoded once (the decoder swapped for the identity on the decoded
    table), its clamped PSNR and compressed size."""
    trainer = build_trainer(args, ds, log_dir_cur)
    params = _load_params(trainer,
                          os.path.join(log_dir_cur, 'model_best.ckpt'))
    pred = trainer.render(params)
    psnr = float(clamped_psnr(torch.as_tensor(pred.reshape(-1, 3)),
                              torch.as_tensor(ds.rgb)))
    report = trainer.size_report(use_codec=True, params=params)
    out = {'PSNR': psnr, 'BPP': report['bpp'], **report}
    with open(os.path.join(log_dir_cur, 'metrics.json'), 'w') as f:
        json.dump(out, f, indent=2)
    if not args.metrics_only:
        save_png(os.path.join(log_dir_cur, 'predicted.png'), pred)
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format='%(asctime)s | %(message)s')
    args = cfg_mod.parse_args(cfg_mod.build_image_parser(), argv)
    if not args.dataset_path:
        raise SystemExit('--dataset-path is required')
    if args.batch_size != 1:
        raise SystemExit('the image trainer uses batch size 1')

    log_dir = os.path.join(args.log_dir, args.exp_name)
    os.makedirs(log_dir, exist_ok=True)
    if not args.valid_only and os.path.exists(os.path.join(log_dir,
                                                           'complete')):
        log.info('Experiment already complete at %s, exiting', log_dir)
        return 0

    dataset = MultiImageDataset(args.dataset_path,
                                num_samples=args.num_samples,
                                sample_mode=args.sample_mode, seed=args.seed)
    log.info('Found %d images in %s', dataset.num_images, args.dataset_path)

    start_idx = 0
    resume_marker = os.path.join(log_dir, 'resume_image_idx.json')
    if args.resume and not args.valid_only and os.path.exists(resume_marker):
        with open(resume_marker) as f:
            start_idx = json.load(f)['image_idx']
        log.info('Resuming at image index %d', start_idx)
    dataset.image_idx = start_idx

    all_metrics = []
    while dataset.image_idx < dataset.num_images:
        idx = dataset.image_idx
        ds = dataset.load_next()
        name = os.path.splitext(os.path.basename(ds.image_path))[0]
        log_dir_cur = os.path.join(log_dir, name)
        os.makedirs(log_dir_cur, exist_ok=True)
        if args.valid_only:
            log.info('Evaluating image %d/%d: %s', idx + 1,
                     dataset.num_images, name)
            out = validate_one_image(args, ds, log_dir_cur)
        else:
            log.info('Training image %d/%d: %s (%dx%d)', idx + 1,
                     dataset.num_images, name, ds.h, ds.w)
            logger = ExperimentLogger(log_dir_cur,
                                      exp_name=f'{args.exp_name}/{name}')
            out = train_one_image(args, ds, log_dir_cur, logger=logger)
            logger.close()
        all_metrics.append(out)
        log.info('Image %s done: PSNR %.2f dB @ %.3f BPP', name, out['PSNR'],
                 out['BPP'])
        if args.resume and not args.valid_only:
            with open(resume_marker, 'w') as f:
                json.dump({'image_idx': dataset.image_idx}, f)

    agg = {k: float(np.mean([m[k] for m in all_metrics]))
           for k in ('PSNR', 'BPP', 'total_size_kb')}
    agg['num_images'] = len(all_metrics)
    with open(os.path.join(log_dir, 'metrics.json'), 'w') as f:
        json.dump({'average': agg, 'per_image': all_metrics}, f, indent=2)
    if not args.valid_only:
        open(os.path.join(log_dir, 'complete'), 'w').close()
    log.info('All done. avg PSNR %.2f dB @ %.3f BPP', agg['PSNR'], agg['BPP'])
    return 0


if __name__ == '__main__':
    sys.exit(main())
