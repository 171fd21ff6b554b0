"""Image INR trainer: one SHACIRA image per trainer, on one device or
data-parallel.

Port of ``shacira_tpu/trainers/image_trainer.py``.  The JAX trainer runs
chunks of steps under ``lax.scan``; here a Python loop runs one eager step
after another over the same chunk boundaries (``chunk_size`` capped by
``log_every``, the SGA -> STE flip, the validation, checkpoint and render
epochs), with the schedules computed on the host per chunk.

The step (:meth:`ImageTrainer.step`), as in the JAX package:
  * ``div`` recalibrated from the latents on ``do_recalib`` (single
    decoder, ``norm != 'none'``);
  * the rate-loss noise replaced on refresh steps (a host flag of the
    schedule, so the step has no device branch);
  * SGA or STE decode: the single affine decoder through ``affine_parts``
    and ``hash_encode_affine``, other decoders through the decoded table
    and ``hash_encode``; either way the hash backward is kernel B1;
  * loss = ``rgb_loss_weight`` * MSE + entropy lambda * bits per latent;
  * Adam or AdamW over the five groups (grid lr divided or multiplied by the
    decoder's scale norm for the single decoder only, prob model at 1e-4);
  * clamped PSNR, and the lowest-loss state kept on the device.

Full-image mode feeds the pixel lattice in row-major order (the order the
JAX package's lattice path computes in; the loss is a mean, so the order
does not change it).  The sampled modes keep the image on the device
(uint8 with an exact 256-entry dequantization table where the image is
8-bit) and draw each step's pixels there: 'wreplace' from the trainer's
``torch.Generator``, 'woreplace' / 'sequential' as a slice of the
on-device permutation whose start is clamped so a tail batch overlaps the
one before it, 'eval' as the raster batch with its tail padded from its
head.  'woreplace' draws a new permutation once an epoch with
``resample``.  Iterations and epochs count from the trainer's own epoch,
so a resumed sampled run continues its schedules.

Data parallelism (``mesh=``, ``parallel/mesh.py``): the parameters are
replicated from rank 0; full-image mode gives each rank its rows of the
lattice (the pixel count must divide n), the sampled modes draw the global
batch on every rank from the same generator or permutation and keep the
rank's part; gradients are averaged over the ranks; the metrics, and
with them the best state, are the whole batch's on every rank, and
``recalibrate_div`` reads the replicated codebook, so every rank makes the
same choices.  Every rank validates and renders, as one trainer would;
only rank 0 logs and writes files.  Without a mesh the trainer runs on a
one-rank mesh (``parallel/mesh.local_mesh``), whose collectives do
nothing.

Every random draw of a step (SGA uniforms, rate-loss noise, 'wreplace'
pixels) is an :class:`ImageStepDraws` argument of :meth:`step`; the trainer
draws them in :meth:`draw_step`.  The step reads nothing back to the host:
the best state is updated with ``torch.where`` into buffers on the device,
and the host reads metrics only at log points, validation, saves and
:meth:`finalize`.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from shacira_tpu_torch import optim
from shacira_tpu_torch.core.schedulers import DecayScheduler, grow_loss_lods
from shacira_tpu_torch.datasets.image import pixel_coords
from shacira_tpu_torch.device import resolve_device
from shacira_tpu_torch.models.grids import latent_grid as lg
from shacira_tpu_torch.models.latent_decoders import (
    recalibrate_div, scale_norm, sga_uniform)
from shacira_tpu_torch.models.nefs.image import (
    NeuralImageConfig, neural_image_init, neural_image_rgb,
    non_grid_size_bits)
from shacira_tpu_torch.ops.image import clamped_mse, clamped_psnr
from shacira_tpu_torch.parallel import mesh as pmesh
from shacira_tpu_torch.utils import checkpoint


@dataclass
class ImageTrainerConfig:
    epochs: int = 60000
    rgb_loss_weight: float = 1.0
    optimizer_type: str = 'adam'      # 'adam' | 'adamw'
    lr: float = 0.001
    grid_lr: float = 0.02
    ldec_lr: float = 0.01
    scale_grid_lr: str = 'none'       # 'none' | 'mul' | 'div'
    weight_decay: float = 0.0
    weight_decay_decoder: float = 0.01
    ldec_lr_warmup: int = 10
    use_sga: bool = False
    decay_period: float = 0.9
    temperature: float = 0.1
    norm: str = 'none'
    norm_every: int = 10
    entropy_reg: float = 0.0
    entropy_reg_end: float = 0.0
    entropy_reg_sched: str = 'cosine'
    noise_freq: int = 1
    resample: bool = False            # new 'woreplace' permutation an epoch
    resample_every: int = 1
    chunk_size: int = 500             # steps between host looks
    log_every: int = 1000
    valid_every: int = -1             # epochs between validations
    save_every: int = -1              # epochs between resume_state.ckpt
    render_tb_every: int = -1         # epochs between TensorBoard renders
    grow_every: int = -1
    growth_strategy: str = 'increase'


@dataclass
class ImageStepDraws:
    """The random draws of one image step."""
    sga_u: Optional[torch.Tensor] = None   # [T, latent_dim] U(tiny, 1)
    noise: Optional[torch.Tensor] = None   # new [T, latent_dim] U(-.5, .5)
    idx: Optional[torch.Tensor] = None     # ['wreplace'] pixel indices


class ImageTrainer:
    """Trains one NeuralImage on one image."""

    # tile size of the full-image render (a 67 Mpix image at once would
    # need tens of GB of activations)
    RENDER_CHUNK_PIX = 4 * 1024 * 1024

    def __init__(self, cfg: ImageTrainerConfig, model_cfg: NeuralImageConfig,
                 dataset, seed: int = 0, log_dir: Optional[str] = None,
                 logger=None, device=None, mesh: Optional[pmesh.Mesh] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.dataset = dataset
        self.log_dir = log_dir
        self.logger = logger              # optional ExperimentLogger
        if mesh is None:
            mesh = pmesh.local_mesh(resolve_device(device))
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f'the mesh runs on {mesh.device}, not {device}')
        self.mesh = mesh
        self.device = resolve_device(mesh.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        gcfg = model_cfg.grid
        self.ldecode_enabled = gcfg.ldec is not None
        self.entropy_enabled = self.ldecode_enabled and gcfg.entropy_enabled
        self.affine = lg.supports_affine_fusion(gcfg)
        self.set_params(pmesh.replicate(mesh, neural_image_init(
            self.generator, model_cfg, self.device)))
        self.noise = torch.zeros_like(self.params['grid']['codebook'])

        n = cfg.epochs
        self.entropy_reg_sched = DecayScheduler(
            n, cfg.entropy_reg_sched, cfg.entropy_reg, cfg.entropy_reg_end,
            params={'decay_period': cfg.decay_period,
                    'temperature': cfg.temperature})
        self.temperature_sched = DecayScheduler(
            n, 'exp', 1.0, cfg.temperature,
            params={'temperature': cfg.temperature,
                    'decay_period': cfg.decay_period})
        # the image trainer pins the decoder lr
        self.ldec_lr_sched = DecayScheduler(cfg.ldec_lr_warmup, 'fix',
                                            cfg.ldec_lr)

        self.epoch = 0
        self.best_val_psnr = -np.inf
        self.val_best_params = None
        self.history = []
        self._resampled_epoch = 1
        self._full = None                 # full mode: (coords, gt) on device
        self._dev_img = None              # sampled modes: image, permutation
        self._dev_perm = None
        self._lut = None

    # ------------------------------------------------------------------
    def set_params(self, params: dict, opt_state: Optional[dict] = None):
        """Install a parameter tree (and optionally an Adam state) and
        reset the best state to a copy of it."""
        self.labels = optim.label_params(params)
        for path, leaf in optim.tree_leaves_with_path(params):
            leaf.requires_grad_(self.labels[path] != 'frozen')
        self.params = params
        self.opt_state = (opt_state if opt_state is not None
                          else optim.adam_init(params))
        self.best_params = optim.tree_map(
            lambda t: t.detach().clone(), params)
        self.best_loss = torch.full((), np.inf, device=self.device)
        self.best_psnr = torch.zeros((), device=self.device)

    @property
    def is_writer(self) -> bool:
        """This process writes logs, checkpoints and renders: rank 0."""
        return self.mesh.rank == 0

    def _on_device(self, params: dict) -> dict:
        return optim.tree_map(lambda t: torch.as_tensor(t).to(self.device),
                              params)

    # ------------------------------------------------------------------
    def draw_step(self, use_sga: bool, refresh_noise: bool = True
                  ) -> ImageStepDraws:
        """Draw one step's randomness from the trainer's generator."""
        gen, dev = self.generator, self.device
        cb = self.params['grid']['codebook']
        draws = ImageStepDraws()
        if use_sga:
            draws.sga_u = sga_uniform(cb.shape, gen, dev)
        if self.entropy_enabled and refresh_noise:
            draws.noise = torch.rand(cb.shape, generator=gen,
                                     device=dev) - 0.5
        ds = self.dataset
        if not ds.static_coords and ds.sample_mode == 'wreplace':
            draws.idx = torch.randint(0, ds.num_pixels, (ds.num_samples,),
                                      generator=gen, device=dev)
        return draws

    def step(self, coords: torch.Tensor, gt: torch.Tensor,
             draws: ImageStepDraws, *, ent_lambda: float, temperature: float,
             lr_ldec: float, use_sga: bool, do_recalib: bool = False,
             lod_mask: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One training step on ``coords`` [N, 2] / ``gt`` [N, 3]: Adam in
        place on ``self.params`` / ``self.opt_state``; returns the step's
        metrics as device tensors.  With a mesh the pixels are this rank's
        part of the batch, the gradients are averaged over the ranks and
        the metrics are the whole batch's."""
        cfg, mcfg = self.cfg, self.model_cfg
        gcfg = mcfg.grid
        p = self.params
        if (do_recalib and self.ldecode_enabled and cfg.norm != 'none'
                and gcfg.ldecode_type == 'single'):
            with record_function('step/recalib'), torch.no_grad():
                ld = p['grid']['latent_dec']
                ld['div'].copy_(recalibrate_div(
                    ld, p['grid']['codebook'], cfg.norm)['div'])
        if draws.noise is not None:
            self.noise = draws.noise
        trained = [(path, leaf) for path, leaf
                   in optim.tree_leaves_with_path(p) if leaf.requires_grad]

        with record_function('step/decode'):
            parts = (lg.affine_parts(p['grid'], gcfg, use_sga=use_sga,
                                     temperature=temperature,
                                     sga_u=draws.sga_u)
                     if self.affine else None)
        with record_function('field/encode'):
            pred = neural_image_rgb(p, mcfg, coords, use_sga=use_sga,
                                    temperature=temperature,
                                    sga_u=draws.sga_u, affine=parts,
                                    lod_mask=lod_mask)
        rgb_loss = torch.mean((pred - gt) ** 2)
        loss = cfg.rgb_loss_weight * rgb_loss
        metrics = {}
        if self.entropy_enabled:
            with record_function('step/rate_loss'):
                avg_bits, total_bits = lg.ent_loss(p['grid'], gcfg,
                                                   self.noise)
            loss = loss + ent_lambda * avg_bits
            metrics['ent_loss'] = (ent_lambda * avg_bits).detach()
            metrics['total_bits'] = total_bits.detach()
        grads = torch.autograd.grad(loss, [leaf for _, leaf in trained],
                                    allow_unused=True)

        # a fill, not torch.tensor(): a host-to-device copy would wait for
        # the whole forward and backward before Adam is launched
        lr_grid = torch.full((), cfg.grid_lr, dtype=torch.float32,
                             device=self.device)
        if (self.ldecode_enabled and cfg.scale_grid_lr != 'none'
                and gcfg.ldecode_type == 'single'):
            norm = scale_norm(p['grid']['latent_dec']).detach()
            lr_grid = (lr_grid * norm if cfg.scale_grid_lr == 'mul'
                       else lr_grid / norm)
        lrs = {'decoder': cfg.lr, 'grid': lr_grid, 'latent_dec': lr_ldec,
               'prob_models': 1e-4, 'rest': cfg.lr}
        wd = {'decoder': 0.0, 'grid': cfg.weight_decay,
              'latent_dec': cfg.weight_decay_decoder,
              'prob_models': cfg.weight_decay_decoder, 'rest': 0.0}
        grads = {path: g for (path, _), g in zip(trained, grads)}
        kw = dict(decoupled=cfg.optimizer_type == 'adamw')
        with record_function('step/adam'):
            optim.adam_update_mesh(grads, self.opt_state, p, self.labels,
                                   lrs, wd, self.mesh, **kw)
        # the batch's means from the ranks' (equal-sized) parts; the rate
        # term is the same on every rank
        rgb_loss, cmse = pmesh.all_reduce_sum(self.mesh, torch.stack(
            [rgb_loss.detach(), clamped_mse(pred.detach(), gt)])
        ) / self.mesh.size
        metrics.update(
            loss=cfg.rgb_loss_weight * rgb_loss + metrics.get('ent_loss', 0.0),
            rgb_loss=rgb_loss,
            psnr=20.0 * np.log10(255.0) - 10.0 * torch.log10(cmse))
        return metrics

    @torch.no_grad()
    def update_best(self, metrics: Dict[str, torch.Tensor]):
        """Keep the params of the lowest train rgb loss so far, on the
        device and without a host read."""
        with record_function('step/best'):
            better = metrics['rgb_loss'] < self.best_loss
            torch.where(better, metrics['rgb_loss'], self.best_loss,
                        out=self.best_loss)
            torch.where(better, metrics['psnr'], self.best_psnr,
                        out=self.best_psnr)
            for (_, new), (_, old) in zip(
                    optim.tree_leaves_with_path(self.params),
                    optim.tree_leaves_with_path(self.best_params)):
                torch.where(better, new, old, out=old)

    # ------------------------------------------------------------------
    def _schedule_arrays(self, e0: int, n: int, epochs=None, iters=None
                         ) -> Dict[str, np.ndarray]:
        """Per-step schedule values (host numpy) of ``n`` steps from epoch
        ``e0`` (or at ``epochs``): entropy lambda and SGA temperature by
        epoch, the decoder lr, the recalibration and noise refresh flags by
        iteration (default: the epochs), and the LOD masks of
        ``grow_every``."""
        cfg = self.cfg
        epochs = (np.arange(e0, e0 + n) if epochs is None
                  else np.asarray(epochs))
        iters = epochs if iters is None else np.asarray(iters)
        ent = (np.asarray([self.entropy_reg_sched(e) for e in epochs],
                          np.float32)
               if self.entropy_enabled else np.zeros(n, np.float32))
        temp = (np.asarray([self.temperature_sched(e) for e in epochs],
                           np.float32)
                if self.ldecode_enabled else np.ones(n, np.float32))
        lr_ldec = np.asarray([self.ldec_lr_sched(e) for e in epochs],
                             np.float32)
        recal = (np.asarray(iters % cfg.norm_every == 0)
                 if (self.ldecode_enabled and cfg.norm != 'none')
                 else np.zeros(n, bool))
        refresh = (np.asarray((iters - 1) % max(cfg.noise_freq, 1) == 0)
                   if self.entropy_enabled else np.zeros(n, bool))
        num_lods = self.model_cfg.grid.num_lods
        if cfg.grow_every > 0:
            masks = np.zeros((n, num_lods), np.float32)
            for i, e in enumerate(epochs):
                masks[i, grow_loss_lods(int(e), num_lods, cfg.grow_every,
                                        cfg.growth_strategy)] = 1.0
        else:
            masks = np.ones((n, num_lods), np.float32)
        return {'ent_lambda': ent, 'temperature': temp, 'lr_ldec': lr_ldec,
                'do_recalib': recal, 'refresh_noise': refresh,
                'lod_mask': masks}

    def _use_sga_at(self, e: int) -> bool:
        cfg = self.cfg
        return (self.ldecode_enabled and cfg.use_sga
                and (e / cfg.epochs) <= cfg.decay_period)

    def _sga_flip(self) -> int:
        """The last epoch that trains with SGA."""
        return int(np.floor(self.cfg.decay_period * self.cfg.epochs))

    def _run_steps(self, xs: Dict[str, np.ndarray], use_sga: bool, batch_fn
                   ) -> Dict[str, torch.Tensor]:
        """The steps of one chunk; ``batch_fn(i, draws)`` -> (coords, gt)."""
        masks = None
        if self.cfg.grow_every > 0:
            # one upload a chunk: each host-to-device copy syncs the stream
            with record_function('step/presample'):
                masks = torch.as_tensor(xs['lod_mask'], device=self.device)
        metrics = None
        for i in range(len(xs['ent_lambda'])):
            with record_function('step/draws'):
                draws = self.draw_step(use_sga, bool(xs['refresh_noise'][i]))
                coords, gt = batch_fn(i, draws)
            metrics = self.step(
                coords, gt, draws, ent_lambda=float(xs['ent_lambda'][i]),
                temperature=float(xs['temperature'][i]),
                lr_ldec=float(xs['lr_ldec'][i]), use_sga=use_sga,
                do_recalib=bool(xs['do_recalib'][i]),
                lod_mask=None if masks is None else masks[i])
            self.update_best(metrics)
        return metrics

    def train(self, epochs: Optional[int] = None, log_fn=None,
              finalize: bool = True):
        """Train ``epochs`` epochs (default: to the configured end, so a
        resumed run finishes its schedule).  Returns :meth:`finalize`'s
        summary, or None with ``finalize=False``."""
        cfg = self.cfg
        epochs = (epochs if epochs is not None
                  else max(0, cfg.epochs - self.epoch))
        ds = self.dataset
        if not ds.static_coords:
            return self._train_sampled(epochs, log_fn, finalize)
        if self._full is None:
            # this rank's rows of the pixel lattice in row-major order,
            # uploaded once
            self._full = pmesh.shard_batch(self.mesh, pixel_coords(ds.h, ds.w),
                                           ds.rgb)
        coords, gt = self._full

        t0 = time.time()
        done = 0
        max_chunk = max(1, cfg.chunk_size if cfg.log_every <= 0
                        else min(cfg.chunk_size, cfg.log_every))
        while done < epochs:
            e0 = self.epoch + 1
            use_sga = self._use_sga_at(e0)
            n = min(max_chunk, epochs - done)
            # use_sga stays constant within a chunk (it flips once)
            if use_sga:
                n = min(n, max(1, self._sga_flip() - e0 + 1))
            n = self._cadence_clip(e0, n)
            with record_function('step/presample'):
                xs = self._schedule_arrays(e0, n)
            metrics = self._run_steps(xs, use_sga, lambda i, d: (coords, gt))
            self.epoch += n
            done += n
            if self.is_writer and cfg.log_every > 0 and (
                    self.epoch % cfg.log_every == 0 or done >= epochs):
                with record_function('step/log'):
                    entry = self.size_report(use_codec=False)
                    entry.update(epoch=self.epoch,
                                 psnr=float(metrics['psnr']),
                                 rgb_loss=float(metrics['rgb_loss']),
                                 best_psnr=float(self.best_psnr),
                                 elapsed=time.time() - t0)
                    if self.entropy_enabled:
                        entry['ent_loss'] = float(metrics['ent_loss'])
                self.history.append(entry)
                if self.logger is not None:
                    for k in ('psnr', 'rgb_loss', 'bpp', 'total_size_kb',
                              'rounding_loss'):
                        self.logger.scalar(f'train/{k}', entry[k], self.epoch)
                if log_fn:
                    log_fn(entry)
            self._post_chunk(at_epoch_boundary=True, log_fn=log_fn)
        return self.finalize() if finalize else None

    # ------------------------------------------------------------------
    def _cadence_clip(self, e0: int, n: int) -> int:
        """Stop chunks at the validation, checkpoint and render epochs."""
        cfg = self.cfg
        for every in (cfg.valid_every, cfg.save_every, cfg.render_tb_every):
            if every and every > 0:
                nxt = ((e0 - 1) // every + 1) * every
                n = min(n, max(1, nxt - e0 + 1))
        return n

    def _post_chunk(self, at_epoch_boundary: bool, log_fn=None):
        """At epoch boundaries: validation (``valid_every``), the
        TensorBoard render (``render_tb_every``, through the logger) and
        the resume state (``save_every``, into ``log_dir``)."""
        if not at_epoch_boundary:
            return
        cfg = self.cfg
        e = self.epoch
        # every rank validates and renders, as one trainer would, so that
        # none waits in the next collective for rank 0; rank 0 logs
        if cfg.valid_every > 0 and e % cfg.valid_every == 0:
            m = self.validate()
            if self.is_writer and self.logger is not None:
                self.logger.scalar('valid/psnr', m['psnr'], e)
            if self.is_writer and log_fn:
                log_fn({'epoch': e, 'valid_psnr': m['psnr'],
                        'best_val_psnr': self.best_val_psnr})
        if (cfg.render_tb_every > 0 and e % cfg.render_tb_every == 0
                and pmesh.broadcast_object(self.mesh,
                                           self.logger is not None)):
            img = self.render()
            if self.is_writer:
                self.logger.image('render/pred', img, e)
        if cfg.save_every > 0 and e % cfg.save_every == 0 and self.log_dir:
            checkpoint.save_trainer(
                self, os.path.join(self.log_dir, 'resume_state.ckpt'))

    def validate(self) -> Dict[str, float]:
        """Full-image eval-mode (rounded latents) clamped PSNR; on a new
        best keep a host copy of the params (``val_best_params``: Adam
        updates ``self.params`` in place)."""
        ds = self.dataset
        pred = torch.as_tensor(self.render().reshape(-1, 3))
        psnr = float(clamped_psnr(pred, torch.as_tensor(ds.rgb)))
        if psnr > self.best_val_psnr:
            self.best_val_psnr = psnr
            self.val_best_params = optim.tree_map(
                lambda t: t.detach().to('cpu', copy=True), self.params)
        return {'psnr': psnr, 'epoch': self.epoch}

    # ------------------------------------------------------------------
    def _sampling_setup(self):
        """The image (uint8 where that is lossless) and the permutation on
        the device, and the 256-entry dequantization table, uploaded once."""
        rgb = np.asarray(self.dataset.rgb, np.float32)
        q = rgb * 255.0
        qr = np.rint(q)
        if float(np.abs(q - qr).max()) < 1e-3:            # an 8-bit source
            # 4x less memory; k / 255 in float64, rounded once, gives the
            # float32 values exactly
            self._dev_img = torch.as_tensor(qr.astype(np.uint8),
                                            device=self.device)
            self._lut = torch.as_tensor(
                (np.arange(256) / 255.0).astype(np.float32),
                device=self.device)
        else:
            self._dev_img = torch.as_tensor(rgb, device=self.device)
        self._upload_perm()

    def _upload_perm(self):
        ds = self.dataset
        if ds.shuffle_idx is not None:
            self._dev_perm = torch.as_tensor(ds.shuffle_idx,
                                             dtype=torch.int64,
                                             device=self.device)

    def pixel_batch(self, idx: torch.Tensor):
        """(coords [n, 2], rgb [n, 3]) of flat pixel indices on the
        device: the coordinates in float64 rounded once, as the host's
        ``index_to_coords`` gives them, and the rgb dequantized through
        the table when the image is uint8."""
        ds = self.dataset
        rr = torch.div(idx, ds.w, rounding_mode='floor').double()
        cc = torch.remainder(idx, ds.w).double()
        coords = torch.stack([(rr / ds.h - 0.5) * 2.0,
                              (cc / ds.w - 0.5) * 2.0], dim=-1).float()
        gt = self._dev_img[idx]
        if self._lut is not None:
            gt = self._lut[gt.long()]
        return coords, gt

    def batch_indices(self, it: int) -> torch.Tensor:
        """Pixel indices of iteration ``it`` (1-based) in the 'woreplace',
        'sequential' and 'eval' modes; 'wreplace' draws them."""
        ds = self.dataset
        ns, total = ds.num_samples, ds.num_pixels
        b = (it - 1) % len(ds)
        if ds.sample_mode == 'eval':
            s = b * ns
            e = min(s + ns, total)
            idx = torch.arange(s, e, device=self.device)
            # the tail batch padded with its own head, as the host's
            # batches are
            return torch.cat([idx, idx[:ns - (e - s)]])
        # the start clamped so the tail batch overlaps the one before it
        s = min(b * ns, total - ns)
        return self._dev_perm[s:s + ns]

    def _train_sampled(self, epochs: int, log_fn, finalize: bool):
        """Batched loop of the 'wreplace' / 'woreplace' / 'sequential' /
        'eval' modes (one epoch = ``len(dataset)`` batches)."""
        cfg = self.cfg
        ds = self.dataset
        bpe = len(ds)
        if self._dev_img is None:
            self._sampling_setup()
        start = self.epoch * bpe
        end = start + epochs * bpe
        done = start
        t0 = time.time()
        metrics = None
        while done < end:
            e0 = done // bpe + 1
            if (cfg.resample and e0 > self._resampled_epoch
                    and (e0 - 1) % max(1, cfg.resample_every) == 0):
                ds.resample()
                self._upload_perm()
                self._resampled_epoch = e0
            use_sga = self._use_sga_at(e0)
            n = min(max(1, cfg.chunk_size), end - done)
            if use_sga:
                n = min(n, max(1, self._sga_flip() * bpe - done))
            for every in (cfg.valid_every, cfg.save_every,
                          cfg.render_tb_every):
                if every and every > 0:
                    nxt = ((e0 - 1) // every + 1) * every * bpe
                    n = min(n, max(1, nxt - done))
            # schedules keyed by epoch; recalibration / noise by iteration
            iters = np.arange(done + 1, done + n + 1)
            with record_function('step/presample'):
                xs = self._schedule_arrays(
                    0, n, epochs=(iters - 1) // bpe + 1, iters=iters)

            def batch_fn(i, draws, _it0=done + 1):
                idx = (draws.idx if draws.idx is not None
                       else self.batch_indices(_it0 + i))
                # every rank draws the global batch and keeps its part
                idx = idx[pmesh.batch_sharding(self.mesh, idx.shape[0])]
                return self.pixel_batch(idx)

            metrics = self._run_steps(xs, use_sga, batch_fn)
            prev_epoch = self.epoch
            done += n
            self.epoch = done // bpe
            crossed = self.epoch != prev_epoch
            if self.is_writer and cfg.log_every > 0 and log_fn and (
                    (crossed and self.epoch % cfg.log_every == 0)
                    or done >= end):
                with record_function('step/log'):
                    entry = {'epoch': self.epoch, 'iteration': done,
                             'psnr': float(metrics['psnr']),
                             'rgb_loss': float(metrics['rgb_loss']),
                             'elapsed': time.time() - t0}
                if self.logger is not None:
                    for k in ('psnr', 'rgb_loss'):
                        self.logger.scalar(f'train/{k}', entry[k], done)
                log_fn(entry)
            self._post_chunk(at_epoch_boundary=crossed, log_fn=log_fn)
        return self.finalize() if finalize else None

    # ------------------------------------------------------------------
    def size_report(self, use_codec: bool, params=None) -> Dict[str, float]:
        """Bits per pixel and sizes in kB.  With ``use_codec`` the latent
        size is the length of real arithmetic codestreams and, with an
        entropy model, the smaller decodable stream of two: the
        histogram-coded one with its alphabet and CDF side information
        (``*_hist``) or the prob-model-coded one with the model's
        parameters (``latent_size_kb_pm``); ``stream`` names the one chosen
        and ``latent_size_kb_ref`` is the histogram stream without side
        information.  The grid is copied to the host once."""
        params = params if params is not None else self.params
        gcfg = self.model_cfg.grid
        grid = optim.tree_map(lambda t: torch.as_tensor(t).detach().cpu(),
                              params['grid'])
        has_pm = use_codec and self.ldecode_enabled and 'prob_model' in grid
        ldec_bits, latent_bits = lg.grid_size_bits(
            grid, gcfg, use_codec=use_codec, count_side_info=has_pm)
        rest_bits = non_grid_size_bits(params)
        npix = self.dataset.h * self.dataset.w
        cb = grid['codebook'].numpy()
        out = {}
        if has_pm:
            _, pm_bits = lg.grid_size_bits(grid, gcfg, use_codec=use_codec,
                                           use_prob_model=True,
                                           count_side_info=True)
            out['latent_size_kb_hist'] = latent_bits / 8e3
            out['total_size_kb_hist'] = (ldec_bits + latent_bits
                                         + rest_bits) / 8e3
            out['bpp_hist'] = (ldec_bits + latent_bits + rest_bits) / npix
            out['latent_size_kb_pm'] = pm_bits / 8e3
            out['latent_size_kb_ref'] = (
                latent_bits - lg.stream_side_info_bits(grid)) / 8e3
            out['stream'] = ('histogram' if latent_bits <= pm_bits
                             else 'prob_model')
            latent_bits = min(latent_bits, pm_bits)
        total = ldec_bits + latent_bits + rest_bits
        out.update({
            'ldec_size_kb': ldec_bits / 8e3,
            'latent_size_kb': latent_bits / 8e3,
            'remainder_size_kb': rest_bits / 8e3,
            'total_size_kb': total / 8e3,
            'bpp': total / npix,
            'rounding_loss': (float(np.mean(np.abs(cb - np.round(cb))))
                              if self.ldecode_enabled else 0.0),
        })
        return out

    @torch.no_grad()
    def render(self, params=None) -> np.ndarray:
        """Full-image prediction [H, W, 3] in eval mode (rounded latents,
        decoded once), in tiles of ``RENDER_CHUNK_PIX`` pixels, the tail
        tile overlapping the one before it."""
        params = self._on_device(params if params is not None
                                 else self.params)
        ds = self.dataset
        mcfg = self.model_cfg
        decoded = lg.decode_codebook(params['grid'], mcfg.grid)
        coords = pixel_coords(ds.h, ds.w)
        npix = coords.shape[0]
        chunk = min(npix, self.RENDER_CHUNK_PIX)
        pred = np.empty((npix, 3), np.float32)
        for s in range(0, npix, chunk):
            e = min(s + chunk, npix)
            s0 = e - chunk
            out = neural_image_rgb(
                params, mcfg, torch.as_tensor(coords[s0:e],
                                              device=self.device),
                decoded=decoded)
            pred[s:e] = out[s - s0:].cpu().numpy()
        return pred.reshape(ds.h, ds.w, 3)

    def finalize(self) -> Dict:
        """Best-state metrics with the arithmetic-coded size; written to
        ``log_dir/metrics.json``."""
        best = optim.tree_map(lambda t: t.detach().cpu(), self.best_params)
        report = self.size_report(use_codec=True, params=best)
        out = {'PSNR': float(self.best_psnr), 'rgb_loss': float(self.best_loss),
               'epoch': self.epoch, 'BPP': report['bpp'], **report}
        if self.val_best_params is not None:
            out['best_val_psnr'] = self.best_val_psnr
        if self.log_dir and self.is_writer:
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, 'metrics.json'), 'w') as f:
                json.dump(out, f, indent=2)
        return out
