"""Multiview (NeRF) trainer: single device, latent grid, flat or paged layout.

Port of ``shacira_tpu/trainers/multiview_trainer.py``.  The JAX trainer runs
chunks of steps under ``lax.scan``; here a Python loop runs one eager step
after another, over the same chunk boundaries (``chunk_size``, the prune
cadence, validation epochs), so the ray batches come from the same
``np.random.RandomState`` stream and SGA is switched off at the same step.

Semantics kept from the JAX package:
  * loss = rgb_loss_weight * L1(rgb) + entropy lambda * bits per latent;
  * Adam over five label groups with per-step learning rates: the grid lr
    divided (or multiplied) by the decoder's scale norm, the prob model at
    a fixed 1e-4, the decoder lr warmed up linearly;
  * an occupancy prune every ``prune_every`` iterations;
  * float PSNR evaluation with rounded (eval-mode) latents;
  * on the paged layout with a segmented march (``use_paged``), the
    deferred paged trace: grid encode on segment-grouped rows through
    kernels B2/B3, the coarse culling grid refreshed at init and after
    every prune, and evaluation through the same path with eval-mode
    affine parts.

Every random draw of a step (SGA uniforms, rate-loss noise, march jitter)
is a :class:`StepDraws` argument of :meth:`MultiviewTrainer.step`; the
trainer draws them from its ``torch.Generator``.  Checkpoint and resume,
size reports, SSIM, the adaptive sample budget, LOD curricula and meshes
wait for later slices (ROADMAP Queue A).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from shacira_tpu_torch import optim
from shacira_tpu_torch.accel import occupancy as occ
from shacira_tpu_torch.core.rays import make_rays
from shacira_tpu_torch.core.schedulers import DecayScheduler
from shacira_tpu_torch.device import resolve_device
from shacira_tpu_torch.models.grids import latent_grid as lg
from shacira_tpu_torch.models.latent_decoders import scale_norm, sga_uniform
from shacira_tpu_torch.models.nefs import nerf as nerf_mod
from shacira_tpu_torch.models.nefs.nerf import NeuralRadianceFieldConfig
from shacira_tpu_torch.ops import paged_hash as ph
from shacira_tpu_torch.ops.image import psnr
from shacira_tpu_torch.tracers import rf_tracer


@dataclass
class MultiviewTrainerConfig:
    epochs: int = 300
    rgb_loss_weight: float = 1.0
    optimizer_type: str = 'adam'      # 'adam' | 'adamw'
    lr: float = 0.0005
    grid_lr: float = 0.02
    ldec_lr: float = 0.01
    scale_grid_lr: str = 'div'        # 'div' | 'mul' | 'none'
    weight_decay: float = 0.0
    weight_decay_decoder: float = 0.0
    ldec_lr_warmup: int = 5
    use_sga: bool = True
    decay_period: float = 0.9
    temperature: float = 1.0
    entropy_reg: float = 1e-4
    entropy_reg_end: float = 1e-4
    entropy_reg_sched: str = 'cosine'
    noise_freq: int = 1
    prune_every: int = 100            # iterations (-1 disables)
    chunk_size: int = 100
    valid_every: int = -1             # epochs between validations
    valid_views: int = 4


@dataclass
class StepDraws:
    """The random draws of one training step."""
    march_u: torch.Tensor                  # [R, num_steps] U(0, 1)
    sga_u: Optional[torch.Tensor] = None   # [T, latent_dim] U(tiny, 1)
    noise: Optional[torch.Tensor] = None   # [T, latent_dim] U(-.5, .5)


class MultiviewTrainer:
    def __init__(self, cfg: MultiviewTrainerConfig,
                 model_cfg: NeuralRadianceFieldConfig,
                 tracer_cfg: rf_tracer.RFTracerConfig, dataset,
                 num_rays: int, seed: int = 0, device=None,
                 val_dataset=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        if model_cfg.grid.hash_layout == 'paged':
            # segment grouping follows the grid's page geometry
            tracer_cfg = replace(tracer_cfg,
                                 group_res=ph.group_res_of(
                                     model_cfg.grid.page_res))
        self.tracer_cfg = tracer_cfg
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.num_rays = num_rays
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.np_rng = np.random.RandomState(seed)
        self.best_val_psnr = -np.inf

        gcfg = model_cfg.grid
        self.ldecode_enabled = gcfg.ldec is not None
        self.entropy_enabled = self.ldecode_enabled and gcfg.entropy_enabled
        self.affine = lg.supports_affine_fusion(gcfg)
        self.set_params(nerf_mod.nerf_init(self.generator, model_cfg,
                                           self.device))
        self.noise = torch.zeros_like(self.params['grid']['codebook'])
        self.occ_state = occ.occupancy_init(model_cfg.occ_cfg, self.device)
        self.use_paged = (gcfg.hash_layout == 'paged' and self.affine
                          and tracer_cfg.segment_size > 0
                          and tracer_cfg.eval_seg_budget > 0)
        if tracer_cfg.segment_size > 0:
            rf_tracer.validate_segment_cover(
                tracer_cfg, model_cfg.occ_cfg, float(dataset.dist_min),
                float(dataset.dist_max))
            self._refresh_coarse()
        if self.use_paged:
            gss = tracer_cfg.group_seg_size or tracer_cfg.segment_size
            if tracer_cfg.segment_size % gss:
                raise ValueError(f'group_seg_size {gss} must divide '
                                 f'segment_size {tracer_cfg.segment_size}')
            # [-1,1] -> [0,1] halves distances; the grouping cell is keyed
            # on the sub-segment's center sample: one spacing of slack
            span = float(dataset.dist_max) - float(dataset.dist_min)
            ph.validate_paged_cover(
                gcfg.spec, span * (gss / 2 + 1) / tracer_cfg.num_steps / 2.0)

        self.iters_per_epoch = dataset.num_views
        self.entropy_reg_sched = DecayScheduler(
            cfg.epochs, cfg.entropy_reg_sched, cfg.entropy_reg,
            cfg.entropy_reg_end,
            params={'decay_period': cfg.decay_period,
                    'temperature': cfg.temperature})
        self.temperature_sched = DecayScheduler(
            cfg.epochs, 'exp', 1.0, cfg.temperature,
            params={'temperature': cfg.temperature,
                    'decay_period': cfg.decay_period})
        self.ldec_lr_sched = DecayScheduler(
            cfg.ldec_lr_warmup, 'linear', 0.1 * cfg.ldec_lr, cfg.ldec_lr)
        self.iteration = 0

    # ------------------------------------------------------------------
    def set_params(self, params: dict, opt_state: Optional[dict] = None):
        """Install a parameter tree (and optionally an Adam state); every
        leaf of a trained group requires grad."""
        self.labels = optim.label_params(params)
        for path, leaf in optim.tree_leaves_with_path(params):
            leaf.requires_grad_(self.labels[path] != 'frozen')
        self.params = params
        self.opt_state = (opt_state if opt_state is not None
                          else optim.adam_init(params))

    def _refresh_coarse(self):
        """Recompute the coarse culling grid of the segmented march (the
        occupancy changes only at prune time)."""
        base = {k: v for k, v in self.occ_state.items() if k != 'coarse'}
        self.occ_state = dict(base, coarse=rf_tracer.coarse_dilated_occupancy(
            base, self.model_cfg.occ_cfg, self.tracer_cfg))

    def _encode_split(self, params: dict, parts):
        """(zbar_fn, finish_fn, head_fn) of the paged trace."""
        mcfg, tcfg = self.model_cfg, self.tracer_cfg
        seg_group = tcfg.group_seg_size or tcfg.segment_size

        def zbar_fn(coords, grouping):
            return nerf_mod.nerf_zbar(mcfg, coords, grouping, seg_group,
                                      affine=parts)

        def finish_fn(zbar_c, coords_c):
            return nerf_mod.nerf_finish_feats(mcfg, zbar_c, coords_c,
                                              affine=parts)

        def head_fn(feats, dirs):
            return nerf_mod.nerf_head(params, mcfg, feats, dirs)

        return zbar_fn, finish_fn, head_fn

    def draw_step(self, use_sga: bool, refresh_noise: bool = True
                  ) -> StepDraws:
        """Draw one step's randomness from the trainer's generator."""
        gen, dev = self.generator, self.device
        cb = self.params['grid']['codebook']
        sga_u = sga_uniform(cb.shape, gen, dev) if use_sga else None
        noise = None
        if self.entropy_enabled:
            if self.cfg.noise_freq == 1 or refresh_noise:
                self.noise = torch.rand(cb.shape, generator=gen,
                                        device=dev) - 0.5
            noise = self.noise
        march_u = torch.rand(
            rf_tracer.march_jitter_shape(self.tracer_cfg, self.num_rays),
            generator=gen, device=dev)
        return StepDraws(march_u=march_u, sga_u=sga_u, noise=noise)

    def step(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
             gt: torch.Tensor, draws: StepDraws, *, ent_lambda: float,
             temperature: float, lr_ldec: float,
             use_sga: bool) -> Dict[str, torch.Tensor]:
        """One training step: trace, L1 + rate loss, backward, Adam (in
        place on ``self.params`` / ``self.opt_state``)."""
        cfg, mcfg, tcfg = self.cfg, self.model_cfg, self.tracer_cfg
        gcfg = mcfg.grid
        p = self.params
        trained = [(path, leaf) for path, leaf
                   in optim.tree_leaves_with_path(p) if leaf.requires_grad]

        with record_function('step/decode'):
            if self.affine:
                parts = lg.affine_parts(p['grid'], gcfg, use_sga=use_sga,
                                        temperature=temperature,
                                        sga_u=draws.sga_u)
            else:
                decoded = lg.decode_codebook(p['grid'], gcfg, use_sga=use_sga,
                                             temperature=temperature,
                                             sga_u=draws.sga_u)

        def field_fn(coords, dirs):
            if self.affine:
                return nerf_mod.nerf_rgba(p, mcfg, coords, dirs, affine=parts)
            return nerf_mod.nerf_rgba(p, mcfg, coords, dirs, decoded=decoded)

        d = self.dataset
        rays = make_rays(rays_o, rays_d, d.dist_min, d.dist_max)
        split = self._encode_split(p, parts) if self.use_paged else None
        rb = rf_tracer.trace(field_fn, self.occ_state, mcfg.occ_cfg, tcfg,
                             rays, draws.march_u, encode_split=split)
        rgb_loss = torch.mean(torch.abs(rb['rgb'] - gt))
        loss = cfg.rgb_loss_weight * rgb_loss
        if self.entropy_enabled:
            with record_function('step/rate_loss'):
                avg_bits, _ = lg.ent_loss(p['grid'], gcfg, draws.noise)
            loss = loss + ent_lambda * avg_bits
        grads = torch.autograd.grad(loss, [leaf for _, leaf in trained],
                                    allow_unused=True)

        # a fill, not torch.tensor(): a host-to-device copy would wait for
        # the whole forward and backward before Adam is launched
        lr_grid = torch.full((), cfg.grid_lr, dtype=torch.float32,
                             device=self.device)
        if self.ldecode_enabled and cfg.scale_grid_lr != 'none':
            norm = scale_norm(p['grid']['latent_dec']).detach()
            lr_grid = (lr_grid * norm if cfg.scale_grid_lr == 'mul'
                       else lr_grid / norm)
        lrs = {'decoder': cfg.lr, 'grid': lr_grid, 'latent_dec': lr_ldec,
               'prob_models': 1e-4, 'rest': cfg.lr}
        wd = {'decoder': 0.0, 'grid': cfg.weight_decay,
              'latent_dec': cfg.weight_decay_decoder,
              'prob_models': cfg.weight_decay_decoder, 'rest': 0.0}
        with record_function('step/adam'):
            optim.adam_update(
                {path: g for (path, _), g in zip(trained, grads)},
                self.opt_state, p, self.labels, lrs, wd,
                decoupled=cfg.optimizer_type == 'adamw')
        rgb = rb['rgb'].detach()
        return {'loss': loss.detach(), 'rgb_loss': rgb_loss.detach(),
                'psnr': psnr(rgb, gt)}

    @torch.no_grad()
    def prune(self, u: Optional[torch.Tensor] = None):
        """Occupancy prune; ``u`` [num_cells, 3] U(0,1) cell jitter (in
        grouped cell order on the paged layout, see ``nerf.prune``)."""
        ocfg = self.model_cfg.occ_cfg
        if u is None:
            u = torch.rand((ocfg.num_cells, 3), generator=self.generator,
                           device=self.device)
        self.occ_state = nerf_mod.prune(self.params, self.model_cfg,
                                        self.occ_state, u)
        if self.tracer_cfg.segment_size > 0:
            self._refresh_coarse()

    # ------------------------------------------------------------------
    def _presample(self, n: int):
        """Host-side ray batches for ``n`` steps (one view per step)."""
        d = self.dataset
        ro = np.empty((n, self.num_rays, 3), np.float32)
        rd = np.empty((n, self.num_rays, 3), np.float32)
        gt = np.empty((n, self.num_rays, 3), np.float32)
        for i in range(n):
            v = self.np_rng.randint(d.num_views)
            idx = self.np_rng.randint(0, d.rgb.shape[1], size=self.num_rays)
            ro[i] = d.rays_o[v, idx]
            rd[i] = d.rays_d[v, idx]
            gt[i] = d.rgb[v, idx]
        return ro, rd, gt

    def _epoch_of(self, it: int) -> int:
        return it // self.iters_per_epoch + 1

    def train(self, num_iterations: Optional[int] = None, log_fn=None):
        """Train ``num_iterations`` steps (default: to the configured end),
        pruning every ``prune_every`` iterations; ``log_fn`` receives a dict
        after every chunk."""
        cfg = self.cfg
        total = (num_iterations if num_iterations is not None
                 else max(0, cfg.epochs * self.iters_per_epoch
                          - self.iteration))
        t0 = time.time()
        done = 0
        while done < total:
            it0 = self.iteration + 1
            n = min(cfg.chunk_size, total - done)
            if cfg.prune_every > 0:
                next_prune = ((self.iteration // cfg.prune_every) + 1) \
                    * cfg.prune_every
                n = min(n, next_prune - self.iteration)
            if cfg.valid_every > 0:
                e_cur = self._epoch_of(it0)
                nxt = (((e_cur - 1) // cfg.valid_every) + 1) \
                    * cfg.valid_every * self.iters_per_epoch
                n = min(n, max(1, nxt - self.iteration))
            e0 = self._epoch_of(it0)
            use_sga = (self.ldecode_enabled and cfg.use_sga
                       and (e0 / cfg.epochs) <= cfg.decay_period)
            # one upload a chunk: each host-to-device copy syncs the stream
            ro, rd, gt = (torch.as_tensor(a, device=self.device)
                          for a in self._presample(n))
            for i in range(n):
                it = it0 + i
                e = self._epoch_of(it)
                with record_function('step/draws'):
                    draws = self.draw_step(use_sga, refresh_noise=(
                        (it - 1) % max(cfg.noise_freq, 1) == 0))
                metrics = self.step(ro[i], rd[i], gt[i], draws,
                    ent_lambda=self.entropy_reg_sched(e),
                    temperature=self.temperature_sched(e),
                    lr_ldec=self.ldec_lr_sched(e), use_sga=use_sga)
            self.iteration += n
            done += n
            if (cfg.prune_every > 0 and self.iteration > 1
                    and self.iteration % cfg.prune_every == 0):
                self.prune()
            if log_fn:
                log_fn({'iteration': self.iteration,
                        'epoch': self._epoch_of(self.iteration),
                        'loss': float(metrics['loss']),
                        'rgb_loss': float(metrics['rgb_loss']),
                        'psnr': float(metrics['psnr']),
                        'occupancy': float(torch.mean(
                            self.occ_state['occ'].float())),
                        'elapsed': time.time() - t0})
            self._post_chunk(log_fn)
        return {'iterations': self.iteration, 'elapsed': time.time() - t0}

    def _post_chunk(self, log_fn=None):
        """Validation at epoch boundaries (``valid_every``)."""
        cfg = self.cfg
        if self.iteration % self.iters_per_epoch != 0:
            return
        e = self.iteration // self.iters_per_epoch
        if cfg.valid_every > 0 and e % cfg.valid_every == 0:
            m = self.validate()
            if log_fn:
                log_fn({'epoch': e, 'valid_psnr': m['psnr'],
                        'best_val_psnr': self.best_val_psnr})

    def validate(self) -> Dict[str, float]:
        """Render ``valid_views`` evenly spaced held-out views and track the
        best validation PSNR."""
        d = self.val_dataset or self.dataset
        stride = max(1, d.num_views // max(1, self.cfg.valid_views))
        m = self.evaluate(view_indices=range(0, d.num_views, stride),
                          dataset=d)
        self.best_val_psnr = max(self.best_val_psnr, m['psnr'])
        return m

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_view(self, view_idx: int, ray_batch: int = 4096,
                    generator: Optional[torch.Generator] = None,
                    dataset=None, params=None) -> np.ndarray:
        """Render one view in eval mode (rounded latents, decoded once; on
        the paged path the eval-mode affine parts, decoded after the
        block-local interpolation)."""
        d = dataset if dataset is not None else self.dataset
        params = params if params is not None else self.params
        mcfg, tcfg = self.model_cfg, self.tracer_cfg
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        split = None
        if self.use_paged:
            parts = lg.affine_parts(params['grid'], mcfg.grid)
            split = self._encode_split(params, parts)
            field_fn = None
        else:
            decoded = lg.decode_codebook(params['grid'], mcfg.grid)

            def field_fn(coords, dirs):
                return nerf_mod.nerf_rgba(params, mcfg, coords, dirs,
                                          decoded=decoded)

        npix = d.rgb.shape[1]
        out = np.zeros((npix, 3), np.float32)
        for s in range(0, npix, ray_batch):
            e = min(s + ray_batch, npix)
            ro = torch.as_tensor(d.rays_o[view_idx, s:e], device=self.device)
            rd = torch.as_tensor(d.rays_d[view_idx, s:e], device=self.device)
            if e - s < ray_batch:       # full batches keep the trace path
                pad = ray_batch - (e - s)
                ro = torch.cat([ro, ro[-1:].expand(pad, 3)])
                rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
            rays = make_rays(ro, rd, d.dist_min, d.dist_max)
            jitter = torch.rand(
                rf_tracer.march_jitter_shape(tcfg, ray_batch),
                generator=generator, device=self.device)
            rgb = rf_tracer.trace(field_fn, self.occ_state, mcfg.occ_cfg,
                                  tcfg, rays, jitter,
                                  encode_split=split)['rgb']
            out[s:e] = rgb[:e - s].cpu().numpy()
        return out.reshape(d.h, d.w, 3)

    def evaluate(self, view_indices=None, dataset=None) -> Dict[str, float]:
        """Mean float PSNR over views."""
        d = dataset if dataset is not None else self.dataset
        if view_indices is None:
            view_indices = range(d.num_views)
        psnrs = []
        for v in view_indices:
            pred = torch.as_tensor(self.render_view(v, dataset=d))
            gtv = torch.as_tensor(d.rgb[v].reshape(d.h, d.w, 3))
            psnrs.append(float(psnr(pred, gtv)))
        return {'psnr': float(np.mean(psnrs))}
