"""Multiview (NeRF) trainer: one device or data-parallel, any grid backbone,
flat or paged layout.

Port of ``shacira_tpu/trainers/multiview_trainer.py``.  The JAX trainer runs
chunks of steps under ``lax.scan``; here a Python loop runs one eager step
after another, over the same chunk boundaries (``chunk_size``, the prune
cadence, validation epochs), so the ray batches come from the same
``np.random.RandomState`` stream and SGA is switched off at the same step.

Semantics kept from the JAX package:
  * loss = rgb_loss_weight * L1(rgb) + entropy lambda * bits per latent;
  * Adam over five label groups with per-step learning rates: the grid lr
    divided (or multiplied) by the single decoder's scale norm (other
    decoders keep ``grid_lr``), the prob model at a fixed 1e-4, the
    decoder lr warmed up linearly;
  * an occupancy prune every ``prune_every`` iterations;
  * float PSNR evaluation with rounded (eval-mode) latents;
  * on the paged layout with a segmented march (``use_paged``), the
    deferred paged trace: grid encode on segment-grouped rows through
    kernels B2/B3, the coarse culling grid refreshed at init and after
    every prune, and evaluation through the same path with eval-mode
    affine parts;
  * with ``fine_mode='kernel'``, the fine occupancy query as B2's
    occupancy row: the packed occupancy grid and the dilated fine grid of
    the grouping are refreshed with the coarse grid, and rendering runs
    ``fine_mode='deferred'``;
  * transmittance culling and the two-level cull: the packed coarse grid
    (``'coarse2'``) and the super grid (``'super'``) are refreshed with the
    coarse grid, ``super_dilation`` is derived from the ray bounds;
  * adaptive budgets: after every prune the step's tracer config
    (``active_tracer_cfg``) takes sample and segment budgets on the
    ``{2^k, 1.5 * 2^k}`` ladder from probes of the occupied-sample and
    live-segment fractions; evaluation keeps the base config;
  * the random-LOD and LOD-growth curricula as a per-step ``lod_mask``;
  * the ``'voxel'`` march: on depth-captured data (RTMV) the occupancy is
    seeded from the dataset's point cloud; on the paged layout each DDA
    crossing's ``num_steps`` samples form a segment of the paged trace,
    and the adaptive budgets come from the occupied cell fraction and the
    probed live crossings per ray (:meth:`_live_cell_hits_per_ray`);
  * the alternative backbones (NGLOD, VQAD, triplanar; ``grid_kind``):
    the octree structure is built once on the device from the dataset's
    point cloud, or dense, and passed to every field call; no rate loss,
    no LOD curricula; evaluation and pruning run them in eval mode (VQAD's
    argmax lookup) and the size report counts their tables.

Every random draw of a step (SGA uniforms, rate-loss noise, march jitter)
is a :class:`StepDraws` argument of :meth:`MultiviewTrainer.step`, and the
probes take their jitter as an argument; the trainer draws them from its
``torch.Generator``.

Around training, as in the JAX package: validation keeps a host copy of
the best parameters (``val_best_params``), ``save_every`` epochs write
``log_dir/resume_state.ckpt`` (``utils/checkpoint.py``), every
``render_tb_every`` epochs ``render_view(0)`` of the validation split goes
to the optional ``ExperimentLogger`` as ``render/view0`` (with the
training scalars, and the validation metrics as records), :meth:`evaluate`
returns PSNR, SSIM and, with ``SHACIRA_LPIPS_WEIGHTS`` set, LPIPS, and
:meth:`size_report` gives the compressed size in kB from real arithmetic
codestreams of the rounded latents.

Data parallelism (``mesh=``, ``parallel/mesh.py``: one process a device):
``num_rays`` must divide the mesh size; the parameters, the noise and the
occupancy are replicated from rank 0 at construction.  Every rank draws
the step's whole draws and the global ray batch, as one trainer would.
With budgets that divide n each rank traces its ``R/n`` rays at budgets/n
(``rf_tracer.per_device_cfg``, :attr:`_shard_ray_active`), else every
rank traces every ray.  With ``shard_table_work`` (a latent grid whose
table rows divide n) the SGA quantize, the affine decode and the rate loss
run on the rank's ``T/n`` rows, whose Adam moments it alone holds; one
autograd all-gather joins the quantized rows.  Gradients are averaged over
the ranks, the metrics are the global batch's, the prune's occupancy and
the probes of the adapted budgets are rank 0's on every rank.  Every rank
validates and renders, as one trainer would; only rank 0 logs and writes
checkpoints (for which every rank gathers the moments).  Without a mesh
the trainer runs on a one-rank mesh (``parallel/mesh.local_mesh``), whose
collectives do nothing and which shards no table work.

Each training step and each prune runs under ``step_lock`` (a
``utils/locks.FairRLock``: a waiting frame gets it before the next step),
and ``iteration`` advances with every step: a viewer that renders under
the same lock (``render/optimization_app.py``) reads whole steps only and
knows which one it rendered.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from shacira_tpu_torch import optim
from shacira_tpu_torch.accel import occupancy as occ
from shacira_tpu_torch.core.rays import make_rays
from shacira_tpu_torch.core.schedulers import DecayScheduler, grow_loss_lods
from shacira_tpu_torch.device import resolve_device
from shacira_tpu_torch.models.grids import latent_grid as lg
from shacira_tpu_torch.models.grids import octree_grid as og
from shacira_tpu_torch.models.grids import triplanar_grid as tg
from shacira_tpu_torch.models.latent_decoders import scale_norm, sga_uniform
from shacira_tpu_torch.models.nefs import nerf as nerf_mod
from shacira_tpu_torch.models.nefs.nerf import NeuralRadianceFieldConfig
from shacira_tpu_torch.ops import lpips as lpips_mod
from shacira_tpu_torch.ops import paged_hash as ph
from shacira_tpu_torch.ops.image import psnr, ssim
from shacira_tpu_torch.parallel import mesh as pmesh
from shacira_tpu_torch.tracers import rf_tracer
from shacira_tpu_torch.utils import checkpoint
from shacira_tpu_torch.utils.locks import FairRLock


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
    # after each prune, shrink the step's budgets to ~budget_headroom x
    # the probed live samples / segments, on the {2^k, 1.5*2^k} ladder
    adaptive_budget: bool = False
    budget_headroom: float = 1.5
    min_budget: int = 16384
    # LOD curricula: a max LOD drawn per step with weights 2^i, or the
    # growth schedule of grow_every / growth_strategy
    random_lod: bool = False
    grow_every: int = -1
    growth_strategy: str = 'increase'
    chunk_size: int = 100
    valid_every: int = -1             # epochs between validations
    valid_views: int = 4
    save_every: int = -1              # epochs between resume_state.ckpt
    render_tb_every: int = -1         # epochs between render/view0 images


@dataclass
class StepDraws:
    """The random draws of one training step."""
    march_u: torch.Tensor                  # march_jitter_shape U(0, 1)
    sga_u: Optional[torch.Tensor] = None   # [T, latent_dim] U(tiny, 1)
    noise: Optional[torch.Tensor] = None   # [T, latent_dim] U(-.5, .5)


def budget_rung(x: float) -> int:
    """Smallest budget >= ``x`` on the {2^k, 1.5 * 2^k} ladder (the 1.5
    rungs only where 3/4 of the power of two is a multiple of 128)."""
    p = 1 << int(np.ceil(np.log2(max(x, 1.0))))
    if x <= 0.75 * p and (3 * p) % 512 == 0:
        return (3 * p) // 4
    return p


def adapted_budgets(base: rf_tracer.RFTracerConfig, num_rays: int,
                    sample_frac: float, seg_frac: Optional[float],
                    min_budget: int, headroom: float) -> dict:
    """Budgets from probed fractions, each capped at its base value.

    ``sample_frac``: the occupied fraction of the 'ray' march's samples, or
    for the 'voxel' march the occupied fraction of the grid's cells (the
    expected samples are then that fraction of ``R * num_steps *
    max_intersections``).  ``seg_frac`` (paged second stage only): the
    live-segment fraction of the segmented 'ray' march, or the live
    crossings per ray of the 'voxel' march, whose segments are crossings
    of ``num_steps`` samples."""
    voxel = base.raymarch_type == 'voxel'
    expected = sample_frac * num_rays * base.num_steps * (
        base.max_intersections if voxel else 1)
    k = min(budget_rung(max(min_budget, headroom * expected)),
            base.max_samples)
    new = {'max_samples': k}
    if seg_frac is not None:
        g = base.num_steps if voxel else base.segment_size
        live = seg_frac * num_rays * (1 if voxel else base.num_steps // g)
        want = budget_rung(max(max(256, min_budget // g), headroom * live))
        if not voxel:
            sb_base = base.seg_budget or max(1, 8 * base.max_samples // g)
            new['seg_budget'] = min(want, sb_base)
        new['eval_seg_budget'] = min(want, base.eval_seg_budget)
        new['max_samples'] = min(k, new['eval_seg_budget'] * g)
    return new


class MultiviewTrainer:
    def __init__(self, cfg: MultiviewTrainerConfig,
                 model_cfg: NeuralRadianceFieldConfig,
                 tracer_cfg: rf_tracer.RFTracerConfig, dataset,
                 num_rays: int, seed: int = 0, device=None,
                 val_dataset=None, log_dir: Optional[str] = None,
                 structure: Optional[og.OctreeStructure] = None,
                 logger=None, mesh: Optional[pmesh.Mesh] = None):
        self.cfg = cfg
        self.logger = logger                # optional ExperimentLogger
        self.step_lock = FairRLock()
        self.model_cfg = model_cfg
        if mesh is None:
            mesh = pmesh.local_mesh(resolve_device(device))
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f'the mesh runs on {mesh.device}, not {device}')
        if num_rays % mesh.size:
            raise ValueError(f'num_rays {num_rays} must divide the mesh size '
                             f'{mesh.size}')
        self.mesh = mesh
        self.device = resolve_device(mesh.device)
        self.grid_kind = nerf_mod.grid_kind(model_cfg.grid)
        self.is_latent = self.grid_kind == 'latent'
        if not self.is_latent and (cfg.random_lod or cfg.grow_every > 0):
            raise ValueError(
                'random_lod / LOD-growth curricula are LatentGrid-only '
                '(alternative backbones ignore lod_mask)')
        if self.grid_kind in ('octree', 'codebook') and structure is None:
            if getattr(dataset, 'pointcloud', None) is not None:
                structure = og.OctreeStructure.from_pointcloud(
                    model_cfg.grid, dataset.pointcloud, device=self.device)
            else:
                structure = og.OctreeStructure.make_dense(
                    model_cfg.grid, device=self.device)
        self.structure = structure
        self.structure_tables = (structure.tables()
                                 if structure is not None else None)
        if self.is_latent and model_cfg.grid.hash_layout == 'paged':
            # segment grouping follows the grid's page geometry
            tracer_cfg = replace(tracer_cfg,
                                 group_res=ph.group_res_of(
                                     model_cfg.grid.page_res))
        if tracer_cfg.super_factor > 1 and tracer_cfg.super_dilation == 0:
            # the least conservative super-cull dilation for these bounds
            tracer_cfg = replace(tracer_cfg, super_dilation=(
                rf_tracer.super_dilation_for(
                    tracer_cfg, model_cfg.occ_cfg, float(dataset.dist_min),
                    float(dataset.dist_max))))
        self.tracer_cfg = tracer_cfg
        # the step's config: the base one with adapted budgets
        self.active_tracer_cfg = tracer_cfg
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.num_rays = num_rays
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.np_rng = np.random.RandomState(seed)
        self.log_dir = log_dir
        self.best_val_psnr = -np.inf
        self.val_best_params = None

        gcfg = model_cfg.grid
        self.ldecode_enabled = self.is_latent and gcfg.ldec is not None
        self.entropy_enabled = self.ldecode_enabled and gcfg.entropy_enabled
        self.affine = self.is_latent and lg.supports_affine_fusion(gcfg)
        params = nerf_mod.nerf_init(self.generator, model_cfg, self.device,
                                    structure)
        # codebook-side table work on T/n rows a rank: the SGA quantize,
        # the affine decode, the rate loss and the codebook's Adam moments
        self.shard_table_work = (
            mesh.group is not None and self.is_latent
            and params['grid']['codebook'].shape[0] % mesh.size == 0)
        self.set_params(params)
        # the rate-loss noise exists for the latent grid only
        self.noise = (torch.zeros_like(self.params['grid']['codebook'])
                      if self.is_latent else
                      torch.zeros((1,), device=self.device))
        self.voxel = tracer_cfg.raymarch_type == 'voxel'
        if getattr(dataset, 'pointcloud', None) is not None:
            # depth-captured scenes (RTMV): the occupancy starts as the
            # cells of the depth point cloud
            self.occ_state = occ.occupancy_from_points(
                model_cfg.occ_cfg, dataset.pointcloud, self.device)
        else:
            self.occ_state = occ.occupancy_init(model_cfg.occ_cfg,
                                                self.device)
        self.use_paged = (self.affine and gcfg.hash_layout == 'paged'
                          and (tracer_cfg.segment_size > 0 or self.voxel)
                          and tracer_cfg.eval_seg_budget > 0)
        if tracer_cfg.segment_size > 0:
            rf_tracer.validate_segment_cover(
                tracer_cfg, model_cfg.occ_cfg, float(dataset.dist_min),
                float(dataset.dist_max))
            self._refresh_coarse()
        if self.use_paged and self.voxel:
            # a crossing's samples lie in one occupancy cell: within its
            # diagonal of the center sample ([0,1] coords)
            ph.validate_paged_cover(
                gcfg.spec, float(np.sqrt(3.0)) / model_cfg.occ_cfg.res)
        elif self.use_paged:
            gss = tracer_cfg.group_seg_size or tracer_cfg.segment_size
            if tracer_cfg.segment_size % gss:
                raise ValueError(f'group_seg_size {gss} must divide '
                                 f'segment_size {tracer_cfg.segment_size}')
            # [-1,1] -> [0,1] halves distances; the grouping cell is keyed
            # on the sub-segment's center sample: one spacing of slack
            span = float(dataset.dist_max) - float(dataset.dist_min)
            ph.validate_paged_cover(
                gcfg.spec, span * (gss / 2 + 1) / tracer_cfg.num_steps / 2.0)
        # the Adam moments start at zero on every rank
        pmesh.replicate(mesh, (self.params, self.noise, self.occ_state))

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
        if self.shard_table_work:
            # this rank's rows of the codebook's moments
            rows = self._table_rows
            for m in (self.opt_state['mu'], self.opt_state['nu']):
                cb = m['grid']['codebook']
                if cb.shape[0] != rows.stop - rows.start:
                    m['grid']['codebook'] = cb[rows].clone()

    @property
    def _table_rows(self) -> Optional[slice]:
        """This rank's codebook rows under ``shard_table_work``."""
        if not self.shard_table_work:
            return None
        return pmesh.row_sharding(self.mesh,
                                  self.params['grid']['codebook'].shape[0])

    def _rank_trace(self):
        """(tracer config, ray rows) of this rank's trace: with a mesh of
        n > 1 ranks and budgets that divide n, its ``R/n`` rays at
        budgets/n (``rf_tracer.per_device_cfg``); else every ray at the
        step's budgets, on every rank (``None`` rows)."""
        tcfg, mesh = self.active_tracer_cfg, self.mesh
        if mesh.size == 1:
            return tcfg, None
        try:
            cfg = rf_tracer.per_device_cfg(tcfg, mesh.size)
        except ValueError:
            return tcfg, None
        return cfg, pmesh.batch_sharding(mesh, self.num_rays)

    @property
    def _shard_ray_active(self) -> bool:
        """Each rank traces only its rays (see :meth:`_rank_trace`)."""
        return self._rank_trace()[1] is not None

    @property
    def is_writer(self) -> bool:
        """This process writes logs, checkpoints and renders: rank 0."""
        return self.mesh.rank == 0

    def set_occupancy(self, occ_state: dict):
        """Install an occupancy state and rebuild the grids derived from
        it."""
        self.occ_state = occ_state
        if self.tracer_cfg.segment_size > 0:
            self._refresh_coarse()

    def _refresh_coarse(self):
        """Recompute the segmented march's grids derived from the occupancy
        (which changes only at prune time): the coarse culling grid, with
        ``term_tau`` the packed coarse grid, with ``super_factor`` the
        super grid, and with ``fine_mode='kernel'`` the packed occupancy
        grid of B2's occupancy row and the dilated fine grid of the
        grouping."""
        ocfg, tcfg = self.model_cfg.occ_cfg, self.tracer_cfg
        base = {k: v for k, v in self.occ_state.items()
                if k not in ('coarse', 'coarse2', 'super', 'occ_packed',
                             'fine_dil')}
        new = dict(base, coarse=rf_tracer.coarse_dilated_occupancy(
            base, ocfg, tcfg))
        if tcfg.term_tau > 0:
            new['coarse2'] = rf_tracer.coarse_packed_grid(base, ocfg, tcfg)
        if tcfg.super_factor > 1:
            new['super'] = rf_tracer.super_grid(base, ocfg, tcfg)
        if tcfg.fine_mode == 'kernel':
            new['occ_packed'] = ph.pack_occupancy(base['occ'])
            new['fine_dil'] = rf_tracer.fine_dilated_occupancy(base, ocfg)
        self.occ_state = new

    def _encode_split(self, params: dict, parts, kernel_occ: bool = False,
                      lod_mask: Optional[torch.Tensor] = None):
        """(zbar_fn, finish_fn, head_fn) of the paged trace; with
        ``kernel_occ`` zbar_fn also returns B2's occupancy row; finish_fn
        applies ``lod_mask``."""
        mcfg, tcfg = self.model_cfg, self.tracer_cfg
        # 'voxel': a segment is one crossing's num_steps samples
        seg_group = (tcfg.num_steps if self.voxel
                     else tcfg.group_seg_size or tcfg.segment_size)

        if kernel_occ:
            ld = mcfg.grid.effective_latent_dim

            def zbar_fn(coords, grouping):
                zb = nerf_mod.nerf_zbar(mcfg, coords, grouping, seg_group,
                                        affine=parts,
                                        occ=self.occ_state['occ_packed'])
                return zb[:, :-ld], zb[:, -ld]
        else:
            def zbar_fn(coords, grouping):
                return nerf_mod.nerf_zbar(mcfg, coords, grouping, seg_group,
                                          affine=parts)

        def finish_fn(zbar_c, coords_c):
            return nerf_mod.nerf_finish_feats(mcfg, zbar_c, coords_c,
                                              affine=parts, lod_mask=lod_mask)

        def head_fn(feats, dirs):
            return nerf_mod.nerf_head(params, mcfg, feats, dirs)

        return zbar_fn, finish_fn, head_fn

    def draw_step(self, use_sga: bool, refresh_noise: bool = True
                  ) -> StepDraws:
        """Draw one step's randomness from the trainer's generator."""
        gen, dev = self.generator, self.device
        sga_u = noise = None
        if use_sga:
            sga_u = sga_uniform(self.params['grid']['codebook'].shape, gen,
                                dev)
        if self.entropy_enabled:
            cb = self.params['grid']['codebook']
            if self.cfg.noise_freq == 1 or refresh_noise:
                self.noise = torch.rand(cb.shape, generator=gen,
                                        device=dev) - 0.5
            noise = self.noise
        march_u = torch.rand(
            rf_tracer.march_jitter_shape(self.active_tracer_cfg,
                                         self.num_rays),
            generator=gen, device=dev)
        return StepDraws(march_u=march_u, sga_u=sga_u, noise=noise)

    def step(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
             gt: torch.Tensor, draws: StepDraws, *, ent_lambda: float,
             temperature: float, lr_ldec: float, use_sga: bool,
             lod_mask: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One training step: trace (``active_tracer_cfg``; ``lod_mask``
        [num_lods] 0/1 masks the grid features of LODs), L1 + rate loss,
        backward, Adam (in place on ``self.params`` / ``self.opt_state``).

        With a mesh the rays are this rank's (its ``R/n`` rows when
        :attr:`_shard_ray_active`, else the whole batch) and ``draws`` the
        step's whole draws, of which the rank keeps its march-jitter rows
        and, under ``shard_table_work``, its codebook rows.  Each rank's
        loss is weighted so that the mean of the ranks' gradients is the
        gradient of the global batch: the L1 term is its rays' mean and
        the rate term n times its rows' share.  The metrics are the global
        batch's."""
        cfg, mcfg = self.cfg, self.model_cfg
        tcfg, ray_rows = self._rank_trace()
        table_rows = self._table_rows
        gcfg = mcfg.grid
        p = self.params
        trained = [(path, leaf) for path, leaf
                   in optim.tree_leaves_with_path(p) if leaf.requires_grad]
        march_u, sga_u, noise = draws.march_u, draws.sga_u, draws.noise
        if ray_rows is not None and march_u.dim() > 1:
            march_u = march_u[ray_rows]      # the lean march's seed is whole
        grid = p['grid']
        if table_rows is not None:
            sga_u = None if sga_u is None else sga_u[table_rows]
            noise = None if noise is None else noise[table_rows]
            grid = dict(grid, codebook=grid['codebook'][table_rows])
            if self.affine:
                # the rows' gradient, summed over the ranks by the
                # all-gather's backward
                grid['codebook'] = grid['codebook'].detach().requires_grad_()
                cb_path = ('grid', 'codebook')
                trained = [(path, grid['codebook'] if path == cb_path
                            else leaf) for path, leaf in trained]

        with record_function('step/decode'):
            if self.affine:
                parts = lg.affine_parts(grid, gcfg, use_sga=use_sga,
                                        temperature=temperature, sga_u=sga_u)
                if table_rows is not None:
                    parts = (pmesh.all_gather_rows(self.mesh, parts[0]),
                             ) + tuple(parts[1:])
            elif self.is_latent:
                decoded = lg.decode_codebook(p['grid'], gcfg, use_sga=use_sga,
                                             temperature=temperature,
                                             sga_u=draws.sga_u)

        def field_fn(coords, dirs):
            if not self.is_latent:
                return nerf_mod.nerf_rgba(p, mcfg, coords, dirs,
                                          structure=self.structure_tables,
                                          training=True)
            if self.affine:
                return nerf_mod.nerf_rgba(p, mcfg, coords, dirs, affine=parts,
                                          lod_mask=lod_mask)
            return nerf_mod.nerf_rgba(p, mcfg, coords, dirs, decoded=decoded,
                                      lod_mask=lod_mask)

        d = self.dataset
        rays = make_rays(rays_o, rays_d, d.dist_min, d.dist_max)
        split = (self._encode_split(
                     p, parts, tcfg.fine_mode == 'kernel' and not self.voxel,
                     lod_mask)
                 if self.use_paged else None)
        rb = rf_tracer.trace(field_fn, self.occ_state, mcfg.occ_cfg, tcfg,
                             rays, march_u, encode_split=split)
        rgb_loss = torch.mean(torch.abs(rb['rgb'] - gt))
        loss = cfg.rgb_loss_weight * rgb_loss
        avg_bits = torch.zeros((), device=self.device)
        if self.entropy_enabled:
            with record_function('step/rate_loss'):
                # over T/n rows: bits / (T/n), n times the rows' share
                avg_bits, _ = lg.ent_loss(grid, gcfg, noise)
            loss = loss + ent_lambda * avg_bits
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
        with record_function('step/adam'):
            optim.adam_update_mesh(
                grads, self.opt_state, p, self.labels, lrs, wd, self.mesh,
                row_paths=[('grid', 'codebook')] if self.shard_table_work
                else [], decoupled=cfg.optimizer_type == 'adamw')
        rgb = rb['rgb'].detach()
        mse = torch.mean((rgb - gt) ** 2)
        rgb_loss, mse, avg_bits = pmesh.all_reduce_sum(self.mesh, torch.stack(
            [rgb_loss.detach(), mse, avg_bits.detach()])) / self.mesh.size
        return {'loss': cfg.rgb_loss_weight * rgb_loss + ent_lambda * avg_bits,
                'rgb_loss': rgb_loss, 'psnr': 10.0 * torch.log10(1.0 / mse)}

    @torch.no_grad()
    def prune(self, u: Optional[torch.Tensor] = None):
        """Occupancy prune; ``u`` [num_cells, 3] U(0,1) cell jitter (in
        grouped cell order on the paged layout, see ``nerf.prune``)."""
        ocfg = self.model_cfg.occ_cfg
        if u is None:
            u = torch.rand((ocfg.num_cells, 3), generator=self.generator,
                           device=self.device)
        # one occupancy on every rank, whatever their float sums
        self.set_occupancy(pmesh.replicate(self.mesh, nerf_mod.prune(
            self.params, self.model_cfg, self.occ_state, u,
            structure=self.structure_tables)))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _probe_fraction(self, body, jitter_shape, jitter=None) -> float:
        """``body(rays, jitter)`` -> a scalar tensor, on one presampled ray
        batch (drawn from the ray stream, as the JAX trainer draws it);
        ``jitter`` U(0,1) of ``jitter_shape``, drawn when None.  One host
        readback: probes run once per prune, never in a step."""
        d = self.dataset
        ro, rd, _ = self._presample(1)
        rays = make_rays(torch.as_tensor(ro[0], device=self.device),
                         torch.as_tensor(rd[0], device=self.device),
                         d.dist_min, d.dist_max)
        if jitter is None:
            jitter = torch.rand(jitter_shape, generator=self.generator,
                                device=self.device)
        return float(body(rays, jitter))

    def _occupied_sample_fraction(self, jitter=None) -> float:
        """Fraction of march samples of real rays in occupied cells (camera
        rays concentrate on the occupied region, so this can far exceed the
        occupied volume fraction); ``jitter`` [num_rays, num_steps]."""
        base = self.tracer_cfg

        def body(rays, u):
            m = occ.raymarch_ray(self.occ_state, self.model_cfg.occ_cfg,
                                 rays, base.num_steps, u)
            return torch.mean(m['mask'].float())

        return self._probe_fraction(body, (self.num_rays, base.num_steps),
                                    jitter)

    def _live_segment_fraction(self, jitter=None) -> float:
        """Fraction of segments that survive the (non-lean) stage-1 cull of
        the base config, ``term_tau`` included; ``jitter`` [num_rays,
        num_steps]."""
        base = self.tracer_cfg

        def body(rays, u):
            _, _, mask_c = rf_tracer.coarse_segment_live(
                self.occ_state, self.model_cfg.occ_cfg, base, rays, u)
            return torch.mean(mask_c.float())

        return self._probe_fraction(body, (self.num_rays, base.num_steps),
                                    jitter)

    def _live_cell_hits_per_ray(self, jitter=None) -> float:
        """Mean occupied-cell crossings per ray of the base config's voxel
        march (at most ``max_intersections``; with ``term_tau`` the ones in
        front of the estimated optical depth); ``jitter`` [num_rays,
        max_intersections, num_steps]."""
        base = self.tracer_cfg
        I, S = base.max_intersections, base.num_steps

        def body(rays, u):
            ocfg = self.model_cfg.occ_cfg
            m = occ.raymarch_voxel(self.occ_state, ocfg, rays, S, u, I)
            R = rays.origins.shape[0]
            live = m['mask'].reshape(R, I, S).any(dim=-1)
            if base.term_tau > 0:
                live = live & rf_tracer.voxel_term_mask(
                    self.occ_state, ocfg, m, R, I, S, base.term_tau)
            return torch.mean(torch.sum(live.float(), dim=-1))

        return self._probe_fraction(body, (self.num_rays, I, S), jitter)

    def _adapt_budget(self):
        """Set ``active_tracer_cfg``'s budgets from the probes
        (:func:`adapted_budgets`): the sample budget, and on a march with a
        paged second stage the segment budgets, which size every stage
        after the cull (grouping, B2/B3, compaction, head).  The voxel
        march reads the occupied cell fraction (one host read) and probes
        its live crossings per ray."""
        base = self.tracer_cfg
        if base.max_samples <= 0:
            return
        if self.voxel:
            frac = float(torch.mean(self.occ_state['occ'].float()))
            seg = (self._live_cell_hits_per_ray()
                   if base.eval_seg_budget > 0 else None)
        else:
            frac = self._occupied_sample_fraction()
            seg = (self._live_segment_fraction()
                   if base.segment_size > 0 and base.eval_seg_budget > 0
                   else None)
        # rank 0's probes set every rank's budgets: ranks whose budgets
        # differed would deadlock in the step's collectives
        frac, seg = pmesh.broadcast_object(self.mesh, (frac, seg))
        new = adapted_budgets(base, self.num_rays, frac, seg,
                              self.cfg.min_budget, self.cfg.budget_headroom)
        self.active_tracer_cfg = replace(base, **new)

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

    def _lod_masks(self, iterations) -> Optional[np.ndarray]:
        """[n, num_lods] f32 LOD masks of a chunk's steps under the random
        LOD curriculum (a max LOD per step with weights 2^i, from the ray
        stream) or the growth curriculum; None without a curriculum."""
        cfg = self.cfg
        num_lods = self.model_cfg.grid.num_lods
        n = len(iterations)
        if cfg.random_lod:
            w = 2.0 ** np.arange(num_lods)
            lods = self.np_rng.choice(num_lods, size=n, p=w / w.sum())
            return (np.arange(num_lods)[None, :]
                    <= lods[:, None]).astype(np.float32)
        if cfg.grow_every > 0:
            masks = np.zeros((n, num_lods), np.float32)
            for i, it in enumerate(iterations):
                masks[i, grow_loss_lods(self._epoch_of(it), num_lods,
                                        cfg.grow_every,
                                        cfg.growth_strategy)] = 1.0
            return masks
        return None

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
            # chunks stop at the validation, checkpoint and render epochs
            e0 = self._epoch_of(it0)
            for every in (cfg.valid_every, cfg.save_every,
                          cfg.render_tb_every):
                if every > 0:
                    nxt = (((e0 - 1) // every) + 1) * every \
                        * self.iters_per_epoch
                    n = min(n, max(1, nxt - self.iteration))
            use_sga = (self.ldecode_enabled and cfg.use_sga
                       and (e0 / cfg.epochs) <= cfg.decay_period)
            with record_function('step/presample'):
                # drawn before the ray batches, from the same stream, as the
                # JAX trainer draws them
                masks = self._lod_masks(range(it0, it0 + n))
                # one upload a chunk: each host-to-device copy syncs the
                # stream; every rank draws the global batch and, tracing its
                # own rays, keeps its part of it
                batch = self._presample(n)
                if self._shard_ray_active:
                    ro, rd, gt = pmesh.shard_axis(self.mesh, 1, *batch)
                else:
                    ro, rd, gt = (torch.as_tensor(a, device=self.device)
                                  for a in batch)
                if masks is not None:
                    masks = torch.as_tensor(masks, device=self.device)
            for i in range(n):
                it = it0 + i
                e = self._epoch_of(it)
                with self.step_lock:
                    with record_function('step/draws'):
                        draws = self.draw_step(use_sga, refresh_noise=(
                            (it - 1) % max(cfg.noise_freq, 1) == 0))
                    metrics = self.step(ro[i], rd[i], gt[i], draws,
                        ent_lambda=self.entropy_reg_sched(e),
                        temperature=self.temperature_sched(e),
                        lr_ldec=self.ldec_lr_sched(e), use_sga=use_sga,
                        lod_mask=None if masks is None else masks[i])
                    self.iteration = it
            done += n
            if (cfg.prune_every > 0 and self.iteration > 1
                    and self.iteration % cfg.prune_every == 0):
                with self.step_lock:
                    with record_function('step/prune'):
                        self.prune()
                    if cfg.adaptive_budget:
                        with record_function('step/adapt_budget'):
                            self._adapt_budget()
            if self.is_writer and (log_fn or self.logger is not None):
                with record_function('step/log'):
                    entry = {'iteration': self.iteration,
                             'epoch': self._epoch_of(self.iteration),
                             'loss': float(metrics['loss']),
                             'rgb_loss': float(metrics['rgb_loss']),
                             'psnr': float(metrics['psnr']),
                             'occupancy': float(torch.mean(
                                 self.occ_state['occ'].float())),
                             'elapsed': time.time() - t0}
                if cfg.adaptive_budget and self.tracer_cfg.max_samples > 0:
                    entry['sample_budget'] = \
                        self.active_tracer_cfg.max_samples
                if self.logger is not None:
                    for k in ('rgb_loss', 'psnr', 'occupancy'):
                        self.logger.scalar(f'train/{k}', entry[k],
                                           self.iteration)
                if log_fn:
                    log_fn(entry)
            self._post_chunk(log_fn)
        return {'iterations': self.iteration, 'elapsed': time.time() - t0}

    def _post_chunk(self, log_fn=None):
        """At epoch boundaries: validation (``valid_every``), the
        ``render/view0`` image (``render_tb_every``, through the logger)
        and the resume-state checkpoint (``save_every``, into
        ``log_dir``)."""
        cfg = self.cfg
        if self.iteration % self.iters_per_epoch != 0:
            return
        e = self.iteration // self.iters_per_epoch
        # every rank validates and renders, as one trainer would, so that
        # none waits in the next collective for rank 0; rank 0 logs
        if cfg.valid_every > 0 and e % cfg.valid_every == 0:
            m = self.validate()
            if self.is_writer and self.logger is not None:
                self.logger.scalar('valid/psnr', m['psnr'], self.iteration)
                self.logger.scalar('valid/ssim', m['ssim'], self.iteration)
            if self.is_writer and log_fn:
                log_fn({'epoch': e, 'valid_psnr': m['psnr'],
                        'valid_ssim': m['ssim'],
                        'best_val_psnr': self.best_val_psnr})
        if (cfg.render_tb_every > 0 and e % cfg.render_tb_every == 0
                and pmesh.broadcast_object(self.mesh,
                                           self.logger is not None)):
            img = self.render_view(0, dataset=self.val_dataset or self.dataset)
            if self.is_writer:
                self.logger.image('render/view0', img, self.iteration)
        if cfg.save_every > 0 and e % cfg.save_every == 0 and self.log_dir:
            # every rank: the moments' rows are gathered, rank 0 writes
            checkpoint.save_trainer(
                self, os.path.join(self.log_dir, 'resume_state.ckpt'))

    def validate(self) -> Dict[str, float]:
        """Render ``valid_views`` evenly spaced held-out views; on a new
        best validation PSNR keep a host copy of the params
        (``val_best_params``: Adam updates ``self.params`` in place)."""
        d = self.val_dataset or self.dataset
        stride = max(1, d.num_views // max(1, self.cfg.valid_views))
        m = self.evaluate(view_indices=range(0, d.num_views, stride),
                          dataset=d)
        if m['psnr'] > self.best_val_psnr:
            self.best_val_psnr = m['psnr']
            self.val_best_params = optim.tree_map(
                lambda t: t.detach().to('cpu', copy=True), self.params)
        if self.is_writer and self.logger is not None:
            self.logger.record({'iteration': self.iteration, **m})
        return m

    # ------------------------------------------------------------------
    @property
    def eval_tracer_cfg(self) -> rf_tracer.RFTracerConfig:
        """The base tracer config of renders: ``fine_mode='kernel'`` renders
        as ``'deferred'`` (rendering queries the fine occupancy itself)."""
        if self.tracer_cfg.fine_mode == 'kernel':
            return replace(self.tracer_cfg, fine_mode='deferred')
        return self.tracer_cfg

    @torch.no_grad()
    def eval_field_fn(self, params=None, lod_mask=None):
        """The field over ``params`` (default: the trainer's) in eval mode
        for renders outside the paged trace: the codebook decoded once
        (rounded latents, LODs masked by the device tensor ``lod_mask``),
        or an alternative backbone's eval mode (VQAD's argmax lookup) on
        the trainer's structure."""
        params = params if params is not None else self.params
        mcfg = self.model_cfg
        if not self.is_latent:
            def field_fn(coords, dirs):
                return nerf_mod.nerf_rgba(params, mcfg, coords, dirs,
                                          structure=self.structure_tables,
                                          training=False)
            return field_fn
        decoded = lg.decode_codebook(params['grid'], mcfg.grid)

        def field_fn(coords, dirs):
            return nerf_mod.nerf_rgba(params, mcfg, coords, dirs,
                                      decoded=decoded, lod_mask=lod_mask)
        return field_fn

    @torch.no_grad()
    def render_view(self, view_idx: int, ray_batch: int = 4096,
                    generator: Optional[torch.Generator] = None,
                    dataset=None, params=None,
                    lod_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Render one view in eval mode (rounded latents, decoded once; on
        the paged path the eval-mode affine parts, decoded after the
        block-local interpolation) with the base tracer config; ``lod_mask``
        [num_lods] masks LODs."""
        d = dataset if dataset is not None else self.dataset
        params = params if params is not None else self.params
        mcfg, tcfg = self.model_cfg, self.eval_tracer_cfg
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        if lod_mask is not None:
            lod_mask = torch.as_tensor(lod_mask, dtype=torch.float32,
                                       device=self.device)
        split = None
        if self.use_paged:
            parts = lg.affine_parts(params['grid'], mcfg.grid)
            split = self._encode_split(params, parts, lod_mask=lod_mask)
            field_fn = None
        else:
            field_fn = self.eval_field_fn(params, lod_mask=lod_mask)

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
        """Mean float PSNR and SSIM over views, and LPIPS(VGG) when
        ``SHACIRA_LPIPS_WEIGHTS`` names a weight file (``ops/lpips.py``)."""
        d = dataset if dataset is not None else self.dataset
        if view_indices is None:
            view_indices = range(d.num_views)
        lpips_w = None
        if os.environ.get(lpips_mod.ENV_VAR):
            lpips_w = lpips_mod.load_lpips_weights(device=self.device)
        psnrs, ssims, lpipses = [], [], []
        for v in view_indices:
            pred = torch.as_tensor(self.render_view(v, dataset=d),
                                   device=self.device)
            gtv = torch.as_tensor(d.rgb[v].reshape(d.h, d.w, 3),
                                  device=self.device)
            psnrs.append(float(psnr(pred, gtv)))
            ssims.append(float(ssim(pred, gtv)))
            if lpips_w is not None:
                lpipses.append(lpips_mod.lpips(torch.clamp(pred, 0, 1), gtv,
                                               weights=lpips_w))
        out = {'psnr': float(np.mean(psnrs)), 'ssim': float(np.mean(ssims))}
        if lpipses:
            out['lpips'] = float(np.mean(lpipses))
        return out

    def size_report(self, use_codec: bool = False, params=None
                    ) -> Dict[str, float]:
        """Decoder, latent, MLP and total sizes in kB.  With ``use_codec``
        the latent size is the length of real arithmetic codestreams, and,
        with an entropy model, the smaller decodable stream of two: the
        histogram-coded one (``latent_size_kb_hist``, with its alphabet and
        CDF side information) or the prob-model-coded one
        (``latent_size_kb_pm``, with the model's parameters); ``stream``
        names the one chosen.  The grid is copied to the host once."""
        params = params if params is not None else self.params
        gcfg = self.model_cfg.grid
        if not self.is_latent:
            return self._backbone_size_report(params, use_codec)
        grid = optim.tree_map(lambda t: t.detach().cpu(), params['grid'])
        has_pm = use_codec and 'prob_model' in grid
        ldec_bits, latent_bits = lg.grid_size_bits(
            grid, gcfg, use_codec=use_codec, count_side_info=has_pm)
        rest = nerf_mod.non_grid_size_bits(params)
        out = {}
        if has_pm:
            _, pm_bits = lg.grid_size_bits(grid, gcfg, use_codec=use_codec,
                                           use_prob_model=True,
                                           count_side_info=True)
            out['latent_size_kb_hist'] = latent_bits / 8e3
            out['total_size_kb_hist'] = (ldec_bits + latent_bits
                                         + rest) / 8e3
            out['latent_size_kb_pm'] = pm_bits / 8e3
            out['stream'] = ('histogram' if latent_bits <= pm_bits
                             else 'prob_model')
            latent_bits = min(latent_bits, pm_bits)
        total = ldec_bits + latent_bits + rest
        out.update({'ldec_size_kb': ldec_bits / 8e3,
                    'latent_size_kb': latent_bits / 8e3,
                    'remainder_size_kb': rest / 8e3,
                    'total_size_kb': total / 8e3})
        return out

    def _backbone_size_report(self, params: dict, use_codec: bool
                              ) -> Dict[str, float]:
        """Sizes in kB of an alternative backbone: VQAD's entropy-coded
        argmax indices (real codestreams with ``use_codec``) and f32
        dictionaries, the octree and triplanar tables as f32; the MLPs
        as stored."""
        rest = nerf_mod.non_grid_size_bits(params)
        if self.grid_kind == 'codebook':
            _, gbits = og.codebook_grid_size_bits(params['grid'],
                                                  use_codec=use_codec)
        elif self.grid_kind == 'octree':
            gbits = og.grid_size_bits(params['grid'])
        else:
            gbits = tg.grid_size_bits(params['grid'])
        return {'grid_size_kb': gbits / 8e3,
                'remainder_size_kb': rest / 8e3,
                'total_size_kb': (gbits + rest) / 8e3}
