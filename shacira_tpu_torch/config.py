"""Configuration: argparse groups + YAML, CLI > YAML > defaults.

Port of ``shacira_tpu/config.py`` for the image and NeRF apps.  Argument
groups double as YAML sections; a YAML file given with ``--config`` sets
parser defaults (explicit CLI flags win) with one level of ``parent:``
inheritance, and an unknown key raises.  The flag surface is the JAX
package's, so ``configs/kodak.yaml``, ``configs/pearl.yaml``,
``configs/nerf_base.yaml`` and ``configs/nerf_lego.yaml`` load as they are,
and so do the other backbones' configs (``nerf_octree``, ``nerf_codebook``,
``nerf_triplanar``, ``nerf_hash``).  ``--rng-impl`` selects a JAX generator
and is accepted without effect (the port draws from one
``torch.Generator``).  ``--ldecode-type`` other than 'single' raises: the
JAX apps parse it but never pass it on, so they always build a single
decoder.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import yaml


def _bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ('1', 'true', 'yes', 'on')


def build_image_parser(description: str = 'SHACIRA image INR training '
                       '(PyTorch/CUDA)') -> argparse.ArgumentParser:
    """Argument surface of the image app (the JAX package's image parser,
    ``--device`` in place of its ``--platform``)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--config', type=str, help='Path to YAML config')
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default) or 'cpu'")

    g = parser.add_argument_group('logging')
    g.add_argument('--exp-name', type=str, default='unnamed')
    g.add_argument('--log-dir', type=str, default='_results/logs/runs')
    g.add_argument('--log-every', type=int, default=1000)
    g.add_argument('--valid-every', type=int, default=-1)
    g.add_argument('--save-every', type=int, default=5000)
    g.add_argument('--render-tb-every', type=int, default=-1)
    g.add_argument('--metrics-only', action='store_true')

    g = parser.add_argument_group('dataset')
    g.add_argument('--dataset-path', type=str, default=None)
    g.add_argument('--dataloader-num-workers', type=int, default=0)
    g.add_argument('--num-samples', type=int, default=-1)
    g.add_argument('--sample-mode', type=str, default='full',
                   choices=['full', 'woreplace', 'sequential', 'wreplace',
                            'eval'])

    g = parser.add_argument_group('nef')
    g.add_argument('--hidden-dim', type=int, default=128)
    g.add_argument('--num-layers', type=int, default=1)
    g.add_argument('--pos-embedder', type=str, default='none')
    g.add_argument('--pos-multires', type=int, default=10)
    g.add_argument('--position-input', type=_bool, default=False)
    g.add_argument('--activation-type', type=str, default='relu')
    g.add_argument('--final-activation', type=str, default='none')

    g = parser.add_argument_group('grid')
    g.add_argument('--grid-type', type=str, default='LatentGrid')
    g.add_argument('--interpolation-type', type=str, default='linear')
    g.add_argument('--multiscale-type', type=str, default='cat')
    g.add_argument('--feature-dim', type=int, default=2)
    g.add_argument('--feature-std', type=float, default=0.0)
    g.add_argument('--feature-bias', type=float, default=0.0)
    g.add_argument('--num-lods', type=int, default=16)
    g.add_argument('--base-lod', type=int, default=2)
    g.add_argument('--codebook-bitwidth', type=int, default=8)
    g.add_argument('--hash-layout', type=str, default='xor',
                   choices=['xor', 'paged'])
    g.add_argument('--page-res', type=int, default=16)
    g.add_argument('--tree-type', type=str, default='geometric')
    g.add_argument('--min-grid-res', type=int, default=16)
    g.add_argument('--max-grid-res', type=int, default=512)
    g.add_argument('--blas-level', type=int, default=7)
    g.add_argument('--init-grid', type=str, default='normal')
    g.add_argument('--prune-min-density', type=float,
                   default=(0.01 * 512) / np.sqrt(3))
    g.add_argument('--prune-density-decay', type=float, default=0.6)

    g = parser.add_argument_group('latent_decoder')
    g.add_argument('--ldecode-enabled', type=_bool, default=False)
    g.add_argument('--ldecode-type', type=str, default='single')
    g.add_argument('--use-sga', type=_bool, default=False)
    g.add_argument('--diff-sampling', type=_bool, default=False)
    g.add_argument('--use-shift', type=_bool, default=False)
    g.add_argument('--ldecode-matrix', type=str, default='sq')
    g.add_argument('--latent-dim', type=int, default=0)
    g.add_argument('--norm', type=str, default='none')
    g.add_argument('--norm-every', type=int, default=10)
    g.add_argument('--ldec-std', type=float, default=1.0)
    g.add_argument('--decay-period', type=float, default=0.9)
    g.add_argument('--temperature', type=float, default=1.0)
    g.add_argument('--num-layers-dec', type=int, default=0)
    g.add_argument('--hidden-dim-dec', type=int, default=0)
    g.add_argument('--activation-dec', type=str, default='none')
    g.add_argument('--clamp-weights', type=float, default=0.0)
    g.add_argument('--num-dec', type=int, default=2)

    g = parser.add_argument_group('entropy_reg')
    g.add_argument('--num-prob-layers', type=int, default=4)
    g.add_argument('--entropy-reg', type=float, default=0.0)
    g.add_argument('--entropy-reg-end', type=float, default=0.0)
    g.add_argument('--entropy-reg-sched', type=str, default='cosine')
    g.add_argument('--noise-freq', type=int, default=1)
    g.add_argument('--rng-impl', type=str, default='threefry')

    g = parser.add_argument_group('optimizer')
    g.add_argument('--optimizer-type', type=str, default='adam')
    g.add_argument('--lr', type=float, default=0.001)
    g.add_argument('--grid-lr', type=float, default=0.02)
    g.add_argument('--scale-grid-lr', type=str, default='none')
    g.add_argument('--ldec-lr', type=float, default=0.01)
    g.add_argument('--ldec-lr-warmup', type=int, default=10)
    g.add_argument('--weight-decay', type=float, default=0.0)
    g.add_argument('--weight-decay-decoder', type=float, default=0.0)
    g.add_argument('--rgb-loss', type=float, default=1.0)
    g.add_argument('--disable-amp', type=_bool, default=True)
    g.add_argument('--disable-scaler', type=_bool, default=True)

    g = parser.add_argument_group('trainer')
    g.add_argument('--epochs', type=int, default=250)
    g.add_argument('--batch-size', type=int, default=1)
    g.add_argument('--model-format', type=str, default='full')
    g.add_argument('--resume', type=_bool, default=False)
    g.add_argument('--valid-only', action='store_true')
    g.add_argument('--pretrained', type=str, default=None)
    g.add_argument('--chunk-size', type=int, default=500)
    g.add_argument('--profile', action='store_true')
    g.add_argument('--seed', type=int, default=0)
    g.add_argument('--resample', type=_bool, default=False)
    g.add_argument('--resample-every', type=int, default=1)

    return parser


def build_nerf_parser() -> argparse.ArgumentParser:
    """Argument surface of the NeRF app (the image parser plus the NeRF
    groups, with NeRF defaults)."""
    parser = build_image_parser('SHACIRA NeRF training (PyTorch/CUDA)')
    # the NeRF path trains with AMP on: a bf16 MLP head
    parser.set_defaults(disable_amp=False)

    g = parser.add_argument_group('tracer')
    g.add_argument('--raymarch-type', type=str, default='ray',
                   choices=['ray', 'voxel'])
    g.add_argument('--num-steps', type=int, default=1024)
    g.add_argument('--step-size', type=float, default=1.0)
    g.add_argument('--bg-color', type=str, default='white')
    g.add_argument('--max-intersections', type=int, default=64)
    g.add_argument('--max-samples', type=int, default=0)
    g.add_argument('--segment-size', type=int, default=0)
    g.add_argument('--seg-budget', type=int, default=0)
    g.add_argument('--coarse-level', type=int, default=5)
    g.add_argument('--seg-dilation', type=int, default=1)
    g.add_argument('--eval-seg-budget', type=int, default=0)
    g.add_argument('--group-segs-per-block', type=int, default=8)
    g.add_argument('--group-seg-size', type=int, default=0)
    g.add_argument('--fine-mode', type=str, default='exact',
                   choices=('exact', 'deferred', 'kernel'))
    g.add_argument('--term-tau', type=float, default=0.0)
    g.add_argument('--lean-stage1', type=_bool, default=False)
    g.add_argument('--super-factor', type=int, default=0)

    g = parser.add_argument_group('net')
    g.add_argument('--view-embedder', type=str, default='positional')
    g.add_argument('--view-multires', type=int, default=4)

    g = parser.add_argument_group('dataset_nerf')
    g.add_argument('--multiview-dataset-format', type=str, default='standard')
    g.add_argument('--dataset-num-workers', type=int, default=-1)
    g.add_argument('--mip', type=int, default=0)
    g.add_argument('--num-rays-sampled-per-img', type=int, default=4096)
    g.add_argument('--dataset-split', type=str, default='train')
    g.add_argument('--max-views', type=int, default=None)

    g = parser.add_argument_group('trainer_nerf')
    g.add_argument('--prune-every', type=int, default=-1)
    g.add_argument('--random-lod', type=_bool, default=False)
    g.add_argument('--adaptive-budget', type=_bool, default=False)
    g.add_argument('--budget-headroom', type=float, default=1.5)
    g.add_argument('--min-budget', type=int, default=16384)

    g = parser.add_argument_group('renderer')
    g.add_argument('--render-batch', type=int, default=4096)
    g.add_argument('--render-res', type=int, nargs=2, default=[1024, 1024])
    g.add_argument('--camera-origin', type=float, nargs=3,
                   default=[-3.0, 0.65, -3.0])
    g.add_argument('--overlay-layers', type=_bool, default=False)
    g.add_argument('--num-angles', type=int, default=20)
    g.add_argument('--turntable-res', type=int, default=0)
    return parser


def parse_yaml_config(config_path: str, parser: argparse.ArgumentParser):
    """Set parser defaults from a YAML file (one level of ``parent:``);
    sections are argument-group names, unknown fields raise."""
    with open(config_path) as f:
        config_dict = yaml.safe_load(f) or {}
    valid = {a.dest for group in parser._action_groups
             for a in group._group_actions}
    sections = []
    parent = config_dict.pop('parent', None)
    if parent is not None:
        if not os.path.isabs(parent):
            parent = os.path.join(os.path.dirname(config_path), parent)
        with open(parent) as f:
            parent_dict = yaml.safe_load(f) or {}
        if 'parent' in parent_dict:
            raise ValueError(
                'Hierarchical configs deeper than 1 level are not allowed.')
        sections += list(parent_dict.values())
    sections += list(config_dict.values())
    defaults = {}
    for section in sections:
        for field, value in (section or {}).items():
            if field not in valid:
                raise ValueError(
                    f'{field} is not a valid option (typo in config?)')
            defaults[field] = value
    parser.set_defaults(**defaults)
    return defaults


def parse_args(parser: argparse.ArgumentParser, argv=None):
    """CLI > YAML > defaults."""
    args = parser.parse_args(argv)
    if args.config is not None:
        parse_yaml_config(args.config, parser)
        args = parser.parse_args(argv)
    return args


def build_grid_config(args, resolution_dim: int = 3):
    """Grid config from parsed args: ``--grid-type`` picks the backbone as
    the JAX package does.  LatentGrid (SHACIRA, 'xor' or 'paged' layout,
    single decoder, geometric or octree LODs); HashGrid (Instant-NGP: the
    same table with ``latent_dim`` 0 and no latent decoder, whatever the
    latent_decoder section says); OctreeGrid (NGLOD), CodebookOctreeGrid
    (VQAD) and TriplanarGrid, 3D only.  The octree structure is built by
    the trainer."""
    from shacira_tpu_torch.models.grids.latent_grid import LatentGridConfig
    grid_type = args.grid_type
    if grid_type in ('OctreeGrid', 'CodebookOctreeGrid', 'TriplanarGrid'):
        if resolution_dim != 3:
            raise ValueError(f'{grid_type} is 3D-only (NeRF/SDF apps)')
        base = dict(feature_dim=args.feature_dim, base_lod=args.base_lod,
                    num_lods=args.num_lods,
                    multiscale_type=args.multiscale_type,
                    feature_std=args.feature_std,
                    feature_bias=args.feature_bias)
        if grid_type == 'OctreeGrid':
            from shacira_tpu_torch.models.grids.octree_grid import (
                OctreeGridConfig)
            return OctreeGridConfig(**base)
        if grid_type == 'CodebookOctreeGrid':
            from shacira_tpu_torch.models.grids.octree_grid import (
                CodebookOctreeGridConfig)
            return CodebookOctreeGridConfig(
                codebook_bitwidth=args.codebook_bitwidth, **base)
        from shacira_tpu_torch.models.grids.triplanar_grid import (
            TriplanarGridConfig)
        return TriplanarGridConfig(**base)
    if grid_type not in ('LatentGrid', 'HashGrid'):
        raise ValueError(f'Unknown grid_type: {grid_type}')
    if args.ldecode_type != 'single':
        raise NotImplementedError(
            f'ldecode_type={args.ldecode_type!r}: the JAX package\'s apps '
            'parse --ldecode-type but never pass it to with_ldec, so they '
            'always build a single decoder; build the multi and hierarchical '
            'decoders with LatentGridConfig.with_ldec(..., ldecode_type=...)')
    common = dict(
        feature_dim=args.feature_dim,
        latent_dim=0 if grid_type == 'HashGrid' else args.latent_dim,
        multiscale_type=args.multiscale_type,
        resolution_dim=resolution_dim, feature_std=args.feature_std,
        feature_bias=args.feature_bias,
        codebook_bitwidth=args.codebook_bitwidth, init_grid=args.init_grid,
        hash_layout=args.hash_layout, page_res=args.page_res,
        num_prob_layers=args.num_prob_layers, noise_freq=args.noise_freq,
        entropy_enabled=args.ldecode_enabled and (
            args.entropy_reg > 0 or args.entropy_reg_end > 0))
    if args.tree_type == 'geometric':
        cfg = LatentGridConfig.from_geometric(
            num_lods=args.num_lods, min_grid_res=args.min_grid_res,
            max_grid_res=args.max_grid_res, **common)
    else:
        cfg = LatentGridConfig.from_octree(
            base_lod=args.base_lod, num_lods=args.num_lods, **common)
    if args.ldecode_enabled and grid_type != 'HashGrid':
        cfg = cfg.with_ldec(dict(
            norm=args.norm, ldecode_matrix=args.ldecode_matrix,
            use_shift=args.use_shift, num_layers_dec=args.num_layers_dec,
            hidden_dim_dec=args.hidden_dim_dec,
            activation=args.activation_dec,
            clamp_weights=args.clamp_weights, ldec_std=args.ldec_std,
            use_sga=args.use_sga, diff_sampling=args.diff_sampling))
    return cfg


def build_image_model_config(args):
    from shacira_tpu_torch.models.nefs.image import NeuralImageConfig
    return NeuralImageConfig(
        grid=build_grid_config(args, resolution_dim=2),
        hidden_dim=args.hidden_dim, num_layers=args.num_layers,
        activation=args.activation_type,
        final_activation=args.final_activation,
        pos_embedder=args.pos_embedder, pos_multires=args.pos_multires,
        position_input=args.position_input)


def build_image_trainer_config(args):
    from shacira_tpu_torch.trainers.image_trainer import ImageTrainerConfig
    return ImageTrainerConfig(
        epochs=args.epochs, rgb_loss_weight=args.rgb_loss,
        optimizer_type=args.optimizer_type, lr=args.lr, grid_lr=args.grid_lr,
        ldec_lr=args.ldec_lr, scale_grid_lr=args.scale_grid_lr,
        weight_decay=args.weight_decay,
        weight_decay_decoder=args.weight_decay_decoder,
        ldec_lr_warmup=args.ldec_lr_warmup,
        use_sga=args.use_sga and args.ldecode_enabled,
        decay_period=args.decay_period, temperature=args.temperature,
        norm=args.norm, norm_every=args.norm_every,
        entropy_reg=args.entropy_reg, entropy_reg_end=args.entropy_reg_end,
        entropy_reg_sched=args.entropy_reg_sched, noise_freq=args.noise_freq,
        resample=args.resample, resample_every=args.resample_every,
        chunk_size=args.chunk_size, log_every=args.log_every,
        valid_every=args.valid_every, save_every=args.save_every,
        render_tb_every=args.render_tb_every)


def build_nerf_model_config(args):
    from shacira_tpu_torch.models.nefs.nerf import NeuralRadianceFieldConfig
    return NeuralRadianceFieldConfig(
        grid=build_grid_config(args, resolution_dim=3),
        hidden_dim=args.hidden_dim, num_layers=args.num_layers,
        activation=args.activation_type, pos_embedder=args.pos_embedder,
        view_embedder=args.view_embedder, pos_multires=args.pos_multires,
        view_multires=args.view_multires, position_input=args.position_input,
        prune_density_decay=args.prune_density_decay,
        prune_min_density=args.prune_min_density,
        blas_level=int(args.blas_level), amp=not args.disable_amp)


def build_nerf_trainer_config(args):
    from shacira_tpu_torch.trainers.multiview_trainer import (
        MultiviewTrainerConfig)
    return MultiviewTrainerConfig(
        epochs=args.epochs, rgb_loss_weight=args.rgb_loss,
        optimizer_type=args.optimizer_type, lr=args.lr, grid_lr=args.grid_lr,
        ldec_lr=args.ldec_lr, scale_grid_lr=args.scale_grid_lr,
        weight_decay=args.weight_decay,
        weight_decay_decoder=args.weight_decay_decoder,
        ldec_lr_warmup=args.ldec_lr_warmup,
        use_sga=args.use_sga and args.ldecode_enabled,
        decay_period=args.decay_period, temperature=args.temperature,
        entropy_reg=args.entropy_reg, entropy_reg_end=args.entropy_reg_end,
        entropy_reg_sched=args.entropy_reg_sched, noise_freq=args.noise_freq,
        prune_every=args.prune_every, random_lod=args.random_lod,
        adaptive_budget=args.adaptive_budget,
        budget_headroom=args.budget_headroom, min_budget=args.min_budget,
        chunk_size=args.chunk_size, valid_every=args.valid_every,
        save_every=args.save_every, render_tb_every=args.render_tb_every)


def build_tracer_config(args):
    """Tracer config ('ray' or 'voxel' march)."""
    from shacira_tpu_torch.tracers.rf_tracer import RFTracerConfig
    return RFTracerConfig(
        raymarch_type=args.raymarch_type, num_steps=args.num_steps,
        bg_color=args.bg_color, max_intersections=args.max_intersections,
        max_samples=args.max_samples, segment_size=args.segment_size,
        seg_budget=args.seg_budget, coarse_level=args.coarse_level,
        seg_dilation=args.seg_dilation, eval_seg_budget=args.eval_seg_budget,
        group_segs_per_block=args.group_segs_per_block,
        group_res=args.page_res // 2, group_seg_size=args.group_seg_size,
        fine_mode=args.fine_mode, term_tau=args.term_tau,
        lean_stage1=args.lean_stage1, super_factor=args.super_factor)
