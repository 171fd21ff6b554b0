#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``shacira_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--prune-every N]

Phases, each of which must pass (exit code 1 otherwise):

1. build    -- compile every CUDA source of the port with nvcc (sm_90a),
               and each again as its atomic-counting build, one nvcc per
               library, all at once, and print the build time;
2. kernels  -- call each kernel's wrapper on the card at the shapes of the
               lego training step and hold it against its plain PyTorch
               version (max error relative to the largest value <= 1e-5);
               time kernel, plain version and, where one PyTorch call
               computes the same function, that call, with CUDA events; and
               compute the least time the card could take (bytes over 3.35
               TB/s, or f32 operations over 67 TFLOP/s).  Scatter B1 (flat
               hash backward on random points and on the step's
               ray-ordered samples, per-ray sums), paged gather B2 (train
               and prune shapes) and paged scatter B3.  For B1 and B3 also
               count the updates (one global atomic each without merging),
               the global atomics the merging kernel issued (counted on the
               card by the same source built with -DCOUNT_GLOBAL_ATOMICS)
               and the distinct addresses per tile or kernel block;
3. parity   -- one small training step on the card against the same step of
               the port on the CPU (plain versions), same params and draws,
               on the flat layout and on the paged layout;
4. lego     -- read configs/nerf_lego.yaml with the port's config reader and
               train at full lego width (4096 rays x 2048 steps, 1,048,576
               compacted samples, 24 LODs at 2^19, hidden 128, bf16 head) on
               an analytic scene built in memory, across one prune (4 steps
               past it), then evaluate one view.  Launch counts are zeroed
               just before and read just after; B1(a) and B1(b) must have
               launched;
5. profile  -- device time by step stage and host syncs per step under
               torch.profiler, after the prune and before the first one;
6. paged    -- the same lego config on the paged layout (the flags of
               ``PAGED_FLAGS``: segmented deferred march, segment grouping,
               block-local encode through B2/B3, 262,144-row compaction),
               trained across the prune and evaluated on one view, counts
               zeroed before and read after: B1(b), B2 and B3 must have
               launched, B2 also in the prune and in the evaluation; then
               its profile as in phase 5.

The second-to-last lines are the card's name and power limit and the
kernels JSON; the last line is the result JSON.  Exits non-zero without
printing a result when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM, float32 outside tensor cores
REL_TOL = 1e-5
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches, after warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_rows: int, f: int, table_rows: int):
    """(bound_ms, bound_by) of a scatter-add: idx + vals read once, the
    table written once; one f32 add per value."""
    byts = n_rows * 4 + n_rows * f * 4 + table_rows * f * 4
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = n_rows * f / F32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def merge_counts(idx, vals, table_rows, tile=2048):
    """Global atomics of one scatter input, counted on the card:
    ``updates``, one per non-zero in-range (row, column) value (what an
    unmerged scatter issues); ``atomics``, those the kernel issued, from
    one launch of its counting build; and ``distinct_per_tile``, the
    distinct (index, column) pairs per tile of ``tile`` rows, what merging
    a whole tile could reach."""
    import torch
    from shacira_tpu_torch.kernels.build import load, take_global_atomics
    from shacira_tpu_torch.ops.scatter import _launch_scatter
    lib = load('scatter', count_atomics=True)
    take_global_atomics(lib)
    _launch_scatter(idx, vals, table_rows, lib=lib)
    out = {'updates': 0, 'atomics': take_global_atomics(lib),
           'distinct_per_tile': 0}
    n, f = vals.shape
    inside = (idx >= 0) & (idx < table_rows)
    tiles = torch.arange(n, device=vals.device) // tile * table_rows
    for c in range(f):
        keep = inside & (vals[:, c] != 0)
        out['updates'] += int(keep.sum())
        out['distinct_per_tile'] += int(torch.unique(
            (tiles + idx.long())[keep]).numel())
    return out


def check_scatter(name, idx, vals, table_rows, kernel, plain, reps):
    """Kernel (through its wrapper ``kernel``) vs plain version vs
    index_add_ on one input; returns a row of the kernels line (launches
    filled in later).  The kernel is timed through its launch helper: at
    B1(b)'s ~30 us a launch, ``segment_sum``'s autograd wrapper takes more
    host time than the kernel takes on the card."""
    import torch
    from shacira_tpu_torch.ops.scatter import _launch_scatter
    out_k = kernel(idx, vals, table_rows)
    out_p = plain(idx, vals, table_rows)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    rel = err / max(scale, 1e-30)
    del out_k, out_p
    idx64 = idx.long()

    def library():
        return torch.zeros((table_rows, vals.shape[1]), device=vals.device
                           ).index_add_(0, idx64, vals)

    ms = time_ms(lambda: _launch_scatter(idx, vals, table_rows), reps)
    plain_ms = time_ms(lambda: plain(idx, vals, table_rows), reps)
    library_ms = time_ms(library, reps)
    del idx64
    b_ms, b_by = bound(idx.shape[0], vals.shape[1], table_rows)
    counts = merge_counts(idx, vals, table_rows)
    log(f'  {name}: N={idx.shape[0]} F={vals.shape[1]} T={table_rows} '
        f'max_abs_err={err:.3e} max_rel_err={rel:.3e} kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, '
        f'bound {b_ms:.4f} ms ({b_by}); updates {counts["updates"]}, '
        f'atomics {counts["atomics"]}, distinct per 2048-row tile '
        f'{counts["distinct_per_tile"]}')
    if not rel <= REL_TOL:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (rel {rel:.3e} > {REL_TOL})')
    return {'max_abs_err': err, 'max_rel_err': rel, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
            'library_ms': library_ms, **counts}


def ray_ordered_points(dev, gen, n_rays=4096, steps=2048, budget=1 << 20):
    """Sample coords [budget, 3] and validity [budget] of the flat lego
    step before its first prune: ``n_rays`` rays of the analytic scene,
    ``steps`` jittered samples each, every cell occupied, stride-compacted
    to ``budget`` rows in (ray, depth) order."""
    import torch
    from shacira_tpu_torch.accel import occupancy as occ
    from shacira_tpu_torch.core.rays import make_rays
    from shacira_tpu_torch.tracers.rf_tracer import _stride_compact
    data = sphere_scene(num_views=24, res=SCENE_RES)
    o = torch.as_tensor(data.rays_o.reshape(-1, 3), device=dev)
    d = torch.as_tensor(data.rays_d.reshape(-1, 3), device=dev)
    pick = torch.randint(0, o.shape[0], (n_rays,), generator=gen, device=dev)
    cfg = occ.OccupancyGridConfig()
    m = occ.raymarch_ray(occ.occupancy_init(cfg, dev), cfg,
                         make_rays(o[pick], d[pick], *SCENE_DIST), steps, gen)
    src, valid, _ = _stride_compact(m['mask'].reshape(-1), budget)
    return m['samples'].reshape(-1, 3)[src], valid


def scatter_inputs(dev):
    """B1's inputs at the lego step's shapes, name -> (idx int32 [N], vals
    [N, F] f32, table rows):

    * ``scatter_add_one_lod``: the hash backward of the finest LOD alone,
      8,388,608 updates into 2^19 rows, on uniformly random points;
    * ``scatter_add``: the hash backward as the flat step launches it, 24
      LODs fused, 1,048,576 x 24 x 8 = 201,326,592 updates into the
      7,879,908-row table, on uniformly random points;
    * ``scatter_add_ray_ordered``: the same on the step's own sample order,
      along rays in (ray, depth) order after the stride compaction;
    * ``segment_sum``: per-ray sums, 1,048,576 x 5 into 4096 rays, ids
      non-decreasing over the valid prefix and a zero-weight tail of slots
      carrying ray 0."""
    import torch
    from shacira_tpu_torch.ops import hashgrid
    from shacira_tpu_torch.ops.hashgrid import (
        HashGridSpec, geometric_resolutions)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    spec = HashGridSpec(geometric_resolutions(16, 512, 24), 19, 3)
    k = 1 << 20
    out = {}
    pts = torch.rand((k, 3), generator=gen, device=dev) * 2 - 1
    idx, _ = hashgrid._lod_corner_indices_and_weights(
        pts, spec.resolutions[-1], spec)
    out['scatter_add_one_lod'] = (idx.reshape(-1).to(torch.int32), torch.randn(
        (idx.numel(), 1), generator=gen, device=dev), spec.lod_sizes[-1])
    gidx, _ = hashgrid._all_corners(pts, spec)
    out['scatter_add'] = (gidx.reshape(-1), torch.randn(
        (gidx.numel(), 1), generator=gen, device=dev), spec.total_size)
    pts, valid = ray_ordered_points(dev, gen, budget=k)
    gidx, _ = hashgrid._all_corners(pts, spec)
    vals = torch.randn(gidx.shape + (1,), generator=gen, device=dev)
    vals = vals * valid[None, :, None, None]   # invalid rows: zero weight
    out['scatter_add_ray_ordered'] = (gidx.reshape(-1), vals.reshape(-1, 1),
                                      spec.total_size)
    rays, valid_rows = 4096, 900_000
    ids = torch.sort(torch.randint(0, rays, (valid_rows,), generator=gen,
                                   device=dev)).values
    ids = torch.cat([ids, torch.zeros((k - valid_rows,), dtype=ids.dtype,
                                      device=dev)]).to(torch.int32)
    payload = torch.randn((k, 5), generator=gen, device=dev)
    payload[valid_rows:] = 0.0     # invalid rows carry zero weight
    out['segment_sum'] = (ids, payload, rays)
    return out


def phase_kernels(dev):
    """Both uses of the scatter kernel at the lego step's shapes."""
    import torch
    from shacira_tpu_torch.ops import scatter
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}
    use_a = 'hash-grid backward, shacira_tpu/ops/hashgrid.py:471'
    inputs = scatter_inputs(dev)
    check_scatter('scatter_add one LOD', *inputs.pop('scatter_add_one_lod'),
                  scatter.scatter_add, scatter.scatter_add_plain, reps=20)
    for name, label, use in (
            ('scatter_add', 'scatter_add 24 LODs fused, random points',
             use_a),
            ('scatter_add_ray_ordered',
             'scatter_add 24 LODs fused, ray-ordered samples', use_a)):
        rows[name] = check_scatter(label, *inputs.pop(name),
                                   scatter.scatter_add,
                                   scatter.scatter_add_plain, reps=5)
        rows[name].update(use=use)
    ids, payload, rays = inputs.pop('segment_sum')
    rows['segment_sum'] = check_scatter(
        'segment_sum', ids, payload, rays,
        lambda i, v, t: scatter.segment_sum(i, v, t),
        scatter.scatter_add_plain, reps=50)
    rows['segment_sum'].update(
        use='per-ray sums, shacira_tpu/tracers/rf_tracer.py:325')
    for row in rows.values():
        row.update(source='shacira_tpu_torch/csrc/scatter.cu',
                   replaces='shacira_tpu/ops/pallas_scatter.py:29')
    # backward of the segment sum is the gather ct[idx]
    payload.requires_grad_(True)
    ct = torch.randn((rays, 5), generator=gen, device=dev)
    (grad,) = torch.autograd.grad(scatter.segment_sum(ids, payload, rays),
                                  payload, ct)
    gerr = float((grad - ct[ids.long()]).abs().max())
    log(f'  segment_sum backward gather: max_abs_err={gerr:.3e}')
    if gerr != 0.0:
        raise AssertionError('segment_sum backward is not ct[idx]')

    # indices outside [0, t) are dropped by the kernel and the plain version
    t = 300
    bad = torch.randint(-50, t + 50, (4096,), generator=gen, device=dev,
                        dtype=torch.int32)
    v = torch.randn((4096, 3), generator=gen, device=dev)
    want = scatter.scatter_add_plain(bad, v, t)
    derr = float((scatter.scatter_add(bad, v, t) - want).abs().max())
    log(f'  out-of-range indices dropped: max_abs_err={derr:.3e}')
    if not derr <= REL_TOL * float(want.abs().max()):
        raise AssertionError('kernel and plain version treat out-of-range '
                             'indices differently')
    return rows


# the paged lego configuration: configs/nerf_lego.yaml plus these flags
PAGED_FLAGS = ['--hash-layout', 'paged', '--page-res', '16',
               '--segment-size', '16', '--coarse-level', '7',
               '--seg-dilation', '2', '--seg-budget', '32768',
               '--eval-seg-budget', '24576', '--group-segs-per-block', '8',
               '--fine-mode', 'deferred', '--max-samples', '262144']
SCENE_DIST = (0.8, 4.4)   # ray bounds of the analytic scene below


def lego_args(dev, paged: bool, prune_every=None):
    """The lego config as the app parses it (flat or paged layout)."""
    from shacira_tpu_torch import config as cfg_mod
    argv = ['--config', os.path.join(ROOT, 'configs', 'nerf_lego.yaml'),
            '--device', dev] + (PAGED_FLAGS if paged else [])
    if prune_every is not None:
        argv += ['--prune-every', str(prune_every)]
    return cfg_mod.parse_args(cfg_mod.build_nerf_parser(), argv)


def _corner_pairs(coords_s, slot_valid, block_cell, static):
    """Rows [L, NS, 8] int64 and weights [L, NS, 8] f32 (zero on pad and
    invalid slots) of every corner of the block-local encode, from the plain
    version's corner math, and the live-slot mask [NS]."""
    import torch
    from shacira_tpu_torch.ops import paged_hash as ph
    bc, c3, live = ph._slot_cells(block_cell, coords_s.shape[0],
                                  static.group_res)
    keep = live & slot_valid
    rows, wts = zip(*(ph._lod_rows(coords_s, bc, c3, lod, static)
                      for lod in static.all_lods))
    return (torch.stack(rows), torch.stack(wts) * keep[None, :, None],
            keep)


def paged_bound(ns, n_live, nb, static, ld, slot_rows, table_rows):
    """(bound_ms, bound_by) of B2 or B3: validity [ns] and block cells [nb]
    read once, coords read for the ``n_live`` live slots only (the kernels
    skip pad blocks and invalid slots before reading them), ``slot_rows``
    rows of [L, ld] moved (B2 writes all ``ns``, B3 reads the live ones'
    gradient) and ``table_rows`` rows of the table moved (B2 reads the rows
    it touches, B3 writes the whole table); f32 operations 8 corners x
    (2 weight products + ld multiply-adds) per live (slot, LOD)."""
    nl = len(static.all_lods)
    byts = (n_live * 12 + ns + nb * 4 + slot_rows * nl * ld * 4
            + table_rows * ld * 4)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = n_live * nl * 8 * (2 + 2 * ld) / F32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _rel_err(got, want):
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def check_paged_gather(name, coords_s, slot_valid, block_cell, z, static,
                       reps, plain_reps=2):
    """B2 against its plain version, timed, with its byte bound."""
    import torch
    from shacira_tpu_torch.ops import paged_hash as ph
    args = (coords_s, slot_valid, block_cell, z, static)
    out_k = ph.paged_gather(*args)
    out_p = ph.paged_gather_plain(*args)
    torch.cuda.synchronize()
    err, rel = _rel_err(out_k, out_p)
    del out_k, out_p
    rows, _, keep = _corner_pairs(coords_s, slot_valid, block_cell, static)
    touched = torch.zeros((static.spec.total_size,), dtype=torch.bool,
                          device=z.device)
    touched[rows[:, keep].reshape(-1)] = True
    n_touched = int(touched.sum())
    del rows, touched
    ms = time_ms(lambda: ph.paged_gather(*args), reps)
    plain_ms = time_ms(lambda: ph.paged_gather_plain(*args), plain_reps)
    ns = coords_s.shape[0]
    b_ms, b_by = paged_bound(ns, int(keep.sum()), block_cell.shape[0],
                             static, z.shape[-1], ns, n_touched)
    log(f'  {name}: slots={coords_s.shape[0]} (live '
        f'{int(keep.sum())}) L={len(static.all_lods)} T='
        f'{static.spec.total_size} rows read={n_touched} '
        f'max_abs_err={err:.3e} max_rel_err={rel:.3e} kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})')
    if not rel <= REL_TOL:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (rel {rel:.3e} > {REL_TOL})')
    return {'max_abs_err': err, 'max_rel_err': rel, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
            'library_ms': None}


def check_paged_scatter(name, coords_s, slot_valid, block_cell, g, static,
                        reps, plain_reps=2):
    """B3 against its plain version and ``index_add_`` of the same
    (row, value) pairs, timed, with its byte bound."""
    import torch
    from shacira_tpu_torch.ops import paged_hash as ph
    args = (coords_s, slot_valid, block_cell, g, static)
    out_k = ph.paged_scatter(*args)
    out_p = ph.paged_scatter_plain(*args)
    torch.cuda.synchronize()
    err, rel = _rel_err(out_k, out_p)
    del out_k, out_p
    t, ld = static.spec.total_size, g.shape[-1]
    rows, w, keep = _corner_pairs(coords_s, slot_valid, block_cell, static)
    vals = (w[..., None] * g.permute(1, 0, 2)[:, :, None, :]).reshape(-1, ld)
    rows = rows.reshape(-1)

    def library():
        return torch.zeros((t, ld), device=g.device).index_add_(0, rows,
                                                                 vals)

    lerr, _ = _rel_err(library(), ph.paged_scatter_plain(*args))
    ms = time_ms(lambda: ph.paged_scatter(*args), reps)
    plain_ms = time_ms(lambda: ph.paged_scatter_plain(*args), plain_reps)
    library_ms = time_ms(library, reps)
    del rows, w, vals
    n_live = int(keep.sum())
    b_ms, b_by = paged_bound(coords_s.shape[0], n_live, block_cell.shape[0],
                             static, ld, n_live, t)
    counts = paged_merge_counts(*args)
    log(f'  {name}: slots={coords_s.shape[0]} L={len(static.all_lods)} '
        f'T={t} max_abs_err={err:.3e} max_rel_err={rel:.3e} kernel '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f}'
        f' ms (its max_abs_err {lerr:.3e}), bound {b_ms:.4f} ms ({b_by}); '
        f'updates {counts["updates"]}, atomics {counts["atomics"]}, '
        f'distinct per (block, LOD) {counts["distinct_per_tile"]}')
    if not rel <= REL_TOL:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (rel {rel:.3e} > {REL_TOL})')
    return {'max_abs_err': err, 'max_rel_err': rel, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
            'library_ms': library_ms, **counts}


def paged_merge_counts(coords_s, slot_valid, block_cell, g, static):
    """Global atomics of B3 on one input, counted on the card: ``updates``,
    one per non-zero w * g of a live (slot, LOD, corner, column) (what an
    unmerged scatter issues); ``atomics``, those the kernel issued, from
    one launch of its counting build; and ``distinct_per_tile``, the
    distinct (kernel block, LOD, row, column) among the updates, what
    merging a whole kernel block could reach."""
    import torch
    from shacira_tpu_torch.kernels.build import load, take_global_atomics
    from shacira_tpu_torch.ops import paged_hash as ph
    lib = load('paged_hash', count_atomics=True)
    take_global_atomics(lib)
    ph._launch_scatter(coords_s, slot_valid, block_cell, g, static, lib=lib)
    out = {'updates': 0, 'atomics': take_global_atomics(lib),
           'distinct_per_tile': 0}
    ns, ld = coords_s.shape[0], g.shape[-1]
    bc, c3, live = ph._slot_cells(block_cell, ns, static.group_res)
    keep = live & slot_valid
    block = torch.arange(ns, device=g.device) // (ns // block_cell.shape[0])
    for li, lod in enumerate(static.all_lods):
        rows, w = ph._lod_rows(coords_s.float(), bc, c3, lod, static)
        key = block[:, None] * static.spec.total_size + rows
        for d in range(ld):
            nz = keep[:, None] & (w * g[:, li, d:d + 1].float() != 0)
            out['updates'] += int(nz.sum())
            out['distinct_per_tile'] += int(torch.unique(key[nz]).numel())
    return out


def paged_inputs(dev):
    """B2's and B3's inputs at the paged lego step's shapes: 24,576
    spatially tight segments of 16 samples grouped 8 to a block (458,752
    slots): coords_s, slot_valid, block_cell, a table z [T, 1], an output
    gradient g [458,752, 24, 1] and the static encode description."""
    import torch
    from shacira_tpu_torch import config as cfg_mod
    from shacira_tpu_torch.ops import paged_hash as ph
    args = lego_args('cuda', paged=True)
    spec = cfg_mod.build_grid_config(args).spec
    static = ph.default_static(spec)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    k, g, spb = (args.eval_seg_budget, args.segment_size,
                 args.group_segs_per_block)
    # half a segment in [0,1] coords at the scene's ray bounds
    half = (SCENE_DIST[1] - SCENE_DIST[0]) * (g / 2 + 1) / args.num_steps / 2
    centers = torch.rand((k, 3), generator=gen, device=dev) * 0.96 + 0.02
    d = torch.randn((k, 3), generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.linspace(-half, half, g, device=dev)
    pts = torch.clamp(centers[:, None] + d[:, None] * t[None, :, None], 0, 1)
    live = torch.rand((k,), generator=gen, device=dev) < 0.8
    grp = ph.group_segments(centers, live, spb, k // spb + static.n_cells,
                            static.group_res)
    s2s = grp['slotseg_to_seg']
    sv = s2s < k
    coords_s = torch.where(sv[:, None], (pts * 2 - 1).reshape(k, g * 3)[
        torch.clamp(s2s, max=k - 1)], 0.0).reshape(-1, 3).contiguous()
    slot_valid = sv[:, None].expand(-1, g).reshape(-1).contiguous()
    z = torch.randn((spec.total_size, 1), generator=gen, device=dev)
    gout = torch.randn((coords_s.shape[0], len(static.all_lods), 1),
                       generator=gen, device=dev)
    return {'coords_s': coords_s, 'slot_valid': slot_valid,
            'block_cell': grp['block_cell'], 'z': z, 'g': gout,
            'static': static}


def phase_paged_kernels(dev):
    """B2 and B3 at the paged lego step's shapes (:func:`paged_inputs`),
    and B2 at the paged prune's 2,097,152 rows."""
    import torch
    from shacira_tpu_torch.models.nefs import nerf as nerf_mod
    inp = paged_inputs(dev)
    slots = (inp['coords_s'], inp['slot_valid'], inp['block_cell'])
    z, static = inp['z'], inp['static']
    rows = {'paged_gather': check_paged_gather(
        'paged_gather (B2) train', *slots, z, static, reps=20)}
    rows['paged_scatter'] = check_paged_scatter(
        'paged_scatter (B3) train', *slots, inp['g'], static, reps=20)
    del inp, slots
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    # the paged prune: one jittered point per cell of the 128^3 grid
    idx3, bcell, _ = nerf_mod._prune_block_layout(128, static.group_res)
    u = torch.rand((idx3.shape[0], 3), generator=gen, device=dev)
    prune_pts = ((torch.as_tensor(idx3, device=dev) + u) / 128) * 2 - 1
    rows['paged_gather']['prune'] = check_paged_gather(
        'paged_gather (B2) prune', prune_pts,
        torch.ones((idx3.shape[0],), dtype=torch.bool, device=dev),
        torch.as_tensor(bcell, device=dev), z, static, reps=5, plain_reps=1)
    rows['paged_gather'].update(
        source='shacira_tpu_torch/csrc/paged_hash.cu',
        replaces='shacira_tpu/ops/paged_hash.py:720',
        use='paged encode forward, prune and eval, '
            'shacira_tpu/ops/paged_hash.py:1163')
    rows['paged_scatter'].update(
        source='shacira_tpu_torch/csrc/paged_hash.cu',
        replaces='shacira_tpu/ops/paged_hash.py:786',
        use='paged encode backward, shacira_tpu/ops/paged_hash.py:1236')
    return rows


def sphere_scene(num_views: int, res: int):
    """Analytic solid sphere (radius 0.5, normal-coloured, white
    background) seen by cameras on a circle of radius 2.5."""
    from shacira_tpu_torch.datasets.nerf_synthetic import (
        MultiviewData, pinhole_rays)
    h = w = res
    fx = fy = res * 1.2
    radius = 0.5
    rgbs, origins, dirs = [], [], []
    for v in range(num_views):
        theta = 2 * np.pi * v / num_views
        cam = np.asarray([2.5 * np.cos(theta), 0.8, 2.5 * np.sin(theta)],
                         np.float32)
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, cam
        o, d = pinhole_rays(c2w, h, w, fx, fy)
        b = np.sum(o * d, -1)
        disc = b * b - (np.sum(o * o, -1) - radius ** 2)
        t = -b - np.sqrt(np.maximum(disc, 0))
        n = (o + d * t[:, None]) / radius
        rgbs.append(np.where((disc > 0)[:, None], 0.5 + 0.5 * n, 1.0
                             ).astype(np.float32))
        origins.append(o)
        dirs.append(d)
    # the camera circle's distance to the [-1,1]^3 cube bounds the march
    return MultiviewData(rgb=np.stack(rgbs), rays_o=np.stack(origins),
                         rays_d=np.stack(dirs),
                         masks=np.ones((num_views, h * w, 1), bool),
                         h=h, w=w, dist_min=SCENE_DIST[0],
                         dist_max=SCENE_DIST[1])


def _parity_cfgs(paged: bool):
    """Small flat or paged model and tracer configs for the parity step."""
    from shacira_tpu_torch.models.grids.latent_grid import LatentGridConfig
    from shacira_tpu_torch.models.nefs.nerf import NeuralRadianceFieldConfig
    from shacira_tpu_torch.tracers.rf_tracer import RFTracerConfig
    if paged:       # 3 direct LODs (17..40) and 2 paged ones (62, 97)
        grid = dict(num_lods=5, min_grid_res=16, max_grid_res=96,
                    codebook_bitwidth=17, hash_layout='paged', page_res=16)
        tcfg = RFTracerConfig(num_steps=512, max_samples=4096,
                              segment_size=8, seg_budget=2048,
                              coarse_level=4, seg_dilation=2,
                              eval_seg_budget=512, group_segs_per_block=4,
                              fine_mode='deferred')
    else:
        grid = dict(num_lods=6, min_grid_res=4, max_grid_res=64,
                    codebook_bitwidth=12)
        tcfg = RFTracerConfig(num_steps=128, max_samples=16384)
    grid = LatentGridConfig.from_geometric(
        feature_dim=4, latent_dim=1, multiscale_type='cat', feature_std=0.02,
        entropy_enabled=True, num_prob_layers=1, **grid
    ).with_ldec(dict(ldec_std=0.1, use_shift=True, use_sga=True,
                     diff_sampling=True))
    mcfg = NeuralRadianceFieldConfig(grid=grid, hidden_dim=32,
                                     view_embedder='positional',
                                     blas_level=5 if paged else 4, amp=False)
    return mcfg, tcfg


def phase_parity(dev, paged: bool):
    """One small step on the card against the same step on the CPU."""
    import torch
    from shacira_tpu_torch import optim
    from shacira_tpu_torch.trainers.multiview_trainer import (
        MultiviewTrainer, MultiviewTrainerConfig, StepDraws)
    data = sphere_scene(4, 24)
    mcfg, tcfg = _parity_cfgs(paged)
    cfg = MultiviewTrainerConfig(epochs=10, prune_every=-1)
    cpu = MultiviewTrainer(cfg, mcfg, tcfg, data, num_rays=256, device='cpu')
    gpu = MultiviewTrainer(cfg, mcfg, tcfg, data, num_rays=256, device=dev)
    if gpu.use_paged != paged:
        raise AssertionError('the parity step took the wrong trace path')
    gpu.set_params(optim.tree_map(lambda t: t.detach().clone().to(dev),
                                  cpu.params))
    draws = cpu.draw_step(use_sga=True)
    ro, rd, gt = (torch.as_tensor(a[0]) for a in cpu._presample(1))
    kw = dict(ent_lambda=1e-4, temperature=1.0, lr_ldec=1e-3, use_sga=True)
    m_cpu = cpu.step(ro, rd, gt, draws, **kw)
    m_gpu = gpu.step(ro.to(dev), rd.to(dev), gt.to(dev), StepDraws(
        march_u=draws.march_u.to(dev), sga_u=draws.sga_u.to(dev),
        noise=draws.noise.to(dev)), **kw)
    loss_c, loss_g = float(m_cpu['loss']), float(m_gpu['loss'])
    # Adam's first update is about +-lr per entry whatever the gradient's
    # size, so compare its first moment mu = (1 - b1) * grad instead: per
    # trained leaf, the largest difference over the leaf's largest entry
    mu_c = dict(optim.tree_leaves_with_path(cpu.opt_state['mu']))
    worst, worst_path = 0.0, None
    for path, m in optim.tree_leaves_with_path(gpu.opt_state['mu']):
        scale = float(mu_c[path].abs().max())
        if scale == 0.0:           # frozen leaves keep zero moments
            continue
        rel = float((m.cpu() - mu_c[path]).abs().max()) / scale
        if rel >= worst:
            worst, worst_path = rel, '/'.join(path)
    log(f'  small {"paged" if paged else "flat"} step card vs CPU: loss '
        f'{loss_g:.7f} vs {loss_c:.7f}, Adam first moment max rel diff '
        f'{worst:.3e} ({worst_path})')
    # float atomics and other summation orders: rtol 1e-4 on the loss and
    # 1e-3 of each leaf's largest gradient
    if not (math.isfinite(loss_g) and abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)):
        raise AssertionError('card step loss disagrees with the CPU step')
    if not worst <= 1e-3:
        raise AssertionError('card step gradients disagree with the CPU step')


SCENE_RES = 128           # analytic scene: 24 views of 128 x 128
AFTER_PRUNE = 4           # training steps past the prune


def _launch_counts():
    from shacira_tpu_torch.ops import paged_hash as ph
    from shacira_tpu_torch.ops import scatter
    return {'scatter_add': scatter.scatter_add.launches,
            'segment_sum': scatter.segment_sum.launches,
            'paged_gather': ph.paged_gather.launches,
            'paged_scatter': ph.paged_scatter.launches}


def _reset_launches():
    from shacira_tpu_torch.ops import paged_hash as ph
    from shacira_tpu_torch.ops import scatter
    scatter.reset_launches()
    ph.reset_launches()


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def phase_lego(dev, prune_every, paged: bool = False):
    """Full-width lego-config training, configured through the app's code
    (flat layout, or the paged one with ``PAGED_FLAGS``).

    Steps run as the trainer runs them, one chunk after another with no
    host sync between steps, so step times are means over blocks of steps,
    the device drained at both ends: step 1 (warm-up), steps 2 ..
    prune_every - 1, the step that ends in the prune, and the steps past
    it."""
    import torch
    from shacira_tpu_torch.apps.train_nerf import build_trainer
    if prune_every is not None:
        log(f'  prune_every lowered to {prune_every} through the CLI')
    args = lego_args(dev, paged, prune_every)
    if args.prune_every < 3:
        raise ValueError('the lego phase needs prune_every >= 3')
    data = sphere_scene(num_views=24, res=SCENE_RES)
    trainer = build_trainer(args, data)
    if trainer.use_paged != paged:
        raise AssertionError('the lego trainer took the wrong trace path')
    spec = trainer.model_cfg.grid.spec
    log(f'  lego config ({spec.hash_layout}): {spec.num_lods} LODs '
        f'{spec.resolutions[0]}..{spec.resolutions[-1]}, table '
        f'{spec.total_size} rows, {args.num_rays_sampled_per_img} rays x '
        f'{args.num_steps} steps, max_samples {args.max_samples}, hidden '
        f'{args.hidden_dim}, amp {not args.disable_amp}, prune_every '
        f'{args.prune_every}, chunk_size {args.chunk_size}'
        + (f', segment {args.segment_size}, seg_budget {args.seg_budget}, '
           f'eval_seg_budget {args.eval_seg_budget}, page_res '
           f'{args.page_res}' if paged else ''))
    entries = []

    def timed(n):
        """Mean seconds per step over the next ``n`` training steps."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(num_iterations=n, log_fn=lambda e: entries.append(e)
                      if 'iteration' in e else None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    first_s = timed(1)
    block_s = timed(args.prune_every - 2)
    before_prune = _launch_counts()
    prune_s = timed(1)
    in_prune_step = _delta(_launch_counts(), before_prune)
    after_s = timed(AFTER_PRUNE)
    before_eval = _launch_counts()
    metrics = trainer.evaluate(view_indices=[0])
    torch.cuda.synchronize()
    launches = _launch_counts()
    in_eval = _delta(launches, before_eval)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    first, before, pruned, last = entries[0], entries[-3], entries[-2], \
        entries[-1]
    result = {
        'layout': spec.hash_layout,
        'steps': trainer.iteration, 'first_step_ms': first_s * 1e3,
        'mean_step_ms': block_s * 1e3,
        'mean_step_ms_of_steps': [2, args.prune_every - 1],
        'prune_step_ms': prune_s * 1e3,
        'mean_step_ms_after_prune': after_s * 1e3,
        'rays_per_s': args.num_rays_sampled_per_img / block_s,
        'loss_first': first['loss'], 'loss_last': last['loss'],
        'psnr_first': first['psnr'], 'psnr_last': last['psnr'],
        'occupancy_before_prune': before['occupancy'],
        'occupancy_after_prune': pruned['occupancy'],
        'eval_psnr_view0': metrics['psnr'], 'peak_mem_gb': peak_gb,
        'launches': launches, 'launches_in_prune_step': in_prune_step,
        'launches_in_eval': in_eval}
    log('  lego: ' + json.dumps(result))
    if not all(math.isfinite(e['loss']) for e in entries):
        raise AssertionError('non-finite training loss')
    if not last['loss'] < first['loss']:
        raise AssertionError('training loss did not fall')
    if pruned['occupancy'] == before['occupancy']:
        raise AssertionError('the prune left the occupancy unchanged')
    if not math.isfinite(metrics['psnr']):
        raise AssertionError('non-finite evaluation PSNR')
    if paged:
        # one forward of the step plus one in the prune; one per eval batch
        if in_prune_step['paged_gather'] != 2:
            raise AssertionError(f'B2 did not run in the prune: '
                                 f'{in_prune_step}')
        if in_eval['paged_gather'] < 1 or in_eval['paged_scatter'] != 0:
            raise AssertionError(f'eval did not go through B2: {in_eval}')
    return result, launches, trainer, args, data


RANGES = ('step/draws', 'step/decode', 'trace/march', 'trace/group',
          'trace/compact', 'field/encode', 'field/paged_encode',
          'field/finish', 'field/head', 'trace/integrate', 'step/rate_loss',
          'step/adam')


def phase_profile(trainer, steps: int, label: str, step_ms: float):
    """Device time by step stage (the record_function ranges of the port)
    and by kernel over ``steps`` training steps under torch.profiler.  The
    backward runs on autograd's device thread, outside those ranges: it is
    the remainder of the device's busy time.

    The idle share compares the device's busy time per step with the mean
    step time measured without the profiler (``step_ms``).  Host syncs
    count the stream synchronisations (each host-to-device copy from
    pageable memory makes one) and host-to-device copies per step; device
    ops count the kernels and copies the card ran per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(num_iterations=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, ranges = {}, dict.fromkeys(RANGES, 0.0)
    syncs = copies = device_ops = 0
    for e in prof.events():
        if e.name.startswith('Memcpy HtoD'):
            copies += 1
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, 'is_user_annotation', False)
                    or e.name in ranges):
                device_ops += 1
                kernels[e.name] = (kernels.get(e.name, 0.0)
                                   + e.time_range.elapsed_us())
        elif e.name in ranges:
            ranges[e.name] += e.device_time_total
        elif e.name == 'cudaStreamSynchronize':
            syncs += 1
    busy_ms = sum(kernels.values()) / 1e3 / steps
    per_step = {k: v / 1e3 / steps for k, v in ranges.items()}
    per_step['backward (remainder)'] = busy_ms - sum(per_step.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    out = {'profile': label, 'steps': steps,
           'profiled_wall_ms_per_step': wall * 1e3 / steps,
           'unprofiled_step_ms': step_ms,
           'device_busy_ms_per_step': busy_ms,
           'device_idle_share': 1.0 - busy_ms / step_ms,
           'stream_syncs_per_step': syncs / steps,
           'htod_copies_per_step': copies / steps,
           'device_ops_per_step': device_ops / steps,
           'stage_device_ms_per_step': per_step,
           'top_kernels_ms_per_step': [[n[:90], v / 1e3 / steps]
                                       for n, v in top]}
    log('  ' + json.dumps(out))
    if busy_ms <= 0.0:
        raise AssertionError('the profiler saw no device time')
    if syncs / steps > 1.0:
        raise AssertionError(f'{syncs / steps} stream syncs per step: the '
                             'step waits for the card more than once')
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--prune-every', type=int, default=None,
                    help='lower the config prune cadence (default: keep it)')
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing to run', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from shacira_tpu_torch.device import resolve_device
    from shacira_tpu_torch.kernels import build
    dev = resolve_device('cuda')
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')

    t0 = time.perf_counter()
    build.build_all()
    log(f'phase build: {", ".join(build.sources())} and their atomic-'
        f'counting builds in parallel ({time.perf_counter() - t0:.1f} s)')
    log('phase kernels:')
    rows = phase_kernels(dev)
    rows.update(phase_paged_kernels(dev))
    log('phase parity:')
    phase_parity(dev, paged=False)
    phase_parity(dev, paged=True)
    from shacira_tpu_torch.apps.train_nerf import build_trainer
    launches = {}
    for paged in (False, True):
        name = 'paged' if paged else 'lego'
        log(f'phase {name}:')
        result, launches[name], trainer, lego_args, data = phase_lego(
            'cuda', args.prune_every, paged=paged)
        log(f'phase {name} profile:')
        phase_profile(trainer, 3, f'{name}, after the prune',
                      result['mean_step_ms_after_prune'])
        del trainer
        fresh = build_trainer(lego_args, data)
        fresh.train(num_iterations=1)
        phase_profile(fresh, 3, f'{name}, before the first prune',
                      result['mean_step_ms'])
        del fresh
        torch.cuda.empty_cache()
    # each kernel's launches come from the path it serves: B1 from the flat
    # lego run, B2 and B3 from the paged one (which also runs B1(b))
    # (row name, wrapper whose launches it reports, path); the ray-ordered
    # row times the same wrapper as scatter_add on the step's sample order
    path_of = (('scatter_add', 'scatter_add', 'lego'),
               ('scatter_add_ray_ordered', 'scatter_add', 'lego'),
               ('segment_sum', 'segment_sum', 'lego'),
               ('paged_gather', 'paged_gather', 'paged'),
               ('paged_scatter', 'paged_scatter', 'paged'))
    counts = ('updates', 'atomics', 'distinct_per_tile')
    kernels = []
    for name, wrapper, path in path_of:
        row = rows[name]
        kernels.append({'name': name, 'route': 'cuda',
                        'source': row['source'], 'replaces': row['replaces'],
                        'use': row['use'],
                        'launches': launches[path][wrapper],
                        'launches_by_path': {p: launches[p][wrapper]
                                             for p in launches},
                        'max_abs_err': row['max_abs_err'],
                        'max_rel_err': row['max_rel_err'], 'ms': row['ms'],
                        'plain_ms': row['plain_ms'],
                        'bound_ms': row['bound_ms'],
                        'bound_by': row['bound_by'],
                        'library_ms': row['library_ms'],
                        **{c: row[c] for c in counts if c in row}})
    missing = [k['name'] for k in kernels if k['launches'] <= 0]
    if launches['paged']['segment_sum'] <= 0:
        missing.append('segment_sum (paged path)')
    if missing:
        raise AssertionError(f'kernels not launched on the main path: '
                             f'{missing}')
    log(card_line())
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
