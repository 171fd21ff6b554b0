#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``shacira_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--prune-every N] [--log FILE]

Phases, each of which must pass (exit code 1 otherwise):

1. build    -- compile every CUDA source of the port with nvcc (sm_90a),
               and the scatter sources again as their atomic-counting
               builds, one nvcc per library, all at once, and print the
               build time;
2. kernels  -- call each kernel's wrapper on the card at the shapes of the
               lego training step and hold it against its plain PyTorch
               version (max error relative to the largest value <= 1e-5);
               time kernel, plain version and, where one PyTorch call
               computes the same function, that call, with CUDA events; and
               compute the least time the card could take (bytes over 3.35
               TB/s, or f32 operations over 67 TFLOP/s).  Scatter B1 (flat
               hash backward on random points and on the step's
               ray-ordered samples, per-ray sums), paged gather B2 (train
               and prune shapes, and at train shapes with its occupancy row
               of a 128^3 grid, which must equal the plain version's
               exactly) and paged scatter B3.  For B1 and B3 also
               count the updates (one global atomic each without merging),
               the global atomics the merging kernel issued (counted on the
               card by the same source built with -DCOUNT_GLOBAL_ATOMICS)
               and the distinct addresses per tile or kernel block;
3. parity   -- one small training step on the card against the same step of
               the port on the CPU (plain versions), same params and draws,
               on the flat layout (dense march, segmented 'exact' march)
               and on the paged layout (deferred and 'exact' marches, the
               sustained setting of phase 8);
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
               its profile as in phase 5;
7. kernel   -- the paged run again with ``--fine-mode kernel``: the fine
               occupancy query rides B2 as its occupancy row, which every
               training step must launch (the prune and the evaluation run
               B2 without it); then its profile;
8. sustained -- the paged run in the JAX bench's headline setting
               (``SUSTAINED_FLAGS``: lean stage 1, two-level cull,
               term_tau 11.5, adaptive budgets from 8192): two prunes with
               the adapted budgets, probe fractions and occupancy logged
               after each, a profile after the second, steps 204-299 timed
               against steps 2-99, one view evaluated; B1(b), B2 and B3
               must have launched, the lean march and the two-level cull
               run every step, every budget sit on its ladder at or below
               its base; then 13 steps at the budgets a quarter of the
               probed fractions gives (other B2/B3 launch shapes), and a
               profile before the first prune;
9. modes    -- 3 full-width steps each of the flat segmented 'exact'
               march, the paged 'exact' march and the paged run with
               --random-lod, from the app's flags: B1(a) and B1(b), or
               B1(b), B2 and B3, every step;
10. app     -- the app's ``main`` in the sustained setting on a generated
               Blender-format scene (40 + 2 views of 128 x 128): 120 steps
               with a resume state every epoch, ``--resume`` to step 160,
               ``--valid-only`` (its PSNR equal to the resumed run's to
               1e-4 dB); ``metrics.json`` with PSNR, SSIM, LPIPS on random
               weights and the size report, the checkpoints, the saved view
               and the turntable; the checkpoint, evaluation, size-report
               and turntable calls timed; B1(b), B2 and B3 must have
               launched;
11. image_kernels -- B1 as the image path's 2D hash backward: kodak's grid
               (40,282 rows) on the 512 x 768 pixel lattice in row-major
               order and in ImageDataset('full')'s shuffled order, and
               pearl's (39,727,145 rows) at 2^18 random pixels, checked and
               timed as in phase 2;
12. image_parity -- one small image step on the card against the same
               step on the CPU, full-image and 'wreplace';
13. image   -- ``apps/train_image.main`` with configs/kodak.yaml at full
               width on two procedural 512 x 768 photos, 300 epochs (the
               SGA -> STE flip at 270), then ``--valid-only`` (each PSNR
               within 0.75 dB); B1 once a step; the step timed (Mpix/s)
               and profiled;
14. pearl   -- the app with configs/pearl.yaml at its widths on a
               procedural 2048 x 2048 photo, 2 epochs of 16 'wreplace'
               steps of 2^18 pixels, validation and a resume state every
               epoch; those calls and the size report timed, peak memory;
               B1 once a step; the step timed (samples/s) and profiled;
15. voxel_kernels -- on a generated RTMV scene (40 views of 256 x 256,
               read at configs/nerf_V8.yaml's mip 2): kernel V1 (the DDA
               walk of the 'voxel' march) on 4096 of its rays against its
               plain version (``valid`` and depths equal bit for bit), on
               the occupancy seeded from the scene's point cloud and on a
               grid with every cell occupied, and on 3072 rays that start
               on cell faces, edges and corners, stall or miss the box, on
               the seeded grid; its longest walk and time a step of it;
               B1(a) as the flat V8 backward (20 LODs, width 2,
               671,088,640 updates into 1,966,521 rows), B1(b) as the
               paged voxel step's per-ray sums, B2 and B3 at ld 2 on
               262,144 voxel slots; each timed, with its bound;
16. voxel_parity -- one small voxel step (latent_dim 2) on the card
               against the same step on the CPU, flat dense and paged;
17. v8      -- ``apps/train_nerf.main`` with configs/nerf_V8.yaml unchanged
               on that scene, 104 steps across the prune at 100 from the
               point cloud's occupancy, then ``--valid-only`` (its PSNR
               equal to the trained run's to 1e-4 dB); B1(a) and V1 every
               step; the step timed and profiled outside the app;
18. voxel   -- bench_nerf.measure_voxel's setting (``VOXEL_FLAGS``: V8's
               grid paged, adaptive budgets, term_tau 11.5) through the
               config reader on the lego-like Blender scene, 210 steps
               across two prunes, budgets and probed live crossings logged
               after each, profiled after the second, one view evaluated;
               B1(b), B2, B3 and V1 every step;
19. octree_rtmv -- ``apps/train_nerf.main`` with configs/nerf_octree.yaml
               (NGLOD) on that RTMV scene, the octree of LODs 5-8 built on
               the card from the depth point cloud (queries outside it
               give -1 and zero features), 104 steps across a prune at 100,
               then ``--valid-only`` as in phase 17; B1 every step;
20. backbones -- B1 at the alternative backbones' shapes (NGLOD's corner
               features, F = 5, and VQAD's corner logits, F = 16, of the
               dense 4096 x 1024-sample march into the 19,431,844 corners
               of the dense octree of LODs 5-8; the triplanar texels of
               1,048,576 samples, F = 4, into 264,012 rows; the HashGrid
               backward, 16 LODs, F = 2), checked and timed as in phase 2;
               then the app with configs/nerf_octree.yaml,
               nerf_codebook.yaml, nerf_triplanar.yaml (with --max-samples
               1048576, its one cut) and nerf_hash.yaml at full width on
               the Blender-format scene of phase 10 (40 + 1 views), 104
               steps each across a prune at 100 (``BACKBONE_FLAGS``), then
               ``--valid-only`` (its PSNR equal to the trained run's to
               1e-4 dB); the dense octree built once for NGLOD and VQAD,
               its build time printed; each run's step time, device busy
               time, idle share, stream syncs a step, peak memory and size
               report; B1 every step on every path, V1 on the triplanar
               path;
21. sdf     -- the SDF demo (``shacira_tpu_torch.apps.sdf_demo``, the
               counterpart of tools/run_sdf_demo.py) at its full width:
               B1 on a real step's NeuralSDF hash backward (163,840 rows of
               F = 4 into 15,761), checked and timed as in phase 2; 2,000
               steps on the analytic composite scene's 200,000-point pool
               (IoU over 8 batches at least 90), the normal, shadow and
               matcap renders at 256 x 256 (finite; the normal render hits
               at the centre and not at the corner), each timed; B1 every
               step; then 3 steps profiled.

Every profile fails the run when its stage ranges hold more than 2 % of
the busy time beyond it (a negative backward remainder).

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


LOG_FILES = []             # --log: every line also goes there


def log(msg):
    print(msg, flush=True)
    for f in LOG_FILES:
        print(msg, file=f, flush=True)


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


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on the device alone: ``reps`` calls
    captured in one CUDA graph, replayed ``replays`` times after a warm-up
    and timed with CUDA events, so that no host work sits between the
    launches (``time_ms`` times the host's launches too, which a kernel
    shorter than its wrapper's Python waits on)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


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
    rows['scatter_add_one_lod'] = check_scatter(
        'scatter_add one LOD', *inputs.pop('scatter_add_one_lod'),
        scatter.scatter_add, scatter.scatter_add_plain, reps=20)
    rows['scatter_add_one_lod'].update(
        use='hash-grid backward of the finest lego LOD alone, '
            'shacira_tpu/ops/hashgrid.py:471')
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
# the JAX bench's headline setting (bench.py's stage nerf_sustained): lean
# stage 1, the two-level cull, transmittance culling, adaptive budgets
SUSTAINED_FLAGS = ['--term-tau', '11.5', '--lean-stage1', 'true',
                   '--super-factor', '4', '--adaptive-budget', 'true',
                   '--min-budget', '8192']
# bench_nerf.measure_voxel's setting (the JAX bench's stage voxel) on
# configs/nerf_V8.yaml: V8's grid on the paged layout, adaptive budgets,
# transmittance culling, the bf16 head
VOXEL_FLAGS = ['--hash-layout', 'paged', '--page-res', '16',
               '--max-samples', '262144', '--eval-seg-budget', '16384',
               '--max-intersections', '64', '--group-segs-per-block', '8',
               '--term-tau', '11.5', '--adaptive-budget', 'true',
               '--min-budget', '8192', '--chunk-size', '50',
               '--disable-amp', 'false']
SCENE_DIST = (0.8, 4.4)   # ray bounds of the analytic scene below
OCC_RES = 128             # the lego config's occupancy grid (blas_level 7)


def lego_args(dev, paged: bool, prune_every=None, fine_mode='deferred',
              extra=()):
    """The lego config as the app parses it (flat or paged layout, the
    paged one with ``fine_mode`` and the flags ``extra``)."""
    from shacira_tpu_torch import config as cfg_mod
    flags = [fine_mode if f == 'deferred' else f for f in PAGED_FLAGS]
    argv = ['--config', os.path.join(ROOT, 'configs', 'nerf_lego.yaml'),
            '--device', dev] + (flags if paged else []) + list(extra)
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


def paged_bound(ns, n_live, nb, static, ld, slot_rows, table_rows,
                occ_bytes=0):
    """(bound_ms, bound_by) of B2 or B3: validity [ns] and block cells [nb]
    read once, coords read for the ``n_live`` live slots only (the kernels
    skip pad blocks and invalid slots before reading them), ``slot_rows``
    rows of [L(+1), ld] moved (B2 writes all ``ns``, with the occupancy row
    when ``static.occ_res``; B3 reads the live ones' gradient),
    ``table_rows`` rows of the table moved (B2 reads the rows it touches,
    B3 writes the whole table) and ``occ_bytes`` bytes of the packed
    occupancy grid read; f32 operations 8 corners x (2 weight products +
    ld multiply-adds) per live (slot, LOD)."""
    nl = len(static.all_lods)
    byts = (n_live * 12 + ns + nb * 4
            + slot_rows * (nl + (1 if static.occ_res else 0)) * ld * 4
            + table_rows * ld * 4 + occ_bytes)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = n_live * nl * 8 * (2 + 2 * ld) / F32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _rel_err(got, want):
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def occ_bytes_read(coords_s, keep, block_cell, static):
    """Distinct bytes of the packed occupancy grid that the live slots'
    occupancy row reads (the window-clamped cell of each)."""
    import torch
    from shacira_tpu_torch.ops import paged_hash as ph
    _, c3, _ = ph._slot_cells(block_cell, coords_s.shape[0],
                              static.group_res)
    index, _, _ = ph.occupancy_bytes(coords_s, c3, static.occ_res,
                                     static.group_res)
    return int(torch.unique(index[keep]).numel())


def check_paged_gather(name, coords_s, slot_valid, block_cell, z, static,
                       reps, plain_reps=2, occ=None):
    """B2 against its plain version, timed, with its byte bound; with
    ``occ`` (a packed occupancy grid) and ``static.occ_res`` also its
    occupancy row, which must equal the plain version's exactly."""
    import torch
    from shacira_tpu_torch.ops import paged_hash as ph
    args = (coords_s, slot_valid, block_cell, z, static, occ)
    out_k = ph.paged_gather(*args)
    out_p = ph.paged_gather_plain(*args)
    torch.cuda.synchronize()
    nl = len(static.all_lods)
    err, rel = _rel_err(out_k[:, :nl], out_p[:, :nl])
    occ_mismatch = int((out_k[:, nl:] != out_p[:, nl:]).sum())
    occ_mean = float(out_p[:, nl:].mean()) if static.occ_res else None
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
    n_occ = (occ_bytes_read(coords_s, keep, block_cell, static)
             if static.occ_res else 0)
    b_ms, b_by = paged_bound(ns, int(keep.sum()), block_cell.shape[0],
                             static, z.shape[-1], ns, n_touched, n_occ)
    log(f'  {name}: slots={coords_s.shape[0]} (live '
        f'{int(keep.sum())}) L={nl} T={static.spec.total_size} rows read='
        f'{n_touched} max_abs_err={err:.3e} max_rel_err={rel:.3e} '
        + (f'occupancy row: {occ_mismatch} mismatches, mean {occ_mean:.4f}, '
           f'{n_occ} grid bytes read; ' if static.occ_res else '')
        + f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} '
        f'ms ({b_by})')
    if not rel <= REL_TOL:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version (rel {rel:.3e} > {REL_TOL})')
    if occ_mismatch:
        raise AssertionError(f'{name}: the occupancy row differs from the '
                             f'plain version at {occ_mismatch} slots')
    return {'max_abs_err': err, 'max_rel_err': rel, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
            'library_ms': None,
            **({'occupancy_row_mismatches': occ_mismatch}
               if static.occ_res else {})}


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


def paged_inputs(dev, args=None, voxel=False):
    """B2's and B3's inputs at the paged step's shapes of ``args`` (default:
    the paged lego config): ``eval_seg_budget`` spatially tight segments
    (lego: 24,576 of ``segment_size`` 16 samples, 458,752 slots; with
    ``voxel`` 16,384 crossings of ``num_steps`` 16 samples inside one
    cell of the 128^3 grid, 262,144 slots) grouped 8 to a block:
    coords_s, slot_valid, block_cell, a table z [T, ld], an output
    gradient g [slots, L, ld], the static encode description, and (lego) a
    packed 128^3 occupancy grid (cells occupied with probability 0.3) with
    the static description of B2 with its occupancy row."""
    import torch
    from shacira_tpu_torch import config as cfg_mod
    from shacira_tpu_torch.ops import paged_hash as ph
    if args is None:
        args = lego_args('cuda', paged=True)
    spec = cfg_mod.build_grid_config(args).spec
    static = ph.default_static(spec)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ld = args.latent_dim
    if voxel:
        # a crossing's samples span at most one cell's diagonal
        k, g = args.eval_seg_budget, args.num_steps
        half = math.sqrt(3.0) / (2 * OCC_RES)
    else:
        # half a segment in [0,1] coords at the scene's ray bounds
        k, g = args.eval_seg_budget, args.segment_size
        half = ((SCENE_DIST[1] - SCENE_DIST[0]) * (g / 2 + 1)
                / args.num_steps / 2)
    spb = args.group_segs_per_block
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
    z = torch.randn((spec.total_size, ld), generator=gen, device=dev)
    gout = torch.randn((coords_s.shape[0], len(static.all_lods), ld),
                       generator=gen, device=dev)
    out = {'coords_s': coords_s, 'slot_valid': slot_valid,
           'block_cell': grp['block_cell'], 'z': z, 'g': gout,
           'static': static}
    if not voxel:
        occ = torch.rand((OCC_RES,) * 3, generator=gen, device=dev) < 0.3
        out.update(occ=ph.pack_occupancy(occ),
                   static_occ=ph.default_static(spec, OCC_RES))
    return out


def prune_inputs(dev, group_res):
    """B2's slots in the paged prune: one jittered point per cell of the
    128^3 occupancy grid in grouped order (2,097,152 rows), as (coords_s,
    slot_valid, block_cell)."""
    import torch
    from shacira_tpu_torch.models.nefs import nerf as nerf_mod
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    idx3, bcell, _ = nerf_mod._prune_block_layout(OCC_RES, group_res)
    u = torch.rand((idx3.shape[0], 3), generator=gen, device=dev)
    pts = ((torch.as_tensor(idx3, device=dev) + u) / OCC_RES) * 2 - 1
    return (pts, torch.ones((idx3.shape[0],), dtype=torch.bool, device=dev),
            torch.as_tensor(bcell, device=dev))


def phase_paged_kernels(dev):
    """B2 and B3 at the paged lego step's shapes (:func:`paged_inputs`),
    and B2 at the paged prune's 2,097,152 rows."""
    inp = paged_inputs(dev)
    slots = (inp['coords_s'], inp['slot_valid'], inp['block_cell'])
    z, static = inp['z'], inp['static']
    rows = {'paged_gather': check_paged_gather(
        'paged_gather (B2) train', *slots, z, static, reps=20)}
    rows['paged_gather_occupancy'] = check_paged_gather(
        'paged_gather (B2) train, occupancy row', *slots, z,
        inp['static_occ'], reps=20, occ=inp['occ'])
    rows['paged_scatter'] = check_paged_scatter(
        'paged_scatter (B3) train', *slots, inp['g'], static, reps=20)
    del inp, slots
    rows['paged_gather_prune'] = check_paged_gather(
        'paged_gather (B2) prune', *prune_inputs(dev, static.group_res), z,
        static, reps=5, plain_reps=1)
    rows['paged_gather_prune'].update(
        source='shacira_tpu_torch/csrc/paged_hash.cu',
        replaces='shacira_tpu/ops/paged_hash.py:720',
        use='paged prune density, 2,097,152 cells in grouped order, '
            'shacira_tpu/models/nefs/nerf.py:279')
    rows['paged_gather'].update(
        source='shacira_tpu_torch/csrc/paged_hash.cu',
        replaces='shacira_tpu/ops/paged_hash.py:720',
        use='paged encode forward, prune and eval, '
            'shacira_tpu/ops/paged_hash.py:1163')
    rows['paged_gather_occupancy'].update(
        source='shacira_tpu_torch/csrc/paged_hash.cu',
        replaces='shacira_tpu/ops/paged_hash.py:720',
        use="paged encode forward with the occupancy row (fine_mode="
            "'kernel'), shacira_tpu/ops/paged_hash.py:415, :777")
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


def write_rtmv_scene(outdir, views=64, res=256, seed=0, workers=1):
    """An RTMV-format scene: ``NNNNN.exr`` (R, G, B, A and the ray-distance
    depth Z, uncompressed) and ``NNNNN.json`` cameras of the analytic scene
    of ``tools/make_synthetic_data.py``, seen from a sphere of radius 3.2,
    the views rendered by ``workers`` processes.  The files equal
    ``make_synthetic_data.write_rtmv_scene``'s byte for byte; that one
    writes through the JAX package's EXR codec, this one through the
    port's."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from shacira_tpu_torch.ops.exr import write_exr
    from tools.make_synthetic_data import _render_view
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.RandomState(seed)
    camera_angle_x = 0.6911112070083618
    fx = 0.5 * res / np.tan(0.5 * camera_angle_x)
    poses = []
    for v in range(views):
        theta = 2 * np.pi * (v / views) * 7.13   # decorrelate from split order
        elev = 0.35 + 0.45 * rng.rand()
        r = 3.2
        pos = np.asarray([r * np.cos(theta) * np.cos(elev),
                          r * np.sin(elev),
                          r * np.sin(theta) * np.cos(elev)], np.float32)
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, pos
        poses.append(c2w)
    args = ([c2w for c2w in poses], [res] * views, [res] * views,
            [fx] * views)
    if workers > 1:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing
                                 .get_context('spawn')) as pool:
            views_out = list(pool.map(_render_view, *args))
    else:
        views_out = list(map(_render_view, *args))
    for v, (c2w, (rgba, depth)) in enumerate(zip(poses, views_out)):
        write_exr(os.path.join(outdir, f'{v:05d}.exr'),
                  {'R': rgba[..., 0], 'G': rgba[..., 1], 'B': rgba[..., 2],
                   'A': rgba[..., 3], 'Z': depth})
        meta = {'camera_data': {
            'cam2world': c2w.T.tolist(),      # the loader transposes
            'intrinsics': {'fx': fx, 'fy': fx, 'cx': res / 2.0,
                           'cy': res / 2.0}}}
        with open(os.path.join(outdir, f'{v:05d}.json'), 'w') as f:
            json.dump(meta, f)


PARITY_MARCHES = {
    # flat layout: the dense march, and the segmented 'exact' one
    'flat': dict(num_steps=128, max_samples=16384),
    'flat exact': dict(num_steps=128, max_samples=16384, segment_size=16,
                       seg_budget=1024, seg_dilation=3, fine_mode='exact'),
    # paged layout: the deferred march, and the sustained setting (lean
    # stage 1, two-level cull, transmittance culling)
    'paged': dict(num_steps=512, max_samples=4096, segment_size=8,
                  seg_budget=2048, coarse_level=4, seg_dilation=2,
                  eval_seg_budget=512, group_segs_per_block=4,
                  fine_mode='deferred')}
PARITY_MARCHES['paged exact'] = dict(PARITY_MARCHES['paged'],
                                     fine_mode='exact')
PARITY_MARCHES['paged sustained'] = dict(
    PARITY_MARCHES['paged'], lean_stage1=True, super_factor=4, term_tau=11.5)
# the voxel march at latent_dim 2, flat (dense integration) and paged (the
# fused crossing compaction, transmittance culling), on a sphere of
# occupied cells with a density cache
VOXEL_PARITY_MARCHES = {
    'voxel flat': dict(raymarch_type='voxel', num_steps=4,
                       max_intersections=16),
    'voxel paged': dict(raymarch_type='voxel', num_steps=8,
                        max_intersections=24, max_samples=4096,
                        eval_seg_budget=256, group_segs_per_block=4,
                        term_tau=11.5)}


def _parity_cfgs(march: str):
    """Small model and tracer configs of the parity step ``march`` (a key
    of ``PARITY_MARCHES``)."""
    from shacira_tpu_torch.models.grids.latent_grid import LatentGridConfig
    from shacira_tpu_torch.models.nefs.nerf import NeuralRadianceFieldConfig
    from shacira_tpu_torch.tracers.rf_tracer import RFTracerConfig
    paged = 'paged' in march
    voxel = march in VOXEL_PARITY_MARCHES
    tcfg = RFTracerConfig(**(VOXEL_PARITY_MARCHES if voxel
                             else PARITY_MARCHES)[march])
    if paged:       # 3 direct LODs (17..40) and 2 paged ones (62, 97)
        grid = dict(num_lods=5, min_grid_res=16, max_grid_res=96,
                    codebook_bitwidth=17, hash_layout='paged', page_res=16)
    else:
        grid = dict(num_lods=6, min_grid_res=4, max_grid_res=64,
                    codebook_bitwidth=12)
    grid = LatentGridConfig.from_geometric(
        feature_dim=4, latent_dim=2 if voxel else 1, multiscale_type='cat',
        feature_std=0.02, entropy_enabled=True, num_prob_layers=1, **grid
    ).with_ldec(dict(ldec_std=0.1, use_shift=True, use_sga=True,
                     diff_sampling=True))
    # a paged voxel crossing must fit the page cover: one cell of 128^3
    blas = (7 if voxel else 5) if paged else 4
    mcfg = NeuralRadianceFieldConfig(grid=grid, hidden_dim=32,
                                     view_embedder='positional',
                                     blas_level=blas, amp=False)
    return mcfg, tcfg


def phase_parity(dev, march: str):
    """One small step on the card against the same step on the CPU, with
    the march ``march`` (a key of ``PARITY_MARCHES`` or
    ``VOXEL_PARITY_MARCHES``; the voxel ones on a sphere of occupied cells
    with a density cache, so that transmittance culling drops some)."""
    import torch
    from shacira_tpu_torch import optim
    from shacira_tpu_torch.trainers.multiview_trainer import (
        MultiviewTrainer, MultiviewTrainerConfig, StepDraws)
    data = sphere_scene(4, 24)
    mcfg, tcfg = _parity_cfgs(march)
    paged = 'paged' in march
    cfg = MultiviewTrainerConfig(epochs=10, prune_every=-1)
    cpu = MultiviewTrainer(cfg, mcfg, tcfg, data, num_rays=256, device='cpu')
    gpu = MultiviewTrainer(cfg, mcfg, tcfg, data, num_rays=256, device=dev)
    if gpu.use_paged != paged:
        raise AssertionError('the parity step took the wrong trace path')
    if march in VOXEL_PARITY_MARCHES:
        occ_np, dens = _sphere_occupancy(mcfg.blas_level)
        for tr in (cpu, gpu):
            tr.set_occupancy({
                'occ': torch.as_tensor(occ_np, device=tr.device),
                'density': torch.as_tensor(dens, device=tr.device)})
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
    log(f'  small {march} step card vs CPU: loss '
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
    from shacira_tpu_torch.accel import occupancy as occ
    from shacira_tpu_torch.ops import paged_hash as ph
    from shacira_tpu_torch.ops import scatter
    return {'scatter_add': scatter.scatter_add.launches,
            'segment_sum': scatter.segment_sum.launches,
            'paged_gather': ph.paged_gather.launches,
            'paged_gather_occupancy': ph.paged_gather.occupancy_launches,
            'paged_scatter': ph.paged_scatter.launches,
            'voxel_crossings': occ.voxel_crossings.launches}


def _reset_launches():
    from shacira_tpu_torch.accel import occupancy as occ
    from shacira_tpu_torch.ops import paged_hash as ph
    from shacira_tpu_torch.ops import scatter
    scatter.reset_launches()
    ph.reset_launches()
    occ.reset_launches()


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def phase_lego(dev, prune_every, paged: bool = False, fine_mode='deferred'):
    """Full-width lego-config training, configured through the app's code
    (flat layout, or the paged one with ``PAGED_FLAGS`` and ``fine_mode``).

    Steps run as the trainer runs them, one chunk after another with no
    host sync between steps, so step times are means over blocks of steps,
    the device drained at both ends: step 1 (warm-up), steps 2 ..
    prune_every - 1, the step that ends in the prune, and the steps past
    it."""
    import torch
    from shacira_tpu_torch.apps.train_nerf import build_trainer
    if prune_every is not None:
        log(f'  prune_every lowered to {prune_every} through the CLI')
    args = lego_args(dev, paged, prune_every, fine_mode)
    if args.prune_every < 3:
        raise ValueError('the lego phase needs prune_every >= 3')
    data = sphere_scene(num_views=24, res=SCENE_RES)
    trainer = build_trainer(args, data)
    if trainer.use_paged != paged or (
            paged and trainer.tracer_cfg.fine_mode != fine_mode):
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
           f'{args.page_res}, fine_mode {fine_mode}' if paged else ''))
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
        'fine_mode': trainer.tracer_cfg.fine_mode if paged else None,
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
        # 'kernel': every training step's B2 carries the occupancy row;
        # the prune and the evaluation (which defers) run it without
        with_occ = trainer.iteration if fine_mode == 'kernel' else 0
        if (before_eval['paged_gather_occupancy'] != with_occ
                or in_eval['paged_gather_occupancy'] != 0):
            raise AssertionError(f'B2 occupancy-row launches: '
                                 f'{before_eval} (want {with_occ} in '
                                 f'training), {in_eval} in eval')
    return result, launches, trainer, args, data


def _on_ladder(v: int) -> bool:
    """``v`` is 2^k or 1.5 * 2^k (the adaptive budgets' rungs)."""
    def pow2(x):
        return x > 0 and x & (x - 1) == 0
    return pow2(v) or (v % 3 == 0 and pow2(v // 3))


BUDGETS = ('max_samples', 'seg_budget', 'eval_seg_budget')


def phase_sustained(dev, prune_every):
    """The paged lego config in the JAX bench's headline setting
    (``PAGED_FLAGS`` + ``SUSTAINED_FLAGS``) from the app's config code:
    steps 1-200 across two prunes, each followed by the budget adaptation;
    the budgets, probe fractions and occupancy logged after each prune;
    steps 201-203 profiled (after the second prune, at the adapted
    budgets), steps 204-299 timed against steps 2-99 (before the first
    prune, at the base budgets); one view evaluated.  Launch counts are
    zeroed before and read after; B1(b), B2 and B3 must have launched in
    training, B2 also in the prune and in the evaluation; the lean march
    and the two-level cull must have run every step.  Then steps 300-313
    at shrunk budgets (:func:`_shrunk_budget_steps`)."""
    import torch
    from shacira_tpu_torch.apps.train_nerf import build_trainer
    from shacira_tpu_torch.tracers import rf_tracer
    args = lego_args(dev, True, prune_every, 'deferred', SUSTAINED_FLAGS)
    if args.prune_every < 5:
        raise ValueError('the sustained phase needs prune_every >= 5')
    data = sphere_scene(num_views=24, res=SCENE_RES)
    trainer = build_trainer(args, data)
    base = trainer.tracer_cfg
    if not (trainer.use_paged and base.lean_stage1 and base.super_factor == 4
            and base.term_tau == 11.5 and base.super_dilation > 0
            and trainer.cfg.adaptive_budget):
        raise AssertionError(f'the sustained trainer took the wrong path: '
                             f'{base}')
    # count the lean march and the two-level cull where the trace calls them
    calls = {'_trace_ray_deferred_lean': 0, '_lean_src2_two_level': 0}
    originals = {name: getattr(rf_tracer, name) for name in calls}
    for name in calls:
        def counted(*a, _fn=originals[name], _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(rf_tracer, name, counted)
    try:
        return _drive_sustained(trainer, args, base, calls) + (args,)
    finally:
        for name, fn in originals.items():
            setattr(rf_tracer, name, fn)


def _drive_sustained(trainer, args, base, calls):
    """The training, profile and evaluation of :func:`phase_sustained`."""
    import torch
    from shacira_tpu_torch.tracers import rf_tracer
    # record the probe fractions the adaptation reads
    probes = []
    for name in ('_occupied_sample_fraction', '_live_segment_fraction'):
        def recorded(*a, _fn=getattr(trainer, name), _name=name, **k):
            v = _fn(*a, **k)
            probes.append((_name, v))
            return v
        setattr(trainer, name, recorded)
    entries, prunes = [], []

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(num_iterations=n, log_fn=lambda e: entries.append(e)
                      if 'iteration' in e else None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    def after_prune():
        """The refreshed grids, budgets and probes of the prune just run."""
        o = trainer.occ_state
        raw = {k: o[k] for k in ('occ', 'density')}
        ocfg = trainer.model_cfg.occ_cfg
        if not (torch.equal(o['coarse2'], rf_tracer.coarse_packed_grid(
                raw, ocfg, base)) and torch.equal(o['super'], rf_tracer.
                                                   super_grid(raw, ocfg,
                                                              base))):
            raise AssertionError("'coarse2' / 'super' not refreshed")
        act = trainer.active_tracer_cfg
        rec = {'iteration': trainer.iteration,
               'occupancy': entries[-1]['occupancy'],
               'sample_budget_logged': entries[-1].get('sample_budget'),
               **{f: getattr(act, f) for f in BUDGETS},
               **{f'base_{f}': getattr(base, f) for f in BUDGETS},
               **dict(probes[-2:])}
        prunes.append(rec)
        log('  after prune: ' + json.dumps(rec))
        if not all(_on_ladder(getattr(act, f))
                   and getattr(act, f) <= getattr(base, f) for f in BUDGETS):
            raise AssertionError(f'budgets off the ladder or above base: '
                                 f'{rec}')
        if rec['sample_budget_logged'] != act.max_samples:
            raise AssertionError('the log entry misses the sample budget')

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    first_s = timed(1)
    block_s = timed(args.prune_every - 2)
    before_prune = _launch_counts()
    prune_s = timed(1)
    in_prune_step = _delta(_launch_counts(), before_prune)
    after_prune()
    between_s = timed(args.prune_every)
    after_prune()
    steps_before_profile = trainer.iteration
    lean_calls = dict(calls)
    launches_train = _launch_counts()
    log('phase sustained profile:')
    prof = phase_profile(trainer, 3, 'sustained, after the second prune',
                         between_s * 1e3)
    n_after = 3 * args.prune_every - 1 - trainer.iteration
    after_s = timed(n_after)
    # the idle share against the adapted steps timed without the profiler
    prof['unprofiled_step_ms'] = after_s * 1e3
    prof['device_idle_share'] = 1.0 - prof['device_busy_ms_per_step'] / (
        after_s * 1e3)
    log(f'  sustained profile against steps {trainer.iteration - n_after + 1}'
        f'-{trainer.iteration} ({after_s * 1e3:.3f} ms a step): device idle '
        f'share {prof["device_idle_share"]:.4f}')
    before_eval = _launch_counts()
    metrics = trainer.evaluate(view_indices=[0])
    torch.cuda.synchronize()
    launches = _launch_counts()
    in_eval = _delta(launches, before_eval)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    result = {
        'layout': 'paged', 'setting': 'sustained',
        'steps': trainer.iteration, 'first_step_ms': first_s * 1e3,
        'mean_step_ms': block_s * 1e3,
        'mean_step_ms_of_steps': [2, args.prune_every - 1],
        'prune_step_ms': prune_s * 1e3,
        'mean_step_ms_between_prunes': between_s * 1e3,
        'mean_step_ms_adapted': after_s * 1e3,
        'mean_step_ms_adapted_of_steps': [trainer.iteration - n_after + 1,
                                          trainer.iteration],
        'rays_per_s': args.num_rays_sampled_per_img / block_s,
        'rays_per_s_adapted': args.num_rays_sampled_per_img / after_s,
        'loss_first': entries[0]['loss'], 'loss_last': entries[-1]['loss'],
        'psnr_first': entries[0]['psnr'], 'psnr_last': entries[-1]['psnr'],
        'prunes': prunes, 'eval_psnr_view0': metrics['psnr'],
        'peak_mem_gb': peak_gb, 'launches': launches,
        'launches_in_prune_step': in_prune_step, 'launches_in_eval': in_eval,
        'lean_march_calls': lean_calls}
    log('  sustained: ' + json.dumps(result))
    if not all(math.isfinite(e['loss']) for e in entries):
        raise AssertionError('non-finite training loss')
    if not entries[-1]['loss'] < entries[0]['loss']:
        raise AssertionError('training loss did not fall')
    if not math.isfinite(metrics['psnr']):
        raise AssertionError('non-finite evaluation PSNR')
    # every training step ran the lean march through the two-level cull
    if not (lean_calls['_trace_ray_deferred_lean']
            == lean_calls['_lean_src2_two_level'] == steps_before_profile):
        raise AssertionError(f'lean / two-level calls {lean_calls} in '
                             f'{steps_before_profile} steps')
    for wrapper in ('segment_sum', 'paged_gather', 'paged_scatter'):
        if launches_train[wrapper] < steps_before_profile:
            raise AssertionError(f'{wrapper} did not launch every step: '
                                 f'{launches_train}')
    if in_prune_step['paged_gather'] != 2:
        raise AssertionError(f'B2 did not run in the prune: {in_prune_step}')
    if in_eval['paged_gather'] < 1 or in_eval['paged_scatter'] != 0:
        raise AssertionError(f'eval did not go through B2: {in_eval}')
    result['shrunk'] = _shrunk_budget_steps(trainer, base, probes, timed)
    return result, launches


def _shrunk_budget_steps(trainer, base, probes, timed):
    """After the third prune: the budgets that the adaptation gives for a
    quarter of the last probed fractions (a sparser scene), 10 steps timed
    and 3 profiled there, so that B1(b), B2 and B3 run at launch shapes
    other than the base budgets' in the same process."""
    from dataclasses import replace

    from shacira_tpu_torch.trainers.multiview_trainer import adapted_budgets
    timed(1)                                      # step 300 and its prune
    fr = dict(probes[-2:])
    shrunk = adapted_budgets(
        base, trainer.num_rays, fr['_occupied_sample_fraction'] / 4,
        fr['_live_segment_fraction'] / 4, trainer.cfg.min_budget,
        trainer.cfg.budget_headroom)
    trainer.active_tracer_cfg = replace(base, **shrunk)
    before = _launch_counts()
    step_s = timed(10)
    prof = phase_profile(trainer, 3, f'sustained, budgets {shrunk}',
                         step_s * 1e3)
    ran = _delta(_launch_counts(), before)
    out = {'budgets': shrunk, 'mean_step_ms': step_s * 1e3,
           'device_busy_ms_per_step': prof['device_busy_ms_per_step'],
           'launches': ran}
    log('  shrunk budgets: ' + json.dumps(out))
    if not all(_on_ladder(v) and v < getattr(base, f)
               for f, v in shrunk.items()):
        raise AssertionError(f'a quarter of the fractions left a budget '
                             f'at its base: {shrunk}')
    if not all(ran[w] == 13 for w in ('segment_sum', 'paged_gather',
                                      'paged_scatter')):
        raise AssertionError(f'launches at the shrunk budgets: {ran}')
    return out


# other march modes and options from the app's flags: (paged, fine mode,
# extra flags)
MODES = {'flat exact': (False, None, ['--segment-size', '16',
                                      '--fine-mode', 'exact']),
         'paged exact': (True, 'exact', []),
         'paged random_lod': (True, 'deferred', ['--random-lod', 'true'])}


def phase_modes(dev):
    """Each of ``MODES`` at full lego width through the app's config code:
    3 training steps, counts zeroed before and read after; the flat modes
    must launch B1(a) and B1(b), the paged ones B1(b), B2 and B3, every
    step."""
    import torch
    from shacira_tpu_torch.apps.train_nerf import build_trainer
    data = sphere_scene(num_views=24, res=SCENE_RES)
    launches = {}
    for name, (paged, fine_mode, extra) in MODES.items():
        args = lego_args(dev, paged, None, fine_mode or 'deferred', extra)
        trainer = build_trainer(args, data)
        tcfg = trainer.tracer_cfg
        if (trainer.use_paged != paged or tcfg.fine_mode != args.fine_mode
                or trainer.cfg.random_lod != args.random_lod):
            raise AssertionError(f'{name}: the trainer took the wrong path')
        entries = []
        _reset_launches()
        trainer.train(num_iterations=3, log_fn=entries.append)
        torch.cuda.synchronize()
        launches[name] = _launch_counts()
        log(f'  {name}: segment_size {tcfg.segment_size}, fine_mode '
            f'{tcfg.fine_mode}, random_lod {trainer.cfg.random_lod}, loss '
            f'{entries[-1]["loss"]:.6f}, launches {launches[name]}')
        want = (('segment_sum', 'paged_gather', 'paged_scatter') if paged
                else ('scatter_add', 'segment_sum'))
        if not (math.isfinite(entries[-1]['loss'])
                and all(launches[name][w] == 3 for w in want)):
            raise AssertionError(f'{name}: loss {entries[-1]["loss"]}, '
                                 f'launches {launches[name]}')
        del trainer
        torch.cuda.empty_cache()
    return launches


# the app phase: training flags of its three runs (after the lego config,
# PAGED_FLAGS and SUSTAINED_FLAGS), 40 views a epoch
APP_RUNS = (('train', ['--epochs', '3', '--save-every', '1']),
            ('resume', ['--epochs', '4', '--save-every', '1', '--resume',
                        'true']),
            ('valid-only', ['--epochs', '4', '--save-every', '1',
                            '--resume', 'true', '--valid-only']))
# the app's calls timed in the app phase: (owner module or class, name)
APP_TIMED = (('checkpoint', 'save_trainer'), ('checkpoint', 'save_model'),
             ('checkpoint', 'restore_trainer'), ('checkpoint', 'load_model'),
             ('trainer', 'evaluate'), ('trainer', 'size_report'),
             ('app', 'render_turntable'))


def phase_app(dev):
    """The app itself (``apps/train_nerf.main``) at full lego width in the
    headline setting on the Blender-format scene of
    ``tools/make_synthetic_data.write_nerf_scene(views=40, val_views=2,
    res=128)``: 120 steps across the prune at 100 with a resume state every
    epoch, a resumed run to step 160, and ``--valid-only``, which must
    reload the models and reproduce the second run's PSNR to 1e-4 dB.
    LPIPS runs on random weights (its value means nothing).  The app's
    checkpoint, evaluation, size-report and turntable calls are timed (the
    card drained around each).  Launch counts are zeroed before the first
    run and read after the last: B1(b), B2 and B3 must have launched."""
    import logging
    import tempfile

    import torch
    from shacira_tpu_torch.apps import train_nerf
    from shacira_tpu_torch.ops import lpips as lpips_mod
    from shacira_tpu_torch.trainers.multiview_trainer import MultiviewTrainer
    from shacira_tpu_torch.utils import checkpoint
    from tools.make_synthetic_data import write_nerf_scene
    owners = {'checkpoint': checkpoint, 'trainer': MultiviewTrainer,
              'app': train_nerf}
    seconds, originals = {}, {}
    for owner, name in APP_TIMED:
        def timed(*a, _fn=getattr(owners[owner], name), _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            seconds.setdefault(_name, []).append(time.perf_counter() - t0)
            return out
        originals[owner, name] = getattr(owners[owner], name)
        setattr(owners[owner], name, timed)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger('shacira_tpu_torch')
    logger.addHandler(handler)
    env = os.environ.get(lpips_mod.ENV_VAR)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            weights = os.path.join(tmp, 'lpips_random.npz')
            np.savez(weights, **lpips_mod.random_weights(0))
            os.environ[lpips_mod.ENV_VAR] = weights
            return _drive_app(dev, tmp, train_nerf, write_nerf_scene,
                              seconds, lines)
    finally:
        for (owner, name), fn in originals.items():
            setattr(owners[owner], name, fn)
        logger.removeHandler(handler)
        if env is None:
            os.environ.pop(lpips_mod.ENV_VAR, None)
        else:
            os.environ[lpips_mod.ENV_VAR] = env


def _drive_app(dev, tmp, train_nerf, write_nerf_scene, seconds, lines):
    """The three runs of :func:`phase_app` in ``tmp``."""
    import torch
    scene = os.path.join(tmp, 'scene')
    t0 = time.perf_counter()
    write_nerf_scene(scene, views=40, val_views=2, res=128)
    log(f'  scene: 40 + 2 views of 128 x 128 in '
        f'{time.perf_counter() - t0:.1f} s')
    base = (['--config', os.path.join(ROOT, 'configs', 'nerf_lego.yaml'),
             '--device', dev, '--dataset-path', scene, '--log-dir',
             os.path.join(tmp, 'runs'), '--exp-name', 'lego']
            + PAGED_FLAGS + SUSTAINED_FLAGS)
    exp = os.path.join(tmp, 'runs', 'lego')
    metrics, logs = {}, {}
    _reset_launches()
    for name, flags in APP_RUNS:
        del lines[:]
        seconds.clear()
        t0 = time.perf_counter()
        if train_nerf.main(base + flags) != 0:
            raise AssertionError(f'app run {name} failed')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(exp, 'metrics.json')) as f:
            metrics[name] = json.load(f)
        logs[name] = list(lines)
        m = metrics[name]
        log(f'  app {name}: {wall:.1f} s; psnr {m["psnr"]:.6f} ssim '
            f'{m["ssim"]:.6f} lpips (random weights, meaningless) '
            f'{m["lpips"]:.6f}; latent_size_kb {m["latent_size_kb"]} '
            f'total_size_kb {m["total_size_kb"]} stream {m["stream"]}')
        log(f'  app {name} seconds: ' + json.dumps(
            {k: [round(s, 4) for s in v] for k, v in seconds.items()}))
        log(f'  app {name} wrote: {sorted(os.listdir(exp))}')
    torch.cuda.synchronize()
    launches = _launch_counts()
    log(f'  app metrics.json: {json.dumps(metrics["resume"])}')
    log(f'  app launches: {launches}')
    steps = [ln for ln in logs['train'] + logs['resume']
             if ln.startswith('iteration ')]
    log(f'  app training log: {steps}')
    for name, m in metrics.items():
        if not all(math.isfinite(m[k]) for k in ('psnr', 'ssim', 'lpips',
                                                  'total_size_kb')):
            raise AssertionError(f'app {name}: non-finite metrics {m}')
        if not (m['total_size_kb'] > 0 and m['stream'] in ('histogram',
                                                           'prob_model')):
            raise AssertionError(f'app {name}: size report {m}')
    if 'Resumed at iteration 120' not in logs['resume'] or not any(
            ln.startswith('iteration 160 ') for ln in logs['resume']):
        raise AssertionError(f'the resumed run did not continue from '
                             f'iteration 120 to 160: {logs["resume"]}')
    if ('valid-only: loaded model_best.ckpt' not in logs['valid-only']
            or any(ln.startswith('iteration ') for ln in logs['valid-only'])):
        raise AssertionError(f'--valid-only did not reload without training: '
                             f'{logs["valid-only"]}')
    diff = abs(metrics['valid-only']['psnr'] - metrics['resume']['psnr'])
    log(f'  --valid-only PSNR - resumed run PSNR: {diff:.3e} dB')
    if not diff <= 1e-4:
        raise AssertionError('--valid-only did not reproduce the PSNR')
    for f in ('metrics.json', 'model_best.ckpt', 'resume_state.ckpt',
              'val_view0.png', 'turntable.gif'):
        if not os.path.exists(os.path.join(exp, f)):
            raise AssertionError(f'the app wrote no {f}')
    missing = [w for w in ('segment_sum', 'paged_gather', 'paged_scatter')
               if launches[w] <= 0]
    if missing:
        raise AssertionError(f'the app launched no {missing}')
    return launches


# ---------------------------------------------------------------------------
# The image INR path: kodak (full image) and pearl (sampled), kernel B1 as
# the 2D hash backward.
# ---------------------------------------------------------------------------

KODAK_HW = (512, 768)          # bench.py's image stage: kodak's shape
PEARL_HW = (2048, 2048)        # a procedural stand-in for the 67 Mpix image
PEARL_SAMPLES = 1 << 18        # configs/pearl.yaml num_samples
IMAGE_FLAGS = ['--epochs', '300', '--log-every', '100', '--save-every', '100']
PEARL_FLAGS = ['--epochs', '2']
IMAGE_TIMED_STEPS = 200
# the calls timed in the pearl phase: (owner module or class, name)
PEARL_TIMED = (('trainer', 'validate'), ('checkpoint', 'save_trainer'),
               ('trainer', 'size_report'))


def _kodak_spec():
    from shacira_tpu_torch.ops.hashgrid import (
        HashGridSpec, geometric_resolutions)
    return HashGridSpec(geometric_resolutions(16, 512, 24), 11, 2)


def _pearl_spec():
    from shacira_tpu_torch.ops.hashgrid import (
        HashGridSpec, geometric_resolutions)
    return HashGridSpec(geometric_resolutions(16, 10725, 16), 23, 2)


def image_scatter_inputs(dev):
    """B1's inputs on the image path, name -> (idx int32 [L * N * 4], vals
    [L * N * 4, 1], table rows): the 2D hash backward's corner rows in the
    ``[L, N, 4]`` order of ``hash_encode_affine``, each value a bilinear
    corner weight times a random gradient, as the backward forms them:

    * ``scatter_add_image``: kodak's grid (24 LODs 16..512, 2^11 a LOD,
      40,282 rows) on the 512 x 768 pixel lattice in row-major order, as the
      full-image step feeds it: 37,748,736 updates;
    * ``scatter_add_image_shuffled``: the same pixels in the order of
      ``ImageDataset('full')``'s permutation (seed 0);
    * ``scatter_add_pearl``: pearl's grid (16 LODs to 10725, 2^23 a LOD,
      39,727,145 rows) at 2^18 uniformly random pixels of a 2048^2 image:
      16,777,216 updates."""
    import torch
    from shacira_tpu_torch.datasets.image import ImageDataset, pixel_coords
    from shacira_tpu_torch.ops import hashgrid
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rows(coords, spec):
        gidx, w = hashgrid._all_corners(coords, spec)      # [L, N, 4]
        g = torch.randn(gidx.shape[:2] + (1,), generator=gen, device=dev)
        return (gidx.reshape(-1), (w * g).reshape(-1, 1), spec.total_size)

    h, w = KODAK_HW
    lattice = pixel_coords(h, w)
    perm = ImageDataset(np.zeros((h, w, 3), np.float32)).shuffle_idx
    kodak = _kodak_spec()
    out = {'scatter_add_image': rows(torch.as_tensor(lattice, device=dev),
                                     kodak),
           'scatter_add_image_shuffled': rows(
               torch.as_tensor(lattice[perm], device=dev), kodak)}
    ph, pw = PEARL_HW
    idx = torch.randint(0, ph * pw, (PEARL_SAMPLES,), generator=gen,
                        device=dev)
    coords = torch.stack([(torch.div(idx, pw, rounding_mode='floor')
                           .double() / ph - 0.5) * 2.0,
                          (torch.remainder(idx, pw).double() / pw - 0.5)
                          * 2.0], dim=-1).float()
    out['scatter_add_pearl'] = rows(coords, _pearl_spec())
    return out


def phase_image_kernels(dev):
    """B1 at the image path's three shapes against its plain version, with
    its time, bound, ``index_add_`` time and counted atomics."""
    from shacira_tpu_torch.ops import scatter
    use = {'scatter_add_image': 'kodak 2D hash backward, row-major pixels '
                                '(the full-image step)',
           'scatter_add_image_shuffled': "kodak 2D hash backward, "
                                         "ImageDataset('full') order",
           'scatter_add_pearl': 'pearl 2D hash backward, 2^18 random '
                                'pixels'}
    rows = {}
    for name, (idx, vals, t) in image_scatter_inputs(dev).items():
        rows[name] = check_scatter(name, idx, vals, t, scatter.scatter_add,
                                   scatter.scatter_add_plain, reps=5)
        rows[name].update(use=use[name],
                          source='shacira_tpu_torch/csrc/scatter.cu',
                          replaces='shacira_tpu/ops/pallas_scatter.py:29')
        del idx, vals
    return rows


def _image_parity_model():
    from shacira_tpu_torch.models.grids.latent_grid import LatentGridConfig
    from shacira_tpu_torch.models.nefs.image import NeuralImageConfig
    grid = LatentGridConfig.from_geometric(
        feature_dim=1, num_lods=8, min_grid_res=8, max_grid_res=96,
        latent_dim=1, multiscale_type='cat', resolution_dim=2,
        feature_std=0.5, codebook_bitwidth=10, init_grid='uniform',
        num_prob_layers=2, entropy_enabled=True
    ).with_ldec(dict(norm='max', ldecode_matrix='sq', use_shift=True,
                     ldec_std=0.1, use_sga=True, diff_sampling=True))
    return NeuralImageConfig(grid=grid, hidden_dim=16)


def phase_image_parity(dev):
    """One small image step on the card against the same step on the CPU
    (same params and draws), full-image and 'wreplace': loss to 1e-4, the
    Adam first moments to 1e-3 of each leaf's largest entry, and B1
    launched once by the card's step."""
    import torch
    from shacira_tpu_torch import optim
    from shacira_tpu_torch.datasets.image import ImageDataset, pixel_coords
    from shacira_tpu_torch.ops import scatter
    from shacira_tpu_torch.trainers.image_trainer import (
        ImageStepDraws, ImageTrainer, ImageTrainerConfig)
    from tools.make_synthetic_data import synth_photo
    h, w = 48, 64
    img = np.round(synth_photo(h, w, seed=3) * 255) / 255
    mcfg = _image_parity_model()
    cfg = ImageTrainerConfig(epochs=10, use_sga=True, norm='max',
                             entropy_reg=1e-3, entropy_reg_end=1e-3)
    for mode, ns in (('full', -1), ('wreplace', 1000)):
        cpu = ImageTrainer(cfg, mcfg, ImageDataset(img, ns, mode),
                           device='cpu')
        gpu = ImageTrainer(cfg, mcfg, ImageDataset(img, ns, mode), device=dev)
        gpu.set_params(optim.tree_map(lambda t: t.detach().clone().to(dev),
                                      cpu.params))
        d = cpu.draw_step(use_sga=True)
        if mode == 'full':
            c = torch.as_tensor(pixel_coords(h, w))
            batches = ((c, torch.as_tensor(cpu.dataset.rgb)),
                       (c.to(dev), torch.as_tensor(cpu.dataset.rgb,
                                                   device=dev)))
        else:
            cpu._sampling_setup()
            gpu._sampling_setup()
            batches = (cpu.pixel_batch(d.idx),
                       gpu.pixel_batch(d.idx.to(dev)))
        kw = dict(ent_lambda=1e-3, temperature=0.5, lr_ldec=1e-2,
                  use_sga=True, do_recalib=True)
        m_cpu = cpu.step(*batches[0], d, **kw)
        before = scatter.scatter_add.launches
        m_gpu = gpu.step(*batches[1], ImageStepDraws(
            sga_u=d.sga_u.to(dev), noise=d.noise.to(dev)), **kw)
        torch.cuda.synchronize()
        b1 = scatter.scatter_add.launches - before
        loss_c, loss_g = float(m_cpu['loss']), float(m_gpu['loss'])
        mu_c = dict(optim.tree_leaves_with_path(cpu.opt_state['mu']))
        worst, worst_path = 0.0, None
        for path, m in optim.tree_leaves_with_path(gpu.opt_state['mu']):
            scale = float(mu_c[path].abs().max())
            if scale == 0.0:
                continue
            rel = float((m.cpu() - mu_c[path]).abs().max()) / scale
            if rel >= worst:
                worst, worst_path = rel, '/'.join(path)
        log(f'  small image step ({mode}) card vs CPU: loss {loss_g:.7f} vs '
            f'{loss_c:.7f}, psnr {float(m_gpu["psnr"]):.4f} vs '
            f'{float(m_cpu["psnr"]):.4f}, Adam first moment max rel diff '
            f'{worst:.3e} ({worst_path}), B1 launches {b1}')
        if not (math.isfinite(loss_g)
                and abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)):
            raise AssertionError(f'image step ({mode}): card loss disagrees '
                                 'with the CPU step')
        if not worst <= 1e-3:
            raise AssertionError(f'image step ({mode}): card gradients '
                                 'disagree with the CPU step')
        if b1 != 1:
            raise AssertionError(f'image step ({mode}): {b1} B1 launches')


def _image_args(dev, config, images, log_dir, *extra):
    return (['--config', os.path.join(ROOT, 'configs', config), '--device',
             dev, '--dataset-path', images, '--log-dir', log_dir,
             '--exp-name', 'run'] + list(extra))


def _timed_image_block(args, image_path, epochs, label):
    """A trainer of the app's ``args`` on one image, warmed up one epoch,
    then ``epochs`` epochs timed (the card drained at both ends) and 3
    profiled; returns (seconds a step, steps, the profile)."""
    import torch
    from shacira_tpu_torch.apps.train_image import build_trainer
    from shacira_tpu_torch.datasets.image import ImageDataset, load_rgb
    ds = ImageDataset(load_rgb(image_path), args.num_samples,
                      args.sample_mode, args.seed)
    trainer = build_trainer(args, ds)
    trainer.train(epochs=1, finalize=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(epochs=epochs, finalize=False)
    torch.cuda.synchronize()
    steps = epochs * len(ds)
    step_s = (time.perf_counter() - t0) / steps
    per_profile = max(1, 3 // len(ds))
    prof = phase_profile(trainer, per_profile * len(ds), label,
                         step_s * 1e3, run=lambda: trainer.train(
                             epochs=per_profile, finalize=False))
    del trainer
    torch.cuda.empty_cache()
    return step_s, steps, prof


def phase_image(dev):
    """``apps/train_image.main`` with configs/kodak.yaml at full width (24
    LODs 16..512, 2^11 a LOD, hidden 16, SGA, norm 'max' every 10, entropy
    on) on two procedural Kodak-shaped photos
    (``tools/make_synthetic_data.write_images(n=2, h=512, w=768)``):
    ``IMAGE_FLAGS`` (300 epochs, so the SGA -> STE flip falls at 270; log
    and resume state every 100), then ``--valid-only``, which must give
    each image's PSNR within the JAX app test's 0.75 dB (the trained PSNR
    is the best step's before its update, the reloaded model is after it).
    Counts zeroed before the training run and read after: B1 once a step.
    Then the step timed outside the app (Mpix/s as ``bench.py``'s
    ``image_inr_train_mpix_per_s``) and profiled."""
    import tempfile

    import torch
    from shacira_tpu_torch import config as cfg_mod
    from shacira_tpu_torch.apps import train_image
    from tools.make_synthetic_data import write_images
    with tempfile.TemporaryDirectory() as tmp:
        images = os.path.join(tmp, 'images')
        t0 = time.perf_counter()
        write_images(images, n=2, h=KODAK_HW[0], w=KODAK_HW[1])
        log(f'  images: 2 of {KODAK_HW[0]} x {KODAK_HW[1]} in '
            f'{time.perf_counter() - t0:.1f} s')
        runs = os.path.join(tmp, 'runs')
        argv = _image_args(dev, 'kodak.yaml', images, runs, *IMAGE_FLAGS)
        _reset_launches()
        t0 = time.perf_counter()
        if train_image.main(argv) != 0:
            raise AssertionError('the image app failed')
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = _launch_counts()
        with open(os.path.join(runs, 'run', 'metrics.json')) as f:
            trained = json.load(f)
        t0 = time.perf_counter()
        if train_image.main(argv + ['--valid-only']) != 0:
            raise AssertionError('the image app failed with --valid-only')
        valid_s = time.perf_counter() - t0
        with open(os.path.join(runs, 'run', 'metrics.json')) as f:
            valid = json.load(f)
        files = sorted(os.listdir(os.path.join(runs, 'run', 'synth00')))
        args = cfg_mod.parse_args(cfg_mod.build_image_parser(),
                                  argv + ['--log-every', '-1'])
        step_s, steps, prof = _timed_image_block(
            args, os.path.join(images, 'synth00.png'), IMAGE_TIMED_STEPS,
            'image (kodak), full image')
    h, w = KODAK_HW
    out = {'train_s': train_s, 'valid_only_s': valid_s,
           'mean_step_ms': step_s * 1e3, 'timed_steps': steps,
           'image_inr_train_mpix_per_s': h * w / step_s / 1e6,
           'device_busy_ms_per_step': prof['device_busy_ms_per_step'],
           'device_idle_share': prof['device_idle_share'],
           'stream_syncs_per_step': prof['stream_syncs_per_step'],
           'device_ops_per_step': prof['device_ops_per_step'],
           'launches': launches, 'per_image': []}
    for t, v in zip(trained['per_image'], valid['per_image']):
        out['per_image'].append({k: t[k] for k in (
            'PSNR', 'BPP', 'total_size_kb', 'latent_size_kb', 'stream',
            'epoch')})
        out['per_image'][-1]['valid_only_PSNR'] = v['PSNR']
    log('  image: ' + json.dumps(out))
    log(f'  image wrote: {files}')
    for m, v in zip(trained['per_image'], valid['per_image']):
        if not (all(math.isfinite(m[k]) for k in ('PSNR', 'BPP',
                                                   'total_size_kb'))
                and m['stream'] in ('histogram', 'prob_model')
                and m['epoch'] == 300):
            raise AssertionError(f'image metrics: {m}')
        if not abs(v['PSNR'] - m['PSNR']) < 0.75:
            raise AssertionError(f'--valid-only PSNR {v["PSNR"]} against '
                                 f'the trained {m["PSNR"]}')
    for f in ('metrics.json', 'predicted.png', 'model_best.ckpt',
              'resume_state.ckpt'):
        if f not in files:
            raise AssertionError(f'the image app wrote no {f}')
    if launches['scatter_add'] != 2 * 300:
        raise AssertionError(f'B1 launches on the image path: {launches} '
                             '(want one a step, 600)')
    return launches


def phase_pearl(dev):
    """``apps/train_image.main`` with configs/pearl.yaml at its widths (16
    LODs to 10725, 2^23 a LOD, 39,727,145 rows, F = 4, hidden 96, AdamW,
    'wreplace' 2^18 pixels a step, noise every 50 steps, validation and a
    resume state every epoch) on a procedural 2048^2 photo for
    ``PEARL_FLAGS`` (2 epochs of 16 steps); the validation, resume-state
    and size-report calls timed, the peak of allocated memory read.
    Counts zeroed before and read after: B1 once a step.  Then the step
    timed outside the app (samples/s) and profiled."""
    import tempfile

    import torch
    from shacira_tpu_torch import config as cfg_mod
    from shacira_tpu_torch.apps import train_image
    from shacira_tpu_torch.trainers.image_trainer import ImageTrainer
    from shacira_tpu_torch.utils import checkpoint
    from tools.make_synthetic_data import write_images
    owners = {'checkpoint': checkpoint, 'trainer': ImageTrainer}
    seconds, originals = {}, {}
    for owner, name in PEARL_TIMED:
        def timed(*a, _fn=getattr(owners[owner], name), _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            seconds.setdefault(_name, []).append(time.perf_counter() - t0)
            return out
        originals[owner, name] = getattr(owners[owner], name)
        setattr(owners[owner], name, timed)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            images = os.path.join(tmp, 'images')
            t0 = time.perf_counter()
            write_images(images, n=1, h=PEARL_HW[0], w=PEARL_HW[1])
            log(f'  image: 1 of {PEARL_HW[0]} x {PEARL_HW[1]} in '
                f'{time.perf_counter() - t0:.1f} s')
            runs = os.path.join(tmp, 'runs')
            argv = _image_args(dev, 'pearl.yaml', images, runs, *PEARL_FLAGS)
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            if train_image.main(argv) != 0:
                raise AssertionError('the pearl app run failed')
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = _launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            app_seconds = {k: list(v) for k, v in seconds.items()}
            with open(os.path.join(runs, 'run', 'metrics.json')) as f:
                m = json.load(f)['per_image'][0]
            args = cfg_mod.parse_args(
                cfg_mod.build_image_parser(),
                argv + ['--valid-every', '-1', '--save-every', '-1',
                        '--log-every', '-1'])
            step_s, steps, prof = _timed_image_block(
                args, os.path.join(images, 'synth00.png'), 1,
                'pearl, 2^18 sampled pixels')
    finally:
        for (owner, name), fn in originals.items():
            setattr(owners[owner], name, fn)
    out = {'train_s': train_s, 'peak_mem_gb': peak_gb,
           'mean_step_ms': step_s * 1e3, 'timed_steps': steps,
           'samples_per_s': PEARL_SAMPLES / step_s,
           'device_busy_ms_per_step': prof['device_busy_ms_per_step'],
           'device_idle_share': prof['device_idle_share'],
           'stream_syncs_per_step': prof['stream_syncs_per_step'],
           'device_ops_per_step': prof['device_ops_per_step'],
           'seconds': app_seconds, 'launches': launches,
           'metrics': {k: m[k] for k in ('PSNR', 'BPP', 'total_size_kb',
                                         'latent_size_kb', 'stream',
                                         'epoch', 'best_val_psnr')}}
    log('  pearl: ' + json.dumps(out))
    if not (math.isfinite(m['PSNR']) and m['total_size_kb'] > 0
            and m['epoch'] == 2):
        raise AssertionError(f'pearl metrics: {m}')
    if len(app_seconds.get('validate', ())) != 2 or len(
            app_seconds.get('save_trainer', ())) != 3:
        raise AssertionError(f'pearl: validation and resume states every '
                             f'epoch: {app_seconds}')
    if launches['scatter_add'] != 2 * 16:
        raise AssertionError(f'B1 launches on the pearl path: {launches} '
                             '(want one a step, 32)')
    return launches


# ---------------------------------------------------------------------------
# The voxel march: kernel V1 (the DDA walk), RTMV data, configs/nerf_V8.yaml
# ---------------------------------------------------------------------------

V8_SCENE = dict(views=40, res=256)   # the generated RTMV scene, read at mip 2
# 4 epochs of 26 views: 104 steps across the prune at 100
V8_FLAGS = ['--epochs', '4', '--max-views', '26']
VOXEL_STEPS = 210                    # two prunes, 3 profiled steps, 7 more
DDA_STEP_OPS = 33    # f32 operations of one DDA step: 3 FMAs (6), the cell
                     # (9), the exits (12), min / max (6)


def v8_argv(dev, scene='', log_dir='', *extra):
    """The app's argv for configs/nerf_V8.yaml on the RTMV scene ``scene``
    with log directory ``log_dir`` and the flags ``extra``."""
    return ['--config', os.path.join(ROOT, 'configs', 'nerf_V8.yaml'),
            '--device', str(dev), '--dataset-path', scene, '--log-dir',
            log_dir, '--exp-name', 'v8', *extra]


def _nerf_args(argv):
    from shacira_tpu_torch import config as cfg_mod
    return cfg_mod.parse_args(cfg_mod.build_nerf_parser(), argv)


def v8_rays(data, dev, n=4096, seed=0):
    """``n`` random pixels of one training view as rays, as a step draws
    them."""
    import torch
    from shacira_tpu_torch.core.rays import make_rays
    rng = np.random.RandomState(seed)
    v = rng.randint(data.num_views)
    idx = rng.randint(0, data.rgb.shape[1], size=n)
    return make_rays(torch.as_tensor(data.rays_o[v, idx], device=dev),
                     torch.as_tensor(data.rays_d[v, idx], device=dev),
                     data.dist_min, data.dist_max)


def _ulps(got, want) -> float:
    """Largest ``|got - want|`` in units in the last place of ``want``."""
    import torch
    step = torch.nextafter(want, torch.full_like(want, math.inf)) - want
    return float(((got - want).abs() / step).max())


def dda_edge_rays(kind: str, n: int, res: int, seed: int = 0):
    """(origins, dirs, dist_min, dist_max) numpy f32 [n, 3] / [n] of a ray
    family that takes a DDA walk off its common path on a res^3 grid in the
    [-1, 1]^3 box: origins exactly on a cell face ('face'), edge ('edge')
    or corner ('corner'); rays along grid diagonals from a cell corner, in
    3D and in a plane ('diagonal': two or three faces crossed at once);
    direction components in (-1e-9, 0], which stall the walk, beside
    +5e-10, which does not ('stall'); rays whose box interval is empty
    ('empty': aimed away, distance bounds that end before the box, or
    inverted bounds)."""
    rng = np.random.RandomState(seed)
    cw = 2.0 / res
    o = rng.uniform(-0.95, 0.95, (n, 3))
    d = rng.normal(size=(n, 3))
    dmin, dmax = np.zeros(n), np.full(n, 6.0)
    if kind in ('face', 'edge', 'corner'):
        snap = np.argsort(rng.rand(n, 3), axis=1) < ('face', 'edge',
                                                     'corner').index(kind) + 1
        o = np.where(snap, np.round((o + 1.0) / cw) * cw - 1.0, o)
    elif kind == 'diagonal':
        d = rng.choice([-1.0, 1.0], (n, 3))
        d[np.arange(0, n, 2), rng.randint(0, 3, (n + 1) // 2)] = 0.0
        corner = rng.randint(0, res + 1, (n, 3)) * cw - 1.0
        o = corner - rng.randint(0, res, (n, 1)) * cw * d
    elif kind == 'stall':
        outside = np.arange(n) % 2 == 1
        o[outside] = 2.5 * d[outside] / np.linalg.norm(d[outside], axis=-1,
                                                       keepdims=True)
        d = rng.uniform(-0.9, 0.9, (n, 3)) - np.where(outside[:, None], o, 0)
    elif kind == 'empty':
        o = 2.5 * d / np.linalg.norm(d, axis=-1, keepdims=True)
        d = rng.uniform(-0.5, 0.5, (n, 3)) - o
        third = np.arange(n) % 3
        d[third == 0] *= -1.0                       # aimed away
        dmax[third == 1] = 0.5                      # ends before the box
        o[third == 2] *= 0.2                        # inside, bounds inverted
        dmin[third == 2], dmax[third == 2] = 3.0, 2.0
    else:
        raise ValueError(f'unknown ray family {kind!r}')
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    if kind == 'stall':
        tiny = np.float32([0.0, -0.0, -1e-10, -9.9e-10, 5e-10])
        axis = rng.randint(0, 3, n)
        d[np.arange(n), axis] = tiny[np.arange(n) % 5]
        two = np.arange(0, n, 4)                    # and a second axis
        d[two, (axis[two] + 1) % 3] = tiny[rng.randint(0, 4, two.size)]
    return (o.astype(np.float32), d, dmin.astype(np.float32),
            dmax.astype(np.float32))


DDA_EDGE_KINDS = ('face', 'edge', 'corner', 'diagonal', 'stall', 'empty')


def check_dda(name, state, ocfg, rays, max_isect, reps=20):
    """Kernel V1 against its plain version: ``valid`` and the depths equal
    bit for bit; timed with CUDA events over eager launches (``ms``, as
    every kernel, and the plain loop), also on the device alone
    (``graph_ms``: ``device_ms``), with its bound: the steps the walks take
    (each reads one occupancy byte and does ``DDA_STEP_OPS`` f32
    operations), the rays read and the slots written once.  Also the
    longest walk (the most steps a ray takes: the chain that sets the time)
    and the kernel's device microseconds per step of it."""
    import torch
    from shacira_tpu_torch.accel import occupancy as occ
    args = (state, ocfg, rays, max_isect)
    got = occ._launch_dda(*args)
    want = occ.voxel_crossings_plain(*args)
    torch.cuda.synchronize()
    mismatches = int((got['valid'] != want['valid']).sum())
    ulps = max(_ulps(got[k], want[k]) for k in ('entries', 'exits'))
    err = max(float((got[k] - want[k]).abs().max())
              for k in ('entries', 'exits'))
    exact = all(torch.equal(got[k], want[k]) for k in got)
    _, _, occ_l, ahead = occ.dda_steps(state, ocfg, rays)
    before = torch.cumsum(occ_l.long(), dim=1) - occ_l.long()
    per_ray = (ahead & (before < max_isect)).sum(dim=1)
    walked, longest = int(per_ray.sum()), int(per_ray.max())
    crossings = int(want['valid'].sum())
    del got, want, occ_l, ahead, before, per_ray
    n = rays.origins.shape[0]
    t_bytes = (walked + n * 8 * 4 + n * max_isect * 9) / HBM_BYTES_PER_S * 1e3
    t_ops = walked * DDA_STEP_OPS / F32_FLOPS * 1e3
    b_ms, b_by = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops,
                                                              'operations')
    ms = time_ms(lambda: occ._launch_dda(*args), reps)
    device_ms = graph_ms(lambda: occ._launch_dda(*args), reps)
    plain_ms = time_ms(lambda: occ.voxel_crossings_plain(*args), 1)
    us_step = device_ms * 1e3 / max(longest, 1)
    log(f'  {name}: rays={n} res={ocfg.res} I={max_isect} steps walked '
        f'{walked} ({walked / n:.1f} a ray, longest {longest}), crossings '
        f'{crossings}, valid mismatches {mismatches}, depth max_abs_err='
        f'{err:.3e} max ulps {ulps:.3g}; kernel {ms:.4f} ms, '
        f'{device_ms:.4f} ms on the device ({us_step:.4f} us a step of the '
        f'longest walk), plain {plain_ms:.4f} ms, bound '
        f'{b_ms:.6f} ms ({b_by})')
    if mismatches or not exact:
        raise AssertionError(f'{name}: V1 disagrees with its plain version '
                             f'({mismatches} valid mismatches, {ulps} ulps)')
    return {'max_abs_err': err, 'max_rel_err': None, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
            'library_ms': None, 'device_ms': device_ms,
            'valid_mismatches': mismatches, 'max_ulps': ulps,
            'steps_walked': walked,
            'longest_walk': longest, 'us_per_step': us_step,
            'crossings': crossings}


def phase_voxel_kernels(dev, data):
    """The kernels at the voxel path's shapes: V1 on 4096 rays of the v8
    scene against its plain version, on the occupancy seeded from the
    scene's point cloud, on a grid with every cell occupied (every ray
    overflows its 64 slots) and, on the seeded grid, on 3072 rays of
    ``DDA_EDGE_KINDS`` (the walk's rare paths); B1(a) as the flat V8
    backward (4096 x 64 x 16 samples of the dense voxel march in ray order,
    masked samples' zero gradients, 20 LODs x 8 corners, width 2, into
    1,966,521 rows); B1(b) as the paged voxel step's per-ray sums (262,144
    x 5 into 4096); B2 and B3 at ``ld`` 2 on 16,384 crossings of 16
    samples (262,144 slots)."""
    import torch
    from shacira_tpu_torch import config as cfg_mod
    from shacira_tpu_torch.accel import occupancy as occ
    from shacira_tpu_torch.core.rays import make_rays
    from shacira_tpu_torch.ops import hashgrid, scatter
    args = _nerf_args(v8_argv(dev))
    ocfg = occ.OccupancyGridConfig(args.blas_level)
    I, S = args.max_intersections, args.num_steps
    rays = v8_rays(data, dev)
    seeded = occ.occupancy_from_points(ocfg, data.pointcloud, dev)
    log(f'  seeded occupancy: {float(seeded["occ"].float().mean()):.5f} '
        f'of {ocfg.num_cells} cells from {data.pointcloud.shape[0]} points')
    v1 = dict(source='shacira_tpu_torch/csrc/voxel_dda.cu',
              replaces='none: shacira_tpu/accel/occupancy.py:229 (lax.scan, '
                       'no Pallas counterpart)')
    rows = {'voxel_dda': dict(check_dda(
        'voxel_dda (V1), seeded occupancy', seeded, ocfg, rays, I), **v1,
        use='voxel march DDA (flat and paged step, probe), '
            'shacira_tpu/accel/occupancy.py:176')}
    rows['voxel_dda_all_occupied'] = dict(check_dda(
        'voxel_dda (V1), every cell occupied', occ.occupancy_init(ocfg, dev),
        ocfg, rays, I), **v1, use='voxel march DDA before the first prune '
                                  '(every cell occupied, slots overflow)')
    edge = [dda_edge_rays(kind, 512, ocfg.res, seed=i)
            for i, kind in enumerate(DDA_EDGE_KINDS)]
    edge_rays = make_rays(*(torch.as_tensor(np.concatenate(v), device=dev)
                            for v in zip(*edge)))
    rows['voxel_dda_edge_rays'] = dict(check_dda(
        'voxel_dda (V1), seeded occupancy, rays on cell faces, edges and '
        'corners, stalling and with empty box intervals', seeded, ocfg,
        edge_rays, I), **v1, use='the walk off its common path: '
                                 f'{", ".join(DDA_EDGE_KINDS)} rays')
    b1 = dict(source='shacira_tpu_torch/csrc/scatter.cu',
              replaces='shacira_tpu/ops/pallas_scatter.py:29')
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    m = occ.raymarch_voxel(seeded, ocfg, rays, S, gen, I)
    spec = cfg_mod.build_grid_config(args).spec
    gidx, _ = hashgrid._all_corners(m['samples'].reshape(-1, 3), spec)
    vals = torch.randn(gidx.shape + (args.latent_dim,), generator=gen,
                       device=dev)
    vals.mul_(m['mask'].reshape(1, -1, 1, 1))     # masked samples: zero
    log(f'  V8 flat step: {int(m["mask"].sum())} of {m["mask"].numel()} '
        f'samples live')
    del m
    rows['scatter_add_v8'] = dict(check_scatter(
        'scatter_add V8 flat backward, 20 LODs, width 2',
        gidx.reshape(-1), vals.reshape(-1, args.latent_dim),
        spec.total_size, scatter.scatter_add, scatter.scatter_add_plain,
        reps=5), **b1, use='flat V8 hash backward (dense voxel '
                           'integration), shacira_tpu/ops/hashgrid.py:471')
    del gidx, vals
    torch.cuda.empty_cache()
    vargs = _nerf_args(v8_argv(dev, '', '', *VOXEL_FLAGS))
    k, rays_n = vargs.max_samples, vargs.num_rays_sampled_per_img
    valid_rows = int(0.8 * k)
    ids = torch.sort(torch.randint(0, rays_n, (valid_rows,), generator=gen,
                                   device=dev)).values
    ids = torch.cat([ids, torch.zeros((k - valid_rows,), dtype=ids.dtype,
                                      device=dev)]).to(torch.int32)
    payload = torch.randn((k, 5), generator=gen, device=dev)
    payload[valid_rows:] = 0.0
    rows['segment_sum_voxel'] = dict(check_scatter(
        'segment_sum, paged voxel step', ids, payload, rays_n,
        lambda i, v, t: scatter.segment_sum(i, v, t),
        scatter.scatter_add_plain, reps=50), **b1,
        use='per-ray sums of the paged voxel step, '
            'shacira_tpu/tracers/rf_tracer.py:325')
    inp = paged_inputs(dev, vargs, voxel=True)
    slots = (inp['coords_s'], inp['slot_valid'], inp['block_cell'])
    b23 = dict(source='shacira_tpu_torch/csrc/paged_hash.cu')
    rows['paged_gather_voxel'] = dict(check_paged_gather(
        'paged_gather (B2) voxel, ld 2', *slots, inp['z'], inp['static'],
        reps=20), **b23, replaces='shacira_tpu/ops/paged_hash.py:720',
        use='paged voxel encode forward, ld 2, '
            'shacira_tpu/ops/paged_hash.py:1163')
    rows['paged_scatter_voxel'] = dict(check_paged_scatter(
        'paged_scatter (B3) voxel, ld 2', *slots, inp['g'], inp['static'],
        reps=20), **b23, replaces='shacira_tpu/ops/paged_hash.py:786',
        use='paged voxel encode backward, ld 2, '
            'shacira_tpu/ops/paged_hash.py:1236')
    return rows


def _sphere_occupancy(level, radius=0.55, density=40.0):
    """(occ, density) numpy grids of a sphere of occupied cells."""
    res = 2 ** level
    g = np.linspace(-1, 1, res, endpoint=False) + 1.0 / res
    xx, yy, zz = np.meshgrid(g, g, g, indexing='ij')
    inside = (xx ** 2 + yy ** 2 + zz ** 2) < radius ** 2
    return inside, inside.astype(np.float32) * density


def phase_v8(dev, scene, tmp, data):
    """``apps/train_nerf.main`` with configs/nerf_V8.yaml unchanged (flat
    layout, 'voxel' march, dense integration of 4096 x 64 x 16 samples a
    step) on the generated RTMV scene (40 views of 256^2 read at mip 2;
    ``V8_FLAGS``: 4 epochs of 26 views, 104 steps across the prune at 100),
    then ``--resume true --valid-only``, whose PSNR must equal the trained
    run's to 1e-4 dB.  LPIPS on random weights.  The occupancy at the
    start of training must be the point cloud's seed.  Counts zeroed before
    the training run and read after it: B1(a) and V1 must have launched.
    Then the step timed and profiled outside the app, before the prune."""
    import logging

    import torch
    from shacira_tpu_torch.accel import occupancy as occ
    from shacira_tpu_torch.apps import train_nerf
    from shacira_tpu_torch.apps.train_nerf import build_trainer
    from shacira_tpu_torch.ops import lpips as lpips_mod
    from shacira_tpu_torch.trainers.multiview_trainer import MultiviewTrainer
    argv = v8_argv(dev, scene, os.path.join(tmp, 'runs')) + V8_FLAGS
    args = _nerf_args(argv)
    n_steps = args.epochs * data.num_views
    want_prunes = list(range(args.prune_every, n_steps + 1,
                             args.prune_every))
    ocfg = occ.OccupancyGridConfig(args.blas_level)
    seed = occ.occupancy_from_points(ocfg, data.pointcloud, dev)['occ']

    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger('shacira_tpu_torch')
    logger.addHandler(handler)
    env = os.environ.get(lpips_mod.ENV_VAR)
    weights = os.path.join(tmp, 'lpips_random.npz')
    np.savez(weights, **lpips_mod.random_weights(0))
    os.environ[lpips_mod.ENV_VAR] = weights
    # the trainer's train() and prune() wrapped: the occupancy training
    # starts from and its time; the occupancy after each prune
    starts, prunes = [], []
    fn_train, fn_prune = MultiviewTrainer.train, MultiviewTrainer.prune

    def train(self, *a, **k):
        starts.append({'seeded': bool(torch.equal(self.occ_state['occ'],
                                                  seed)),
                       'iteration': self.iteration})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn_train(self, *a, **k)
        torch.cuda.synchronize()
        starts[-1]['seconds'] = time.perf_counter() - t0
        return out

    def prune(self, *a, **k):
        fn_prune(self, *a, **k)
        prunes.append({
            'iteration': self.iteration,
            'occupancy': float(self.occ_state['occ'].float().mean()),
            'density_max': float(self.occ_state['density'].max())})

    MultiviewTrainer.train, MultiviewTrainer.prune = train, prune
    exp = os.path.join(tmp, 'runs', 'v8')
    try:
        metrics, logs, walls = {}, {}, {}
        for name, extra in (('train', []),
                            ('valid-only', ['--resume', 'true',
                                            '--valid-only'])):
            del lines[:]
            if name == 'train':
                _reset_launches()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if train_nerf.main(argv + extra) != 0:
                raise AssertionError(f'v8 app run {name} failed')
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            if name == 'train':
                launches = _launch_counts()
                app_peak_gb = torch.cuda.max_memory_allocated() / 1e9
            with open(os.path.join(exp, 'metrics.json')) as f:
                metrics[name] = json.load(f)
            logs[name] = list(lines)
    finally:
        MultiviewTrainer.train, MultiviewTrainer.prune = fn_train, fn_prune
        logger.removeHandler(handler)
        if env is None:
            os.environ.pop(lpips_mod.ENV_VAR, None)
        else:
            os.environ[lpips_mod.ENV_VAR] = env
    m = metrics['train']
    steps = [ln for ln in logs['train'] if ln.startswith('iteration ')]
    result = {'wall_s': walls, 'train_seconds': starts[0]['seconds'],
              'mean_step_ms_in_app': starts[0]['seconds'] / n_steps * 1e3,
              'seeded_from_point_cloud': starts[0]['seeded'],
              'prunes': prunes, 'app_peak_mem_gb': app_peak_gb,
              'metrics': m, 'valid_only_psnr': metrics['valid-only']['psnr'],
              'launches': launches, 'training_log': steps}
    log('  v8: ' + json.dumps(result))
    for name, mm in metrics.items():
        if not all(math.isfinite(mm[k]) for k in ('psnr', 'ssim', 'lpips',
                                                   'total_size_kb')):
            raise AssertionError(f'v8 {name}: non-finite metrics {mm}')
    if not starts[0]['seeded']:
        raise AssertionError('v8: training did not start from the point '
                             'cloud\'s occupancy')
    if not want_prunes or [p['iteration'] for p in prunes] != want_prunes \
            or not any(ln.startswith(f'iteration {n_steps} ')
                       for ln in steps):
        raise AssertionError(f'v8: not {n_steps} steps across the prunes at '
                             f'{want_prunes}: {prunes}, {steps}')
    if ('valid-only: loaded model_best.ckpt' not in logs['valid-only']
            or any(ln.startswith('iteration ') for ln in logs['valid-only'])):
        raise AssertionError('v8 --valid-only did not reload without '
                             'training')
    diff = abs(metrics['valid-only']['psnr'] - m['psnr'])
    log(f'  v8 --valid-only PSNR - trained PSNR: {diff:.3e} dB')
    if not diff <= 1e-4:
        raise AssertionError('v8 --valid-only did not reproduce the PSNR')
    for f in ('metrics.json', 'model_best.ckpt', 'resume_state.ckpt',
              'val_view0.png', 'turntable.gif'):
        if not os.path.exists(os.path.join(exp, f)):
            raise AssertionError(f'the v8 app wrote no {f}')
    if launches['scatter_add'] < n_steps or \
            launches['voxel_crossings'] < n_steps:
        raise AssertionError(f'v8: B1(a) or V1 not launched every step: '
                             f'{launches}')
    # the step outside the app: timed, then profiled, before the prune
    fresh = build_trainer(args, data)
    fresh.train(num_iterations=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fresh.train(num_iterations=10)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f'  v8 step: {step_ms:.3f} ms ('
        f'{args.num_rays_sampled_per_img / step_ms * 1e3:.1f} rays/s), peak '
        f'{peak:.3f} GB')
    phase_profile(fresh, 3, 'v8, before the first prune', step_ms)
    return launches


def phase_voxel(dev, tmp):
    """``bench_nerf.measure_voxel``'s setting (``VOXEL_FLAGS`` on
    configs/nerf_V8.yaml: V8's grid on the paged layout, 262,144-sample and
    16,384-crossing budgets, term_tau 11.5, adaptive budgets from 8192,
    chunks of 50) through the port's config reader and ``build_trainer``,
    on ``bench_nerf.lego_like_scene``'s scene
    (``write_nerf_scene(views=40, val_views=1, res=128)``): two prunes,
    the budgets, the occupancy and the probed live crossings per ray logged
    after each; 3 steps profiled after the second; one view evaluated.
    Counts zeroed before and read after training: B1(b), B2, B3 and V1 every
    step, B2 and V1 (the probe) in the prune step; the budgets on the
    ladder at or below base."""
    import torch
    from shacira_tpu_torch.apps.train_nerf import build_trainer
    from shacira_tpu_torch.datasets.nerf_synthetic import load_nerf_synthetic
    from tools.make_synthetic_data import write_nerf_scene
    scene = os.path.join(tmp, 'lego_like')
    t0 = time.perf_counter()
    write_nerf_scene(scene, views=40, val_views=1, res=128)
    data = load_nerf_synthetic(scene, split='train')
    log(f'  scene: 40 + 1 views of 128 x 128 in '
        f'{time.perf_counter() - t0:.1f} s')
    args = _nerf_args(v8_argv(dev, scene, tmp, *VOXEL_FLAGS))
    trainer = build_trainer(args, data)
    base = trainer.tracer_cfg
    if not (trainer.use_paged and trainer.voxel and base.term_tau == 11.5
            and base.max_samples == args.max_samples
            and base.eval_seg_budget == args.eval_seg_budget
            and trainer.cfg.adaptive_budget and trainer.model_cfg.amp):
        raise AssertionError(f'the voxel trainer took the wrong path: {base}')
    probes = []
    fn_probe = trainer._live_cell_hits_per_ray

    def probe(*a, **k):
        probes.append(fn_probe(*a, **k))
        return probes[-1]

    trainer._live_cell_hits_per_ray = probe
    entries, prunes = [], []

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(num_iterations=n, log_fn=lambda e: entries.append(e)
                      if 'iteration' in e else None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    fields = ('max_samples', 'eval_seg_budget')

    def after_prune():
        act = trainer.active_tracer_cfg
        rec = {'iteration': trainer.iteration,
               'occupancy': entries[-1]['occupancy'],
               'live_crossings_per_ray': probes[-1],
               **{f: getattr(act, f) for f in fields}}
        prunes.append(rec)
        log('  after prune: ' + json.dumps(rec))
        if not all(_on_ladder(getattr(act, f))
                   and getattr(act, f) <= getattr(base, f) for f in fields):
            raise AssertionError(f'budgets off the ladder or above base: '
                                 f'{rec}')

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    first_s = timed(1)
    block_s = timed(args.prune_every - 2)
    before_prune = _launch_counts()
    prune_s = timed(1)
    in_prune_step = _delta(_launch_counts(), before_prune)
    after_prune()
    between_s = timed(args.prune_every)
    after_prune()
    trained = trainer.iteration
    launches = _launch_counts()
    prof = phase_profile(trainer, 3, 'voxel, after the second prune',
                         between_s * 1e3)
    n_after = VOXEL_STEPS - trainer.iteration
    after_s = timed(n_after)
    prof['unprofiled_step_ms'] = after_s * 1e3
    prof['device_idle_share'] = 1.0 - prof['device_busy_ms_per_step'] / (
        after_s * 1e3)
    log(f'  voxel profile against steps {trainer.iteration - n_after + 1}-'
        f'{trainer.iteration} ({after_s * 1e3:.3f} ms a step): device idle '
        f'share {prof["device_idle_share"]:.4f}')
    before_eval = _launch_counts()
    metrics = trainer.evaluate(view_indices=[0])
    torch.cuda.synchronize()
    in_eval = _delta(_launch_counts(), before_eval)
    result = {
        'layout': 'paged', 'setting': 'measure_voxel',
        'steps': trainer.iteration, 'first_step_ms': first_s * 1e3,
        'mean_step_ms': block_s * 1e3,
        'mean_step_ms_of_steps': [2, args.prune_every - 1],
        'prune_step_ms': prune_s * 1e3,
        'mean_step_ms_between_prunes': between_s * 1e3,
        'mean_step_ms_adapted': after_s * 1e3,
        'rays_per_s': args.num_rays_sampled_per_img / block_s,
        'rays_per_s_adapted': args.num_rays_sampled_per_img / after_s,
        'loss_first': entries[0]['loss'], 'loss_last': entries[-1]['loss'],
        'psnr_first': entries[0]['psnr'], 'psnr_last': entries[-1]['psnr'],
        'prunes': prunes, 'eval_psnr_view0': metrics['psnr'],
        'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
        'launches': launches, 'launches_in_prune_step': in_prune_step,
        'launches_in_eval': in_eval}
    log('  voxel: ' + json.dumps(result))
    if not all(math.isfinite(e['loss']) for e in entries):
        raise AssertionError('non-finite training loss')
    if not math.isfinite(metrics['psnr']):
        raise AssertionError('non-finite evaluation PSNR')
    for wrapper in ('segment_sum', 'paged_gather', 'paged_scatter',
                    'voxel_crossings'):
        if launches[wrapper] < trained:
            raise AssertionError(f'{wrapper} did not launch every step: '
                                 f'{launches}')
    # the step's B2 and the prune's; the step's V1 and the probe's
    if in_prune_step['paged_gather'] != 2 or \
            in_prune_step['voxel_crossings'] != 2:
        raise AssertionError(f'the prune step: {in_prune_step}')
    if in_eval['paged_gather'] < 1 or in_eval['voxel_crossings'] < 1:
        raise AssertionError(f'eval did not go through B2 and V1: {in_eval}')
    return launches


# ---------------------------------------------------------------------------
# The alternative backbones: NGLOD, VQAD, triplanar, the uncompressed HashGrid
# ---------------------------------------------------------------------------

BACKBONE_SCENE = dict(views=40, val_views=1, res=128)
# 4 epochs of 26 views: 104 steps across the prune at 100.  The octree,
# codebook and triplanar YAMLs inherit prune_every -1 from nerf_base.yaml,
# so the prune cadence of nerf_hash.yaml (100) is given to all four.
BACKBONE_FLAGS = ['--epochs', '4', '--max-views', '26', '--prune-every',
                  '100']
# (path name, YAML, extra flags): the triplanar YAML's 'voxel' march of
# 4096 x 64 x 512 samples runs through the trainer's compaction at lego's
# budget, its one cut
BACKBONE_RUNS = (('octree', 'nerf_octree.yaml', []),
                 ('codebook', 'nerf_codebook.yaml', []),
                 ('triplanar', 'nerf_triplanar.yaml',
                  ['--max-samples', '1048576']),
                 ('hash', 'nerf_hash.yaml', []))
BACKBONE_TIMED_STEPS = 5


def backbone_argv(dev, config, scene, log_dir, name, *extra):
    return ['--config', os.path.join(ROOT, 'configs', config), '--device',
            str(dev), '--dataset-path', scene, '--log-dir', log_dir,
            '--exp-name', name, *BACKBONE_FLAGS, *extra]


def structures_built_once(seconds):
    """``OctreeStructure.make_dense`` wrapped so that each dense structure
    is built once (its build seconds kept in ``seconds``) and handed to
    every later trainer, and ``from_pointcloud`` timed; returns the
    function that puts both back."""
    import torch
    from shacira_tpu_torch.models.grids import octree_grid as og
    cls = og.OctreeStructure
    dense, points = cls.make_dense, cls.from_pointcloud
    cache = {}

    def timed(key, build):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build()
        torch.cuda.synchronize()
        seconds.setdefault(key, []).append(time.perf_counter() - t0)
        return out

    def make_dense(cfg, device='cpu'):
        key = f'dense LODs {cfg.active_lods}'
        if key not in cache:
            cache[key] = timed(key, lambda: dense(cfg, device=device))
        return cache[key]

    def from_pointcloud(cfg, pts, dilate=2, device=None):
        return timed(f'point cloud LODs {cfg.active_lods}',
                     lambda: points(cfg, pts, dilate=dilate, device=device))

    cls.make_dense = staticmethod(make_dense)
    cls.from_pointcloud = staticmethod(from_pointcloud)

    def restore():
        cls.make_dense = classmethod(dense.__func__)
        cls.from_pointcloud = classmethod(points.__func__)
    return restore


def backbone_scatter_inputs(dev):
    """B1's inputs at the backbone steps' shapes, name -> (idx int32 [N],
    vals [N, F] f32, table rows, use), on samples along rays in (ray,
    depth) order (``ray_ordered_points``), samples outside the march's
    mask with zero gradients, the rows of every LOD (plane) offset into one
    row space in the order ``gather_rows`` concatenates them:

    * ``scatter_add_octree``: NGLOD's corner features, the dense 'ray'
      march of 4096 x 1024 samples, 4 LODs x 8 corners, F = 5, into the
      19,431,844 corners of the dense octree of LODs 5-8;
    * ``scatter_add_codebook``: VQAD's corner logits, the same rows at
      F = 16;
    * ``scatter_add_triplanar``: the triplanar texels of the 1,048,576
      compacted samples, 4 LODs x 3 planes x 4 texels, F = 4, into 264,012
      rows;
    * ``scatter_add_hash``: the HashGrid backward (B1(a)) of the dense
      march, 16 LODs x 8 corners, F = 2, into its 6,098,925-row table."""
    import torch
    from shacira_tpu_torch.models.grids import octree_grid as og
    from shacira_tpu_torch.models.grids import triplanar_grid as tg
    from shacira_tpu_torch.ops import hashgrid
    from shacira_tpu_torch.ops.hashgrid import (
        HashGridSpec, geometric_resolutions)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}
    n_dense = 4096 * 1024
    pts, valid = ray_ordered_points(dev, gen, n_rays=4096, steps=1024,
                                    budget=n_dense)
    cfg = og.OctreeGridConfig(feature_dim=5, base_lod=5, num_lods=4)
    st = og.OctreeStructure.make_dense(cfg, device=dev)
    idx, rows = [], 0
    for lod, (ci, _, _) in zip(cfg.active_lods, og._corners(cfg, st, pts)):
        idx.append(ci.reshape(-1).long() + rows)
        rows += st.num_corners[lod]
    idx = torch.cat(idx).to(torch.int32)
    mask = valid[None, :, None].expand(cfg.num_lods, n_dense, 8).reshape(-1)
    use = ('backward of the gather {} (JAX: the XLA scatter of jnp.take\'s '
           'transpose), shacira_tpu/models/grids/octree_grid.py:{}')
    for name, f, what, line in (
            ('scatter_add_octree', 5, 'of NGLOD\'s corner features', 152),
            ('scatter_add_codebook', 16, 'of VQAD\'s corner logits', 196)):
        vals = torch.randn((idx.shape[0], f), generator=gen, device=dev)
        out[name] = (idx, vals * mask[:, None], rows, use.format(what, line))
        del vals
    del idx, mask
    spec = HashGridSpec(geometric_resolutions(16, 2048, 16), 19, 3)
    gidx, _ = hashgrid._all_corners(pts, spec)
    vals = torch.randn(gidx.shape + (2,), generator=gen, device=dev)
    vals = vals * valid[None, :, None, None]
    out['scatter_add_hash'] = (
        gidx.reshape(-1), vals.reshape(-1, 2), spec.total_size,
        'HashGrid (Instant-NGP) backward of configs/nerf_hash.yaml, '
        'shacira_tpu/ops/hashgrid.py:471')
    del pts, valid, gidx, vals
    pts, valid = ray_ordered_points(dev, gen, n_rays=4096, steps=256,
                                    budget=1 << 20)
    tcfg = tg.TriplanarGridConfig(feature_dim=4, base_lod=5, num_lods=4)
    idx, rows = [], 0
    for lod in tcfg.active_lods:
        s = 2 ** lod + 1
        for _, axes in tg.PLANES:
            r, _, _ = tg._plane_texels(s, pts[:, list(axes)])
            idx.append(r.reshape(-1) + rows)
            rows += s * s
    idx = torch.cat(idx).to(torch.int32)
    vals = torch.randn((idx.shape[0], 4), generator=gen, device=dev)
    mask = valid[:, None].expand(-1, 4).reshape(-1).repeat(12)
    out['scatter_add_triplanar'] = (
        idx, vals * mask[:, None], rows,
        'backward of the gather of the triplanar texels (JAX: the XLA '
        'scatter of the plane indexing), '
        'shacira_tpu/models/grids/triplanar_grid.py:61')
    return out


def phase_backbone_kernels(dev):
    """B1 at the backbone shapes (``backbone_scatter_inputs``) against its
    plain version and index_add_, timed, with its bound and merge
    counts."""
    import torch
    from shacira_tpu_torch.ops import scatter
    rows = {}
    inputs = backbone_scatter_inputs(dev)
    for name in list(inputs):
        idx, vals, table_rows, use = inputs.pop(name)
        rows[name] = check_scatter(name, idx, vals, table_rows,
                                   scatter.scatter_add,
                                   scatter.scatter_add_plain, reps=3)
        rows[name].update(use=use, source='shacira_tpu_torch/csrc/scatter.cu',
                          replaces='shacira_tpu/ops/pallas_scatter.py:29')
        del idx, vals
        torch.cuda.empty_cache()
    return rows


def _drive_backbone(dev, name, argv, data, n_steps):
    """The app's ``main`` on ``argv`` (training across the prunes), then
    ``--resume true --valid-only``, whose PSNR must equal the trained
    run's to 1e-4 dB; counts zeroed before training and read after it; the
    step timed and profiled outside the app on a fresh trainer.  Returns
    (result, launches)."""
    import logging

    import torch
    from shacira_tpu_torch.apps import train_nerf
    from shacira_tpu_torch.apps.train_nerf import build_trainer
    from shacira_tpu_torch.trainers.multiview_trainer import MultiviewTrainer
    args = _nerf_args(argv)
    want_prunes = list(range(args.prune_every, n_steps + 1,
                             args.prune_every))
    lines, starts, prunes = [], [], []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger('shacira_tpu_torch')
    logger.addHandler(handler)
    fn_train, fn_prune = MultiviewTrainer.train, MultiviewTrainer.prune

    def train(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn_train(self, *a, **k)
        torch.cuda.synchronize()
        starts.append(time.perf_counter() - t0)
        return out

    def prune(self, *a, **k):
        fn_prune(self, *a, **k)
        prunes.append({'iteration': self.iteration, 'occupancy': float(
            self.occ_state['occ'].float().mean())})

    MultiviewTrainer.train, MultiviewTrainer.prune = train, prune
    exp = os.path.join(args.log_dir, name)
    try:
        metrics, logs, walls = {}, {}, {}
        for run, extra in (('train', []),
                           ('valid-only', ['--resume', 'true',
                                           '--valid-only'])):
            del lines[:]
            if run == 'train':
                _reset_launches()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if train_nerf.main(argv + extra) != 0:
                raise AssertionError(f'{name} app run {run} failed')
            torch.cuda.synchronize()
            walls[run] = time.perf_counter() - t0
            if run == 'train':
                launches = _launch_counts()
                app_peak_gb = torch.cuda.max_memory_allocated() / 1e9
            with open(os.path.join(exp, 'metrics.json')) as f:
                metrics[run] = json.load(f)
            logs[run] = list(lines)
    finally:
        MultiviewTrainer.train, MultiviewTrainer.prune = fn_train, fn_prune
        logger.removeHandler(handler)
    m = metrics['train']
    steps = [ln for ln in logs['train'] if ln.startswith('iteration ')]
    size = {k: v for k, v in m.items() if k.endswith('_kb') or k == 'stream'}
    for run, mm in metrics.items():
        if not all(math.isfinite(mm[k]) for k in ('psnr', 'ssim',
                                                   'total_size_kb')):
            raise AssertionError(f'{name} {run}: non-finite metrics {mm}')
    if [p['iteration'] for p in prunes] != want_prunes or not any(
            ln.startswith(f'iteration {n_steps} ') for ln in steps):
        raise AssertionError(f'{name}: not {n_steps} steps across the '
                             f'prunes at {want_prunes}: {prunes}, {steps}')
    if ('valid-only: loaded model_best.ckpt' not in logs['valid-only']
            or any(ln.startswith('iteration ') for ln in logs['valid-only'])):
        raise AssertionError(f'{name} --valid-only did not reload without '
                             'training')
    diff = abs(metrics['valid-only']['psnr'] - m['psnr'])
    for f in ('metrics.json', 'model_best.ckpt', 'resume_state.ckpt',
              'val_view0.png', 'turntable.gif'):
        if not os.path.exists(os.path.join(exp, f)):
            raise AssertionError(f'the {name} app wrote no {f}')
    fresh = build_trainer(args, data)
    fresh.train(num_iterations=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.train(num_iterations=BACKBONE_TIMED_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / BACKBONE_TIMED_STEPS * 1e3
    prof = phase_profile(fresh, 3, f'{name}, before the first prune',
                         step_ms)
    result = {'path': name, 'wall_s': walls, 'train_seconds': starts[0],
              'mean_step_ms_in_app': starts[0] / n_steps * 1e3,
              'step_ms': step_ms,
              'device_busy_ms_per_step': prof['device_busy_ms_per_step'],
              'device_idle_share': prof['device_idle_share'],
              'stream_syncs_per_step': prof['stream_syncs_per_step'],
              'app_peak_mem_gb': app_peak_gb, 'prunes': prunes,
              'psnr': m['psnr'], 'ssim': m['ssim'],
              'valid_only_psnr': metrics['valid-only']['psnr'],
              'size_report': size, 'launches': launches,
              'training_log': steps}
    log(f'  {name}: ' + json.dumps(result))
    log(f'  {name} --valid-only PSNR - trained PSNR: {diff:.3e} dB')
    if not diff <= 1e-4:
        raise AssertionError(f'{name} --valid-only did not reproduce the '
                             'PSNR')
    if launches['scatter_add'] < n_steps:
        raise AssertionError(f'{name}: B1 not launched every step: '
                             f'{launches}')
    del fresh
    torch.cuda.empty_cache()
    return result, launches


def phase_backbones(dev, rows) -> dict:
    """B1 at the backbone shapes (its rows added to ``rows``), then
    ``apps/train_nerf.main`` with each of ``BACKBONE_RUNS`` at the YAML's
    full width on the Blender-format scene of
    ``tools/make_synthetic_data.write_nerf_scene(**BACKBONE_SCENE)``; the
    dense octree of LODs 5-8 built once for NGLOD and VQAD.  Returns the
    launches of each path."""
    import tempfile

    import torch
    from shacira_tpu_torch.datasets.nerf_synthetic import load_nerf_synthetic
    from tools.make_synthetic_data import write_nerf_scene
    seconds = {}
    restore = structures_built_once(seconds)
    launches = {}
    try:
        rows.update(phase_backbone_kernels(dev))
        log(f'  structure builds (s): {json.dumps(seconds)}')
        with tempfile.TemporaryDirectory() as tmp:
            scene = os.path.join(tmp, 'scene')
            write_nerf_scene(scene, **BACKBONE_SCENE)
            for name, config, extra in BACKBONE_RUNS:
                argv = backbone_argv(dev, config, scene,
                                     os.path.join(tmp, 'runs'), name, *extra)
                args = _nerf_args(argv)
                data = load_nerf_synthetic(scene, split='train',
                                           mip=args.mip,
                                           max_views=args.max_views)
                log(f'phase backbones, {name} ({config}):')
                _, launches[name] = _drive_backbone(
                    dev, name, argv, data, args.epochs * data.num_views)
                torch.cuda.empty_cache()
    finally:
        restore()
    log(f'  structure builds (s): {json.dumps(seconds)}')
    return launches


def phase_octree_rtmv(dev, scene, tmp, data):
    """NGLOD (configs/nerf_octree.yaml) through the app on the generated
    RTMV scene: the octree built from the scene's depth point cloud (2
    cells of dilation), so the sparse structure and its queries outside it
    (-1, zero features) run on the card; as ``_drive_backbone``."""
    seconds = {}
    restore = structures_built_once(seconds)
    try:
        argv = backbone_argv(dev, 'nerf_octree.yaml', scene,
                             os.path.join(tmp, 'runs'), 'octree_rtmv',
                             '--multiview-dataset-format', 'rtmv')
        args = _nerf_args(argv)
        result, launches = _drive_backbone(
            dev, 'octree_rtmv', argv, data, args.epochs * data.num_views)
    finally:
        restore()
    log(f'  structure builds (s): {json.dumps(seconds)}')
    return launches


SDF_ITERS = 2000           # tools/run_sdf_demo.py's default
SDF_RENDER = (256, 256)
SDF_IOU_FLOOR = 90.0       # tests/test_sdf.py's convergence bar
SDF_SHADINGS = ('normal', 'shadow', 'matcap')


def sdf_scatter_input(dev, ds):
    """B1's input on the SDF path: the table-gradient scatter of one real
    step of the demo's config on a batch of its pool (4096 points x 5 LODs
    x 8 corners, F = 4, into the 15,761-row table), recorded where the
    hash encode's backward calls it."""
    from shacira_tpu_torch.apps import sdf_demo
    from shacira_tpu_torch.ops import hashgrid
    calls = []
    launch = hashgrid.scatter_add

    def recording(idx, vals, table_size):
        calls.append((idx.detach().clone(), vals.detach().clone(),
                      table_size))
        return launch(idx, vals, table_size)

    hashgrid.scatter_add = recording
    try:
        tr = sdf_demo.build_trainer(ds, device=dev)
        coords, sdfs = tr.draw_chunk(1)
        tr.step(coords[0], sdfs[0], tr.lod_masks(tr.loss_lods))
    finally:
        hashgrid.scatter_add = launch
    (idx, vals, rows), = calls
    return idx, vals, rows


def phase_sdf(dev, rows) -> dict:
    """The SDF demo (``shacira_tpu_torch.apps.sdf_demo``, the counterpart
    of ``tools/run_sdf_demo.py``) at its full width on the card: B1 on a
    real step's backward against its plain version and index_add_ (its row
    added to ``rows``); ``SDF_ITERS`` steps from the demo's functions, the
    IoU over 8 batches (at least ``SDF_IOU_FLOOR``), the three shadings at
    ``SDF_RENDER`` (finite; the normal render hits at the centre and not
    at the corner); counts zeroed before training and read after the
    renders; then 3 steps profiled.  Returns the path's launches."""
    import torch
    from shacira_tpu_torch.apps import sdf_demo
    from shacira_tpu_torch.ops import scatter
    t0 = time.perf_counter()
    ds = sdf_demo.build_dataset()
    log(f'  dataset: {ds.pool_size} points in '
        f'{time.perf_counter() - t0:.2f} s')
    idx, vals, table_rows = sdf_scatter_input(dev, ds)
    row = check_scatter('scatter_add_sdf', idx, vals, table_rows,
                        scatter.scatter_add, scatter.scatter_add_plain,
                        reps=20)
    row.update(use='NeuralSDF hash backward of the SDF demo (4096 points, '
                   '5 LODs, F = 4)',
               source='shacira_tpu_torch/csrc/scatter.cu',
               replaces='shacira_tpu/ops/pallas_scatter.py:29')
    rows['scatter_add_sdf'] = row
    del idx, vals
    trainer = sdf_demo.build_trainer(ds, device=dev)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    trainer.train(num_iterations=SDF_ITERS, log_fn=losses.append)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    iou = trainer.validate(num_batches=8)['iou']
    tex = np.broadcast_to(np.asarray([0.2, 0.6, 0.9], np.float32),
                          (8, 8, 3)).copy()
    render_s, images = {}, {}
    for shading in SDF_SHADINGS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images[shading] = trainer.render(res=SDF_RENDER, shading=shading,
                                         matcap=tex)
        render_s[shading] = time.perf_counter() - t0
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = train_s / SDF_ITERS * 1e3
    h, w = SDF_RENDER
    img = images['normal']
    result = {'path': 'sdf', 'iterations': trainer.iteration,
              'train_seconds': train_s, 'mean_step_ms': step_ms,
              'iou': iou, 'peak_mem_gb': peak_gb,
              'render_seconds': render_s,
              'l2_loss_by_chunk': [e['l2_loss'] for e in losses[::5]]
              + [losses[-1]['l2_loss']],
              'launches': launches}
    log('  sdf: ' + json.dumps(result))
    for shading, im in images.items():
        if im.shape != (h, w, 3) or not np.isfinite(im).all():
            raise AssertionError(f'sdf {shading} render: shape {im.shape}, '
                                 f'finite {np.isfinite(im).all()}')
    if not (img[h // 2, w // 2].sum() > 0 and img[0, 0].sum() == 0):
        raise AssertionError('sdf normal render: the centre misses or the '
                             f'corner hits ({img[h // 2, w // 2]}, '
                             f'{img[0, 0]})')
    if not iou >= SDF_IOU_FLOOR:
        raise AssertionError(f'sdf: IoU {iou:.2f} after {SDF_ITERS} steps '
                             f'< {SDF_IOU_FLOOR}')
    if launches['scatter_add'] < SDF_ITERS:
        raise AssertionError(f'sdf: B1 not launched every step: {launches}')
    phase_profile(trainer, 3, 'sdf', step_ms,
                  run=lambda: trainer.train(num_iterations=3))
    del trainer
    torch.cuda.empty_cache()
    return launches


RANGES = ('step/draws', 'step/recalib', 'step/decode', 'trace/march',
          'trace/group', 'trace/compact', 'field/encode',
          'field/paged_encode', 'field/finish', 'field/head',
          'trace/integrate', 'step/rate_loss', 'step/adam', 'step/best')
# the port's CUDA kernels by function name: launched through ctypes, they
# are no PyTorch op and the ranges' device time does not hold them (it
# falls in the remainder), so phase_profile reports them by name
PORT_KERNELS = ('scatter_add_rows_kernel', 'paged_gather_kernel',
                'paged_scatter_kernel', 'voxel_dda_kernel')


REMAINDER_FLOOR = -0.02     # backward remainder / busy time below: a fault


def _range_device_us(event, ancestors=frozenset()):
    """(counted, recounted): device time of the kernels that a stage
    range's ops launched, each op's own kernels down through its children,
    leaving out the ranges nested in it (each counts its own); and the time
    its ``device_time_total`` counts a second time.  PyTorch attaches a
    kernel to every CPU event that carries the launch's correlation id, and
    CUPTI's 'Command Buffer Full' event (the host waiting inside a launch
    for room in the launch queue, so only when the host runs far ahead of
    the card) nests in the launching op with that same id: its kernels are
    counted once, at the op."""
    own = sum(k.duration for k in event.kernels)
    counted, recounted = (0.0, own) if event.id in ancestors else (own, 0.0)
    ancestors = ancestors | {event.id}
    for ch in event.cpu_children:
        if ch.name not in RANGES:
            c, r = _range_device_us(ch, ancestors)
            counted += c
            recounted += r
    return counted, recounted


def phase_profile(trainer, steps: int, label: str, step_ms: float,
                  run=None):
    """Device time by step stage (the record_function ranges of the port)
    and by kernel over ``steps`` training steps under torch.profiler.  The
    backward runs on autograd's device thread, outside those ranges: it is
    the remainder of the device's busy time, with the port's own CUDA
    kernels (``PORT_KERNELS``, also reported by name).  Each kernel counts
    in one range at most (``_range_device_us``), so the remainder below
    ``REMAINDER_FLOOR`` of the busy time fails the run: a range that counts
    work twice, or work outside the busy sum.

    The idle share compares the device's busy time per step with the mean
    step time measured without the profiler (``step_ms``).  Host syncs
    count the stream synchronisations (each host-to-device copy from
    pageable memory makes one) and host-to-device copies per step; device
    ops count the kernels and copies the card ran per step.  ``run()``
    drives the ``steps`` steps (default: the multiview trainer's
    ``train(num_iterations=steps)``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if run is None:
            trainer.train(num_iterations=steps)
        else:
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, ranges = {}, dict.fromkeys(RANGES, 0.0)
    recounted = dict.fromkeys(RANGES, 0.0)
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
            counted, again = _range_device_us(e)
            ranges[e.name] += counted
            recounted[e.name] += again
        elif e.name == 'cudaStreamSynchronize':
            syncs += 1
    busy_ms = sum(kernels.values()) / 1e3 / steps
    per_step = {k: v / 1e3 / steps for k, v in ranges.items()}
    remainder = busy_ms - sum(per_step.values())
    per_step['backward (remainder)'] = remainder
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    port = {name: sum(v for n, v in kernels.items() if name in n)
            / 1e3 / steps for name in PORT_KERNELS}
    out = {'profile': label, 'steps': steps,
           'profiled_wall_ms_per_step': wall * 1e3 / steps,
           'unprofiled_step_ms': step_ms,
           'device_busy_ms_per_step': busy_ms,
           'device_idle_share': 1.0 - busy_ms / step_ms,
           'stream_syncs_per_step': syncs / steps,
           'htod_copies_per_step': copies / steps,
           'device_ops_per_step': device_ops / steps,
           'stage_device_ms_per_step': per_step,
           'recounted_by_device_time_total_ms_per_step': {
               k: v / 1e3 / steps for k, v in recounted.items() if v},
           'port_kernel_device_ms_per_step': port,
           'top_kernels_ms_per_step': [[n[:90], v / 1e3 / steps]
                                       for n, v in top]}
    log('  ' + json.dumps(out))
    if busy_ms <= 0.0:
        raise AssertionError('the profiler saw no device time')
    if syncs / steps > 1.0:
        raise AssertionError(f'{syncs / steps} stream syncs per step: the '
                             'step waits for the card more than once')
    if remainder < REMAINDER_FLOOR * busy_ms:
        raise AssertionError(
            f'{label}: the stage ranges hold {-remainder:.3f} ms a step more '
            f'than the device was busy ({busy_ms:.3f} ms): a range counts '
            'work twice or outside the busy sum')
    return out


def voxel_phases(dev, rows) -> dict:
    """Phases voxel_kernels, voxel_parity, v8, voxel and octree_rtmv, in a
    temporary directory holding the generated scenes; adds the kernel rows
    to ``rows`` and returns the launches of the v8, voxel and octree_rtmv
    paths."""
    import tempfile

    import torch
    from shacira_tpu_torch.datasets.rtmv import load_rtmv
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, 'rtmv')
        t0 = time.perf_counter()
        write_rtmv_scene(scene, **V8_SCENE, workers=min(8, os.cpu_count()))
        args = _nerf_args(v8_argv(dev, scene, tmp, *V8_FLAGS))
        data = load_rtmv(scene, split='train', mip=args.mip,
                         max_views=args.max_views)
        log(f'  RTMV scene: {V8_SCENE["views"]} views of {V8_SCENE["res"]}^2 '
            f'in {time.perf_counter() - t0:.1f} s; {data.num_views} train '
            f'views of {data.h} x {data.w} at mip {args.mip}, '
            f'{data.pointcloud.shape[0]} points, ray bounds '
            f'[{data.dist_min:.3f}, {data.dist_max:.3f}]')
        log('phase voxel_kernels:')
        rows.update(phase_voxel_kernels(dev, data))
        torch.cuda.empty_cache()
        log('phase voxel_parity:')
        for march in VOXEL_PARITY_MARCHES:
            phase_parity(dev, march)
        log('phase v8:')
        launches['v8'] = phase_v8(dev, scene, tmp, data)
        torch.cuda.empty_cache()
        log('phase voxel:')
        launches['voxel'] = phase_voxel(dev, tmp)
        torch.cuda.empty_cache()
        log('phase octree_rtmv:')
        launches['octree_rtmv'] = phase_octree_rtmv(dev, scene, tmp, data)
        torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--prune-every', type=int, default=None,
                    help='lower the config prune cadence (default: keep it)')
    ap.add_argument('--log', type=str, default=None,
                    help='also write every line of the output to this file')
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing to run', file=sys.stderr)
        return 1
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        LOG_FILES.append(open(args.log, 'w'))
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
    for march in PARITY_MARCHES:
        phase_parity(dev, march)
    from shacira_tpu_torch.apps.train_nerf import build_trainer
    launches = {}
    for name, paged, fine_mode in (('lego', False, None),
                                   ('paged', True, 'deferred'),
                                   ('kernel', True, 'kernel')):
        log(f'phase {name}:')
        result, launches[name], trainer, run_args, data = phase_lego(
            'cuda', args.prune_every, paged, fine_mode)
        log(f'phase {name} profile:')
        phase_profile(trainer, 3, f'{name}, after the prune',
                      result['mean_step_ms_after_prune'])
        del trainer
        fresh = build_trainer(run_args, data)
        fresh.train(num_iterations=1)
        phase_profile(fresh, 3, f'{name}, before the first prune',
                      result['mean_step_ms'])
        del fresh
        torch.cuda.empty_cache()
    log('phase sustained:')
    result, launches['sustained'], run_args = phase_sustained(
        'cuda', args.prune_every)
    torch.cuda.empty_cache()
    fresh = build_trainer(run_args, sphere_scene(num_views=24,
                                                 res=SCENE_RES))
    fresh.train(num_iterations=1)
    phase_profile(fresh, 3, 'sustained, before the first prune',
                  result['mean_step_ms'])
    del fresh
    torch.cuda.empty_cache()
    log('phase modes:')
    launches.update(phase_modes('cuda'))
    log('phase app:')
    launches['app'] = phase_app('cuda')
    torch.cuda.empty_cache()
    log('phase image_kernels:')
    rows.update(phase_image_kernels(dev))
    torch.cuda.empty_cache()
    log('phase image_parity:')
    phase_image_parity(dev)
    log('phase image:')
    launches['image'] = phase_image('cuda')
    torch.cuda.empty_cache()
    log('phase pearl:')
    launches['pearl'] = phase_pearl('cuda')
    torch.cuda.empty_cache()
    launches.update(voxel_phases(dev, rows))
    log('phase backbones:')
    launches.update(phase_backbones(dev, rows))
    log('phase sdf:')
    launches['sdf'] = phase_sdf(dev, rows)
    # each kernel's launches come from the path it serves: B1 from the flat
    # lego run, B2 and B3 from the paged one (which also runs B1(b)), B2
    # with its occupancy row from the 'kernel' run, V1 and B1(a) at V8's
    # width from the v8 run, V1 on a full grid, B1(b), B2 and B3 at ld 2
    # from the voxel run, B1 at each backbone's shapes from its own run;
    # launches_by_path adds the other runs
    # (row name, wrapper count it reports, path); the ray-ordered row times
    # the same wrapper as scatter_add on the step's sample order
    path_of = (('scatter_add', 'scatter_add', 'lego'),
               ('scatter_add_ray_ordered', 'scatter_add', 'lego'),
               ('scatter_add_one_lod', 'scatter_add', 'lego'),
               ('segment_sum', 'segment_sum', 'lego'),
               ('paged_gather', 'paged_gather', 'paged'),
               ('paged_gather_prune', 'paged_gather', 'paged'),
               ('paged_gather_occupancy', 'paged_gather_occupancy', 'kernel'),
               ('paged_scatter', 'paged_scatter', 'paged'),
               ('scatter_add_image', 'scatter_add', 'image'),
               ('scatter_add_image_shuffled', 'scatter_add', 'image'),
               ('scatter_add_pearl', 'scatter_add', 'pearl'),
               ('voxel_dda', 'voxel_crossings', 'v8'),
               ('voxel_dda_all_occupied', 'voxel_crossings', 'voxel'),
               ('voxel_dda_edge_rays', 'voxel_crossings', 'v8'),
               ('scatter_add_v8', 'scatter_add', 'v8'),
               ('segment_sum_voxel', 'segment_sum', 'voxel'),
               ('paged_gather_voxel', 'paged_gather', 'voxel'),
               ('paged_scatter_voxel', 'paged_scatter', 'voxel'),
               ('scatter_add_octree', 'scatter_add', 'octree'),
               ('scatter_add_codebook', 'scatter_add', 'codebook'),
               ('scatter_add_triplanar', 'scatter_add', 'triplanar'),
               ('scatter_add_hash', 'scatter_add', 'hash'),
               ('scatter_add_sdf', 'scatter_add', 'sdf'))
    counts = ('updates', 'atomics', 'distinct_per_tile',
              'occupancy_row_mismatches', 'valid_mismatches', 'max_ulps',
              'steps_walked', 'longest_walk', 'us_per_step', 'crossings',
              'device_ms')
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
    for path in ('paged', 'kernel', 'sustained', 'app'):
        for wrapper in ('segment_sum', 'paged_gather', 'paged_scatter'):
            if launches[path][wrapper] <= 0:
                missing.append(f'{wrapper} ({path} path)')
    for path in ('image', 'pearl'):
        if launches[path]['scatter_add'] <= 0:
            missing.append(f'scatter_add ({path} path)')
    for path, wrappers in (('v8', ('scatter_add', 'voxel_crossings')),
                           ('voxel', ('segment_sum', 'paged_gather',
                                      'paged_scatter', 'voxel_crossings'))):
        missing += [f'{w} ({path} path)' for w in wrappers
                    if launches[path][w] <= 0]
    # every backbone's feature-table gather and the SDF grid's hash encode
    # run B1 in their backward; the triplanar YAML's 'voxel' march runs V1
    for path in ('octree', 'codebook', 'triplanar', 'hash', 'octree_rtmv',
                 'sdf'):
        if launches[path]['scatter_add'] <= 0:
            missing.append(f'scatter_add ({path} path)')
    if launches['triplanar']['voxel_crossings'] <= 0:
        missing.append('voxel_crossings (triplanar path)')
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
