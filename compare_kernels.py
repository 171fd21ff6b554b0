#!/usr/bin/env python3
"""Time versions of the port's kernels against each other on the card, on
``chip_smoke.py``'s inputs at the lego and V8 steps' shapes.

    python3 compare_kernels.py [--baseline DIR] [--only b|b1|v1] [--out FILE]

Versions, each built anew with ``build.NVCC_FLAGS`` into
``build/compare/``:

* ``tree``: ``csrc/scatter.cu`` (B1) and ``csrc/paged_hash.cu`` (B2, B3)
  of this checkout;
* ``baseline`` (``--baseline DIR``): the same two files of another
  checkout, ``DIR/shacira_tpu_torch/csrc`` (both export the same C entry
  points; a baseline's B2 reads the prefix of the parameter block it
  knows);
* ``tree_no_loads`` (B2 rows only): this checkout's ``paged_hash.cu``
  built with ``-DGATHER_WITHOUT_LOADS``, B2's arithmetic without its table
  reads -- what the loads cost.  Not checked against the plain version;
* V1 (``csrc/voxel_dda.cu``): ``tree`` and ``baseline`` as above;
* ``index_add_`` (B1 rows only): the PyTorch call that computes the same
  scatter, timed in the same turns.

Inputs, each built when its row comes and freed after it: every B1 row of
``chip_smoke.py`` -- ``scatter_inputs`` (B1(a) one LOD, on random points
and on ray-ordered samples, B1(b)) and B1(b) with ``extras_payload``'s 5 +
3 columns, ``image_scatter_inputs`` (B1(c), B1(c'), B1(d)),
``backbone_scatter_inputs`` (B1(e), B1(f), B1(g), HashGrid's B1(a)),
``sdf_scatter_input`` (B1(h), a recorded step of the SDF demo),
``v8_scatter_input`` and ``voxel_segment_input`` (B1(a) at V8's width,
the paged voxel step's B1(b)); ``chip_smoke.paged_inputs`` (B2 and B3 at
train shapes, B2 also with its occupancy row of a 128^3 grid) and
``chip_smoke.prune_inputs`` (B2 at the prune's 2,097,152 rows).  On the
occupancy-row input a baseline without that row runs B2 without it.
V1's inputs: 4096 rays of a view of ``chip_smoke.write_rtmv_scene``'s
scene (``chip_smoke.v8_rays``) on the occupancy seeded from its point
cloud and on a grid with every cell occupied, res 128, I 64; every
version is first held bit for bit against the plain version on those and
on the seeded grid with ``chip_smoke.dda_edge_rays``.
Every version is launched through the port's own launch helpers, given
its library (``lib=``), and first held against the plain version on
every input (1e-5 of the largest value; the occupancy row exactly);
then the versions are timed with CUDA events, in order and in reverse (A
B B A), each turn ``REPS`` launches or enough for ``TURN_MS`` of the
first version's time, whichever is more (V1 also on the device alone,
``chip_smoke.graph_ms``: ``device_ms``).  Also counts,
from ``cuobjdump -sass`` of each version's libraries, the SASS
instructions of each kernel (B1: one for each width F) and its
``MUFU.RCP`` (one per integer division by a runtime value).  Prints the
card line and one JSON line, also written to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / 'build' / 'compare'
REPS = 10          # launches a turn, at least
TURN_MS = 20.0     # and at least this long: short kernels get more
NO_LOADS = 'tree_no_loads'
LIBRARY = 'index_add_'


def _build(baseline, only=None):
    """Compile every version's sources in parallel: ({label: {name:
    ctypes.CDLL}}, {label: {name: library path}})."""
    from shacira_tpu_torch.kernels.build import CSRC, compile_source
    trees = {'tree': CSRC}
    if baseline:
        trees['baseline'] = Path(baseline) / 'shacira_tpu_torch' / 'csrc'
    shutil.rmtree(OUT_DIR, ignore_errors=True)    # another tree's build
    names = {None: ('scatter', 'paged_hash', 'voxel_dda'),
             'b': ('scatter', 'paged_hash'), 'b1': ('scatter',),
             'v1': ('voxel_dda',)}[only]
    jobs = [(label, name, csrc / f'{name}.cu',
             OUT_DIR / label / f'lib{name}.so', ())
            for label, csrc in trees.items() for name in names
            if (csrc / f'{name}.cu').exists()]
    if 'paged_hash' in names:
        jobs.append((NO_LOADS, 'paged_hash', CSRC / 'paged_hash.cu',
                     OUT_DIR / NO_LOADS / 'libpaged_hash.so',
                     ('-DGATHER_WITHOUT_LOADS',)))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = list(pool.map(lambda j: compile_source(j[2], j[3], j[4]),
                             jobs))
    out, paths = {}, {}
    for (label, name, _, _, _), lib in zip(jobs, libs):
        out.setdefault(label, {})[name] = ctypes.CDLL(str(lib))
        paths.setdefault(label, {})[name] = lib
    return out, paths


def sass_counts(lib: Path) -> dict:
    """{kernel: {'instructions': n, 'MUFU.RCP': n}} of a library's SASS
    (a MUFU.RCP for each division by a runtime value)."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    text = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = m.group(1)
            out[name] = {'instructions': 0, 'MUFU.RCP': 0}
        elif name and re.match(r'\s+/\*[0-9a-f]{4,}\*/\s+\S', line):
            out[name]['instructions'] += 1
            out[name]['MUFU.RCP'] += 'MUFU.RCP' in line
    return out


def _v8_scene(dev):
    """(data, args): the training views of ``chip_smoke.write_rtmv_scene``'s
    v8 scene, written to a temporary directory, and the v8 flags."""
    from shacira_tpu_torch.datasets.rtmv import load_rtmv
    with tempfile.TemporaryDirectory() as tmp:
        scene = str(Path(tmp) / 'rtmv')
        cs.write_rtmv_scene(scene, **cs.V8_SCENE, workers=8)
        args = cs._nerf_args(cs.v8_argv(dev, scene, tmp, *cs.V8_FLAGS))
        data = load_rtmv(scene, split='train', mip=args.mip,
                         max_views=args.max_views)
    return data, args


def _dda_cases(dev, libs, data, args):
    """V1's cases, as :func:`_cases` gives them, on the v8 scene's ``data``;
    every version is first checked bit for bit against the plain version,
    also on the edge rays."""
    import numpy as np
    import torch
    from shacira_tpu_torch.accel import occupancy as occ
    from shacira_tpu_torch.core.rays import make_rays
    ocfg = occ.OccupancyGridConfig(args.blas_level)
    I = args.max_intersections
    rays = cs.v8_rays(data, dev)
    seeded = occ.occupancy_from_points(ocfg, data.pointcloud, dev)
    full = occ.occupancy_init(ocfg, dev)
    edge = make_rays(*(torch.as_tensor(np.concatenate(v), device=dev)
                       for v in zip(*(cs.dda_edge_rays(k, 512, ocfg.res, i)
                                      for i, k in enumerate(
                                          cs.DDA_EDGE_KINDS)))))
    versions = [k for k in libs if 'voxel_dda' in libs[k]]
    for state, r in ((seeded, rays), (full, rays), (seeded, edge)):
        want = occ.voxel_crossings_plain(state, ocfg, r, I)
        for label in versions:
            got = occ._launch_dda(state, ocfg, r, I,
                                  lib=libs[label]['voxel_dda'])
            if not all(torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f'V1 {label} differs from the plain '
                                     'version')
    return [(name, {label: (lambda st=state, lib=libs[label]['voxel_dda']:
                            occ._launch_dda(st, ocfg, rays, I, lib=lib),
                            None)
                    for label in versions})
            for name, state in (('voxel_dda_seeded', seeded),
                                ('voxel_dda_all_occupied', full))]


def _scatter_cases(dev, libs, data):
    """B1's rows, each built when the caller asks for the next one:
    (input name, {label: (launch, plain)}), ``index_add_`` among the
    labels; ``data`` is the v8 scene's training views."""
    import torch
    from shacira_tpu_torch.accel import occupancy as occ
    from shacira_tpu_torch.apps import sdf_demo
    from shacira_tpu_torch.ops import scatter
    versions = [k for k in libs if k != NO_LOADS and 'scatter' in libs[k]]

    def case(name, idx, vals, rows, *_):
        plain = (lambda: scatter.scatter_add_plain(idx, vals, rows))
        fns = {label: (lambda lib=libs[label]['scatter']:
                       scatter._launch_scatter(idx, vals, rows, lib=lib),
                       plain) for label in versions}
        idx64 = idx.long()
        fns[LIBRARY] = (lambda: torch.zeros(
            (rows, vals.shape[1]), device=vals.device).index_add_(
                0, idx64, vals), plain)
        return name, fns

    inputs = cs.scatter_inputs(dev)
    ids, payload, rays = inputs['segment_sum']
    inputs['segment_sum_extras'] = (ids, cs.extras_payload(payload), rays)
    del ids, payload
    inputs.update(cs.image_scatter_inputs(dev))
    for name in list(inputs):
        yield case(name, *inputs.pop(name))
    inputs = cs.backbone_scatter_inputs(dev)
    for name in list(inputs):
        yield case(name, *inputs.pop(name))
    yield case('scatter_add_sdf',
               *cs.sdf_scatter_input(dev, sdf_demo.build_dataset()))
    v8 = cs._nerf_args(cs.v8_argv(dev))
    seeded = occ.occupancy_from_points(
        occ.OccupancyGridConfig(v8.blas_level), data.pointcloud, dev)
    yield case('scatter_add_v8', *cs.v8_scatter_input(dev, data, seeded))
    yield case('segment_sum_voxel', *cs.voxel_segment_input(dev))


def _cases(dev, libs):
    """(input name, {label: (launch, plain)}) of B2 and B3: zero-argument
    closures; a plain of None skips the check."""
    from shacira_tpu_torch.ops import paged_hash as ph
    versions = [k for k in libs if k != NO_LOADS and 'paged_hash' in libs[k]]
    cases = []
    inp = cs.paged_inputs(dev)
    slots = ph._device_inputs(inp['coords_s'], inp['slot_valid'],
                              inp['block_cell'])
    static, z = inp['static'], inp['z']

    def gather(args, st, occ):
        launch = {}
        for label in (k for k in libs if 'paged_hash' in libs[k]):
            use_occ = occ if label != 'baseline' else None
            use_st = st if use_occ is not None else static
            launch[label] = (
                lambda lib=libs[label]['paged_hash'], st_=use_st, o=use_occ:
                ph._launch_gather(*args, z, st_, o, lib=lib),
                None if label == NO_LOADS else
                (lambda st_=use_st, o=use_occ:
                 ph.paged_gather_plain(*args, z, st_, o)))
        return launch

    prune = ph._device_inputs(*cs.prune_inputs(dev, static.group_res))
    cases += [('paged_gather', gather(slots, static, None)),
              ('paged_gather_prune', gather(prune, static, None)),
              ('paged_gather_occupancy', gather(slots, inp['static_occ'],
                                                inp['occ']))]
    plain = (lambda: ph.paged_scatter_plain(*slots, inp['g'], static))
    cases.append(('paged_scatter', {
        label: (lambda lib=libs[label]['paged_hash']: ph._launch_scatter(
            *slots, inp['g'], static, lib=lib), plain)
        for label in versions}))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--baseline', default=None,
                    help='root of another checkout to time against')
    ap.add_argument('--only', choices=('b', 'b1', 'v1'), default=None,
                    help='time only B1-B3, only B1 or only V1 '
                         '(default: all)')
    ap.add_argument('--out', default=None, help='also write the JSON here')
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('compare_kernels: no CUDA device', file=sys.stderr)
        return 1
    libs, paths = _build(args.baseline, args.only)
    sass = {label: {kernel: n for lib in libs_.values()
                    for kernel, n in sass_counts(lib).items()}
            for label, libs_ in paths.items()}
    print(json.dumps({'sass': sass}), flush=True)
    dev = torch.device('cuda')

    rows = []
    data, v8_args = _v8_scene(dev)
    cases = [] if args.only == 'v1' else _scatter_cases(dev, libs, data)
    if args.only in (None, 'b'):
        cases = itertools.chain(cases, _cases(dev, libs))
    if args.only in (None, 'v1'):
        cases = itertools.chain(cases, _dda_cases(dev, libs, data, v8_args))
    for name, fns in cases:
        row = {'input': name, 'ms': {}, 'max_rel_err': {}}
        for label, (launch, plain) in fns.items():
            if plain is None:
                continue
            want, got = plain(), launch()
            n = want.shape[1] - (1 if name == 'paged_gather_occupancy'
                                 and label != 'baseline' else 0)
            if want.dim() == 3:       # B2: latent rows, then occupancy row
                if not torch.equal(got[:, n:], want[:, n:]):
                    raise AssertionError(f'{label} on {name}: occupancy '
                                         'row differs')
                want, got = want[:, :n], got[:, :n]
            rel = float((got - want).abs().max()) / float(want.abs().max())
            row['max_rel_err'][label] = rel
            if not rel <= cs.REL_TOL:
                raise AssertionError(f'{label} on {name}: rel {rel:.3e}')
            del want, got
        first = cs.time_ms(next(iter(fns.values()))[0], REPS)
        row['reps'] = reps = max(REPS, math.ceil(TURN_MS / first))
        order = list(fns) + list(fns)[::-1]
        for label in order:
            row['ms'].setdefault(label, []).append(
                cs.time_ms(fns[label][0], reps))
            if name.startswith('voxel_dda'):
                row.setdefault('device_ms', {}).setdefault(label, []).append(
                    cs.graph_ms(fns[label][0], reps))
        rows.append(row)
        print(json.dumps(row), flush=True)
    card = cs.card_line()
    print(card)
    line = json.dumps({'card': card, 'sass': sass,
                       'rows': rows})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
