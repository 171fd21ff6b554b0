#!/usr/bin/env python3
"""Time versions of the port's kernels against each other on the card, on
``chip_smoke.py``'s inputs at the lego step's shapes.

    python3 compare_kernels.py [--baseline DIR] [--out FILE]

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
  reads -- what the loads cost.  Not checked against the plain version.

Inputs: ``chip_smoke.scatter_inputs`` (B1(a) one LOD, on random points and
on ray-ordered samples, B1(b)), ``chip_smoke.paged_inputs`` (B2 and B3 at
train shapes, B2 also with its occupancy row of a 128^3 grid) and
``chip_smoke.prune_inputs`` (B2 at the prune's 2,097,152 rows).  On the
occupancy-row input a baseline without that row runs B2 without it.
Every version is launched through the port's own launch helpers and first
held against the plain version on every input (1e-5 of the largest value;
the occupancy row exactly); then the versions are timed with CUDA events,
in order and in reverse (A B B A), each turn ``REPS`` launches or enough
for ``TURN_MS`` of the first version's time, whichever is more.  Also counts,
from ``cuobjdump -sass`` of each version's ``paged_hash`` library, the
SASS instructions of each kernel and its ``MUFU.RCP`` (one per integer
division by a runtime value).  Prints the card line and one JSON line,
also written to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / 'build' / 'compare'
REPS = 10          # launches a turn, at least
TURN_MS = 20.0     # and at least this long: short kernels get more
NO_LOADS = 'tree_no_loads'


def _build(baseline):
    """Compile every version's sources in parallel: ({label: {name:
    ctypes.CDLL}}, {label: paged_hash library path})."""
    from shacira_tpu_torch.kernels.build import CSRC, compile_source
    trees = {'tree': CSRC}
    if baseline:
        trees['baseline'] = Path(baseline) / 'shacira_tpu_torch' / 'csrc'
    shutil.rmtree(OUT_DIR, ignore_errors=True)    # another tree's build
    jobs = [(label, name, csrc / f'{name}.cu',
             OUT_DIR / label / f'lib{name}.so', ())
            for label, csrc in trees.items()
            for name in ('scatter', 'paged_hash')]
    jobs.append((NO_LOADS, 'paged_hash', CSRC / 'paged_hash.cu',
                 OUT_DIR / NO_LOADS / 'libpaged_hash.so',
                 ('-DGATHER_WITHOUT_LOADS',)))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = list(pool.map(lambda j: compile_source(j[2], j[3], j[4]),
                             jobs))
    out, paths = {}, {}
    for (label, name, _, _, _), lib in zip(jobs, libs):
        out.setdefault(label, {})[name] = ctypes.CDLL(str(lib))
        if name == 'paged_hash':
            paths[label] = lib
    return out, paths


def sass_counts(lib: Path) -> dict:
    """{kernel: {'instructions': n, 'MUFU.RCP': n}} of a library's SASS."""
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


def _cases(dev, libs):
    """(input name, {label: (launch, plain)}): zero-argument closures; a
    plain of None skips the check."""
    from shacira_tpu_torch.ops import paged_hash as ph
    from shacira_tpu_torch.ops import scatter
    versions = [k for k in libs if k != NO_LOADS]
    cases = []
    for name, fargs in cs.scatter_inputs(dev).items():
        plain = (lambda a=fargs: scatter.scatter_add_plain(*a))
        cases.append((name, {
            label: (lambda a=fargs, lib=libs[label]['scatter']:
                    scatter._launch_scatter(*a, lib=lib), plain)
            for label in versions}))
    inp = cs.paged_inputs(dev)
    slots = ph._device_inputs(inp['coords_s'], inp['slot_valid'],
                              inp['block_cell'])
    static, z = inp['static'], inp['z']

    def gather(args, st, occ):
        launch = {}
        for label in libs:
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
    ap.add_argument('--out', default=None, help='also write the JSON here')
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('compare_kernels: no CUDA device', file=sys.stderr)
        return 1
    libs, paths = _build(args.baseline)
    sass = {label: sass_counts(path) for label, path in paths.items()}
    print(json.dumps({'sass': sass}), flush=True)
    dev = torch.device('cuda')

    rows = []
    for name, fns in _cases(dev, libs):
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
