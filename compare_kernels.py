#!/usr/bin/env python3
"""Time versions of the port's scatter kernels against each other on the
card, on ``chip_smoke.py``'s inputs at the lego step's shapes.

    python3 compare_kernels.py [--baseline DIR] [--out FILE]

Versions, each built anew with ``build.NVCC_FLAGS`` into
``build/compare/``:

* ``tree``: ``csrc/scatter.cu`` (B1) and ``csrc/paged_hash.cu`` (B3) of
  this checkout;
* ``baseline`` (``--baseline DIR``): the same two files of another
  checkout, ``DIR/shacira_tpu_torch/csrc`` (both export the same C entry
  points).

Inputs: ``chip_smoke.scatter_inputs`` (B1(a) on random points and on
ray-ordered samples, B1(b)) and ``chip_smoke.paged_inputs`` (B3 at train
shapes).  Every version is launched through the port's own launch helpers
and first held against the plain version on every input (1e-5 of the
largest value); then the versions are timed with CUDA events, ``REPS``
launches a turn, in order and in reverse (A B B A).  Prints the card line
and one JSON line, also written to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / 'build' / 'compare'
REPS = 10


def _build(baseline):
    """Compile both sources of every version in parallel: {label: {name:
    ctypes.CDLL}}."""
    from shacira_tpu_torch.kernels.build import CSRC, compile_source
    trees = {'tree': CSRC}
    if baseline:
        trees['baseline'] = Path(baseline) / 'shacira_tpu_torch' / 'csrc'
    shutil.rmtree(OUT_DIR, ignore_errors=True)    # another tree's build
    jobs = [(label, name, csrc / f'{name}.cu',
             OUT_DIR / label / f'lib{name}.so')
            for label, csrc in trees.items()
            for name in ('scatter', 'paged_hash')]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = list(pool.map(lambda j: compile_source(j[2], j[3]), jobs))
    out = {}
    for (label, name, _, _), lib in zip(jobs, libs):
        out.setdefault(label, {})[name] = ctypes.CDLL(str(lib))
    return out


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
    from shacira_tpu_torch.ops import paged_hash as ph
    from shacira_tpu_torch.ops import scatter
    libs = _build(args.baseline)
    dev = torch.device('cuda')

    cases = []        # (input name, plain fn, args, {label: fn})
    for name, fargs in cs.scatter_inputs(dev).items():
        cases.append((name, scatter.scatter_add_plain, fargs, {
            label: lambda *a, lib=l['scatter']: scatter._launch_scatter(
                *a, lib=lib) for label, l in libs.items()}))
    inp = cs.paged_inputs(dev)
    paged_args = (*ph._device_inputs(inp['coords_s'], inp['slot_valid'],
                                     inp['block_cell']),
                  inp['g'], inp['static'])
    cases.append(('paged_scatter', ph.paged_scatter_plain, paged_args, {
        label: lambda *a, lib=l['paged_hash']: ph._launch_scatter(
            *a, lib=lib) for label, l in libs.items()}))

    rows = []
    for name, plain, fargs, fns in cases:
        want = plain(*fargs)
        scale = float(want.abs().max())
        row = {'input': name, 'ms': {}, 'max_rel_err': {}}
        for label, fn in fns.items():
            rel = float((fn(*fargs) - want).abs().max()) / scale
            row['max_rel_err'][label] = rel
            if not rel <= cs.REL_TOL:
                raise AssertionError(f'{label} on {name}: rel {rel:.3e}')
        del want
        order = list(fns) + list(fns)[::-1]
        for label in order:
            row['ms'].setdefault(label, []).append(
                cs.time_ms(lambda: fns[label](*fargs), REPS))
        rows.append(row)
        print(json.dumps(row), flush=True)
    card = cs.card_line()
    print(card)
    line = json.dumps({'card': card, 'reps': REPS, 'rows': rows})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
