"""Readings that the limits of ``correct`` are set from, for a cell whose
entry plants faults (``Cell.FAULTS``), one cell at its own size, on the
card:

    python3 perfbench/planted.py --workload v8.rtmv --seeds 1 2 3 \
        --out planted_v8.jsonl

For each seed, one process builds the cell's trainer and drives it
through the steps the comparison reads (no timed window), then compares
with the float32 reference the program (``program``: the lower
readings), the reference computed in bfloat16 in the program's place
(``control``) and the reference with each planted fault in the program's
place (named by the fault).  One JSON line a seed.  The benchmark's runs
do not run this.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(root: str, name: str, seed: int, device: str = 'cuda',
             variants=None) -> dict:
    import torch
    from perfbench.harness import bench
    c = bench.cell(bench.load(root), name)
    config = bench.config(root, c)
    cell = bench.entry(root, config['entry']).Cell(
        root, config, bench.traffic(root, c), seed, device)
    variants = variants or ['program', 'control', *cell.FAULTS]
    t0 = time.perf_counter()
    cell.setup(only_checks=True)
    cell.free()
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    ref = cell.reference()
    out = {'seed': seed, 'setup_s': time.perf_counter() - t0}
    for v in variants:
        if v == 'program':
            out[v] = cell.readings(cell.prog, ref)
        elif v == 'control':
            out[v] = cell.readings(cell.reference(torch.bfloat16), ref)
        else:
            out[v] = cell.readings(cell.reference(fault=v), ref)
    del cell
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--out', default=None)
    ap.add_argument('--variants', nargs='+', default=None)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        line = json.dumps(readings(ROOT, args.workload, seed,
                                   variants=args.variants))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
