"""Run one cell of the benchmark of ``shacira_tpu_torch`` once.

    python3 perfbench/run.py --workload lego.object --seed 7 --seconds 30 \
        --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for.  ``--trace 0`` times the window and prints the cell's end-to-end
metrics; ``--trace 1`` profiles a block of steps and prints its
per-layer metrics.  Both compare what the trained program produced with
the plain reference (``perfbench/reference/``) and print every compared
number beside its limit as the last lines of standard error; the last
line of standard output is the result as one JSON object.  A run that
finds no card, or finds JAX or the JAX package loaded, prints no result
and exits with another code than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed path inside the checkout
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build',
                                                  'torch_extensions')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.harness import bench, runner
    cell = bench.cell(bench.load(ROOT), args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA device(s); found '
              f'{found}', file=sys.stderr)
        return 2
    result = runner.run(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), 'cuda', T_START)
    bad = runner.forbidden_modules(sys.modules)
    if bad:
        print(f'loaded in this process: {", ".join(bad)}', file=sys.stderr)
        return 3
    for line in runner.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
