"""One run of one cell: set-up, the timed window or the traced block, the
comparison with the reference, and the result's line."""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from typing import Optional

import torch

from perfbench.harness import bench, compare

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'shacira_tpu')


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot), compared whole, is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in modules if m.split('.')[0] in FORBIDDEN})


def card(device: str) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if device != 'cuda':
        return 'no card'
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi unreadable'


def _metric(value: float, unit: str) -> dict:
    return {'value': value, 'unit': unit}


def run(root: str, name: str, seed: int, seconds: float, trace: bool,
        device: str = 'cuda', t_start: Optional[float] = None,
        log=print) -> dict:
    """The result of one run of cell ``name``; ``t_start`` is the process
    start on the host clock (default: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    b = bench.load(root)
    c = bench.cell(b, name)
    config = bench.config(root, c)
    limits = bench.limits(root, c)
    cell = bench.entry(root, config['entry']).Cell(
        root, config, bench.traffic(root, c), seed, device)
    t_setup = time.perf_counter()
    cell.setup()
    phases = {'start': t_setup - t_start, **cell.phases}
    log('set-up phases (s): ' + ', '.join(f'{k} {v:.3f}' for k, v in
                                          phases.items()), file=sys.stderr)
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    metrics, dev_extra, breakdown = {}, {}, None
    attempted = 0
    if not trace:
        sync()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        blocks = []
        while True:
            attempted += cell.block()
            sync()
            elapsed = time.perf_counter() - t0
            blocks.append(elapsed - sum(blocks))
            if elapsed >= seconds:
                break
        values = {'setup_s': setup_s,
                  cell.throughput: cell.rate(attempted, elapsed)}
        log(f'window: {attempted} steps in {elapsed:.6f} s (blocks '
            + ' '.join(f'{b:.4f}' for b in blocks)
            + f'); set-up {setup_s:.6f} s', file=sys.stderr)
        for m in c.end_to_end:
            if m['name'] not in values:
                raise KeyError(f'{name} does not report {m["name"]}')
            metrics[m['name']] = _metric(values[m['name']], m['unit'])
    else:
        t = cell.trace()
        attempted = t.steps
        t.extra['card'] = card(device)
        for m in c.per_layer:
            v = bench.reader(root, m['name'])(t)
            if v is not None:
                metrics[m['name']] = _metric(v, m['unit'])
        dev_extra = {'busy_s': t.busy_s, 'window_s': t.wall_s}
        breakdown = {'device_ops': t.top(t.kernels_s),
                     'idle_gaps': t.top(t.gaps_s)}
        log(f'traced {t.steps} steps: wall {t.wall_s:.6f} s, busy '
            f'{t.busy_s:.6f} s, unprofiled step {t.extra["step_s"]:.6f} s; '
            f'card {t.extra["card"]}', file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated() if device == 'cuda' else 0)
    kind = torch.cuda.get_device_name(0) if device == 'cuda' else 'cpu'
    cell.free()
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = cell.readings(cell.prog, cell.reference())
    log(f'reference: {time.perf_counter() - t_ref:.3f} s', file=sys.stderr)
    log('readings: ' + ', '.join(f'{k} {v!r}' for k, v in readings.items()),
        file=sys.stderr)
    ok, rows = compare.judge(readings, limits)
    result = {'correct': ok, 'attempted': attempted, 'failed': 0,
              'metrics': metrics,
              'device': {'platform': 'gpu' if device == 'cuda' else 'cpu',
                         'kind': kind, 'count': c.chips,
                         'memory_peak_bytes': peak, **dev_extra}}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = {n: {'value': v, 'limit': lim} for n, v, lim in rows}
    return result


def check_lines(result: dict) -> list:
    """One line a compared number: its name, value and limit."""
    def ok(c):
        return c['value'] is not None and c['value'] <= c['limit']
    return [f'check {n}: {c["value"]!r} limit {c["limit"]!r} '
            f'{"ok" if ok(c) else "FAILS"}'
            for n, c in result['checks'].items()]
