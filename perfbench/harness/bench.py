"""What ``BENCHMARK.json`` names, found by name in files of their own.

* a configuration: ``configs[].file`` (its frozen settings, its entry and
  the harness's block sizes);
* a traffic mix: ``perfbench/traffic/<mix>.json``, parameters read by
  the one generator (``traffic.py``), which finds the code of the mix's
  ``kind`` (a scene, a photo) in ``perfbench/traffic/<kind>.py``;
* an entry, the code that drives one family of the program's trainers:
  ``perfbench/entries/<entry>.py``;
* a per-layer metric: ``perfbench/metrics/<metric>.py``, else, for a
  name ``<base>.<part>``, ``perfbench/metrics/<base>.py`` (one reader of
  a quantity split by the end-to-end metric it moves); its
  ``read(trace)`` returns the value or None;
* a cell's limits on the numbers that decide ``correct``:
  ``perfbench/limits/<cell>.json``.

A later cell, configuration, mix or metric is new files and entries
only.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import List

HERE = 'perfbench'


@dataclass
class Cell:
    name: str
    config: dict           # BENCHMARK.json's configuration entry
    traffic: str
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: str) -> dict:
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def _for(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get('workloads', [cell])]


def cell(bench: dict, name: str) -> Cell:
    for w in bench['workloads']:
        if w['name'] == name:
            cfg = next(c for c in bench['configs'] if c['name'] == w['config'])
            return Cell(name, cfg, w['traffic'], int(w['chips']),
                        _for(bench['end_to_end'], name),
                        _for(bench['per_layer'], name))
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def _json(root: str, *parts) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def config(root: str, c: Cell) -> dict:
    return _json(root, c.config['file'])


def traffic(root: str, c: Cell) -> dict:
    return _json(root, HERE, 'traffic', c.traffic + '.json')


def limits(root: str, c: Cell) -> dict:
    return _json(root, HERE, 'limits', c.name + '.json')['limits']


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(root: str, name: str):
    return _module(os.path.join(root, HERE, 'entries', name + '.py'),
                   'perfbench_entry_' + name)


def kind(root: str, name: str):
    """The module whose ``make(mix, seed, device)`` makes a mix's
    inputs."""
    return _module(os.path.join(root, HERE, 'traffic', name + '.py'),
                   'perfbench_traffic_' + name)


def reader(root: str, metric: str):
    """``read(trace) -> float | None`` of a per-layer metric."""
    for name in (metric, metric.split('.')[0]):
        path = os.path.join(root, HERE, 'metrics', name + '.py')
        if os.path.exists(path):
            return _module(path, 'perfbench_metric_'
                           + name.replace('.', '_')).read
    raise FileNotFoundError(f'no reader of {metric!r} in {HERE}/metrics')
