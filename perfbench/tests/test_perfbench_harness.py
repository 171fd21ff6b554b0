"""The harness: cells, configurations, mixes and metrics found by name in
files of their own; whole runs of tiny cells on the CPU (the harness's
look for a card skipped); the result's line; the import guard."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

import tiny
from perfbench.harness import bench, profile, runner

RESULT_KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def test_new_cell_config_mix_and_metric_are_new_files_only(tmp_path):
    root = tiny.make_root(str(tmp_path))
    # a per-layer metric of the new cell: a new reader and a new entry
    with open(os.path.join(root, 'perfbench', 'metrics',
                           'steps.tiny.py'), 'w') as f:
        f.write('def read(t):\n    return float(t.steps)\n')
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as f:
        b = json.load(f)
    b['per_layer'].append(dict(name='steps.tiny', unit='steps',
                               better='higher', source='device_trace',
                               layer='device', moves='nerf_rays_per_s',
                               workloads=['lego.tiny']))
    with open(path, 'w') as f:
        json.dump(b, f)
    b = bench.load(root)
    c = bench.cell(b, 'lego.tiny')
    assert c.config['name'] == 'lego_tiny' and c.traffic == 'tiny_object'
    assert bench.config(root, c)['entry'] == 'nerf'
    assert bench.traffic(root, c)['views'] == 4
    assert 'loss' in bench.limits(root, c)
    assert [m['name'] for m in c.end_to_end] == ['nerf_rays_per_s',
                                                 'setup_s']
    names = [m['name'] for m in c.per_layer]
    assert 'steps.tiny' in names and 'encode_ms.nerf' in names
    assert 'encode_ms.image' not in names
    trace = profile.Trace(steps=3, wall_s=1.0, busy_s=0.5, device_ops=30,
                          ranges_ms={}, kernels_s={}, gaps_s={})
    assert bench.reader(root, 'steps.tiny')(trace) == 3.0
    # the repository's own cells are untouched
    assert bench.cell(b, 'lego.object').config['name'] == 'lego'


def test_new_traffic_kind_and_reader_are_new_files_only(tmp_path):
    """A cell on a kind of input no mix had before: the kind's code, the
    mix, the limits and the entries, all new; a metric split by cell
    read by the reader of its base name."""
    root = tiny.make_root(str(tmp_path))
    base = os.path.join(root, 'perfbench')
    with open(os.path.join(base, 'traffic', 'noise_photo.py'), 'w') as f:
        f.write('import numpy as np\n\n\n'
                'def make(t, seed, device):\n'
                '    rng = np.random.RandomState(seed % 2 ** 32)\n'
                '    q = rng.randint(0, 256, (t["h"], t["w"], 3))\n'
                '    return (q / 255.0).astype(np.float32)\n')
    with open(os.path.join(base, 'traffic', 'tiny_noise.json'), 'w') as f:
        json.dump(dict(kind='noise_photo', h=12, w=20), f)
    shutil.copy(os.path.join(base, 'limits', 'kodak.tiny.json'),
                os.path.join(base, 'limits', 'kodak_tiny.noise.json'))
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as f:
        b = json.load(f)
    b['workloads'].append(dict(name='kodak_tiny.noise', config='kodak_tiny',
                               traffic='tiny_noise', chips=1, why='tiny'))
    for m in b['end_to_end'] + b['per_layer']:
        if 'kodak.tiny' in m.get('workloads', ()):
            m['workloads'].append('kodak_tiny.noise')
    b['per_layer'].append(dict(name='adam_ms.noise', unit='ms',
                               better='lower', source='device_trace',
                               layer='optimizer', moves='image_pix_per_s',
                               workloads=['kodak_tiny.noise']))
    with open(path, 'w') as f:
        json.dump(b, f)
    r = runner.run(root, 'kodak_tiny.noise', 5, 0.2, False, 'cpu',
                   log=lambda *a, **k: None)
    assert r['correct'] is True and r['attempted'] > 0
    assert set(r['metrics']) == {'image_pix_per_s', 'setup_s'}
    c = bench.cell(bench.load(root), 'kodak_tiny.noise')
    img = bench.kind(root, 'noise_photo').make(bench.traffic(root, c), 5,
                                               'cpu')
    assert img.shape == (12, 20, 3)
    trace = profile.Trace(steps=2, wall_s=1.0, busy_s=0.5, device_ops=30,
                          ranges_ms={'step/adam': 0.25}, kernels_s={},
                          gaps_s={})
    assert bench.reader(root, 'adam_ms.noise')(trace) == 0.25


@pytest.mark.parametrize('cell, e2e', [('lego.tiny', 'nerf_rays_per_s'),
                                       ('kodak.tiny', 'image_pix_per_s')])
def test_tiny_run_reports_and_passes(tmp_path, cell, e2e):
    root = tiny.make_root(str(tmp_path))
    r = runner.run(root, cell, 2 ** 31 + 11, 0.2, False, 'cpu',
                   log=lambda *a, **k: None)
    assert list(r)[:5] == RESULT_KEYS and list(r)[-1] == 'checks'
    assert r['correct'] is True and r['failed'] == 0
    assert r['attempted'] > 0
    assert set(r['metrics']) == {e2e, 'setup_s'}
    assert r['metrics'][e2e]['value'] > 0
    assert set(r['checks']) == set(tiny.NUMBERS[cell.split('.')[0]])
    for c in r['checks'].values():
        assert 0.0 <= c['value'] <= 1e-4          # program vs reference
    lines = runner.check_lines(r)
    assert len(lines) == len(r['checks']) and all('ok' in x for x in lines)
    json.dumps(r)


def test_guard_compares_whole_top_level_names():
    mods = ['shacira_tpu_torch', 'shacira_tpu_torch.ops.scatter', 'numpy',
            'jaxtyping', 'jax', 'jaxlib.xla_client', 'shacira_tpu.ops',
            'flax.linen', 'shacira_tpu_other']
    assert runner.forbidden_modules(mods) == ['flax.linen', 'jax',
                                              'jaxlib.xla_client',
                                              'shacira_tpu.ops']


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(tiny.REPO, 'perfbench', 'reference')
    for name in os.listdir(ref):
        if not name.endswith('.py'):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split('.')[0] in ('__future__', 'math', 'numpy',
                                           'torch', 'dataclasses', 'typing',
                                           'perfbench'), (name, m)
                if m.startswith('perfbench'):
                    assert m.startswith('perfbench.reference'), (name, m)


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, 'perfbench', 'run.py'),
         '--workload', 'lego.object', '--seed', '1', '--seconds', '1',
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='1', CUDA_VISIBLE_DEVICES=''))


def test_no_card_no_result():
    p = _run_py(tiny.REPO)
    assert p.returncode != 0 and p.stdout.strip() == ''
    assert 'CUDA device' in p.stderr


def test_without_the_program_no_result(tmp_path):
    """A checkout of BENCHMARK.json and perfbench/ alone fails before it
    prints anything, card or no card."""
    shutil.copy(os.path.join(tiny.REPO, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(tiny.REPO, 'perfbench'),
                    os.path.join(tmp_path, 'perfbench'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    code = ('import sys; sys.path.insert(0, "."); '
            'from perfbench.harness import runner; '
            'runner.run(".", "lego.object", 1, 1.0, False, "cpu")')
    p = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert p.returncode != 0 and p.stdout.strip() == ''
    assert 'shacira_tpu_torch' in p.stderr
    assert _run_py(str(tmp_path)).stdout.strip() == ''
