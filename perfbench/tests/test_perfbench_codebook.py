"""The cell ``codebook.object`` through the harness on the CPU, at a tiny
size (a root of ``tiny.py`` with a ``codebook.tiny`` cell added as new
files and entries): every reading present and ``correct``, the faults it
must refuse, the work the harness counts against the program's own
counters, and the cell's readers."""
from __future__ import annotations

import json
import os

import pytest
import torch

import tiny
from perfbench import control
from perfbench.harness import bench, compare, profile, runner, vqad
from perfbench.reference import common as C

TINY_CODEBOOK = dict(base_lod=2, num_lods=3, hidden_dim=16, num_steps=32,
                     num_rays_sampled_per_img=64)
HARNESS = dict(block_steps=4, warmup_steps=5, check_steps=3, trace_steps=2)
NUMBERS = ('loss', 'grad', 'change', 'table_grad', 'table_change',
           'loss_after_block', 'change_after_block')
NEW = ('octree_query_ms.codebook', 'codebook_mix_ms.codebook',
       'gather_roofline.codebook')
COUNTED = ('slot_use.codebook', 'kept_share.codebook')
SEED = 2 ** 31 + 29


def _real_limits() -> dict:
    with open(os.path.join(tiny.REPO, 'perfbench', 'limits',
                           'codebook.object.json')) as f:
        return json.load(f)['limits']


def make_root(tmp: str, limits: dict = None) -> str:
    """``tiny.make_root`` with the cell ``codebook.tiny``: the
    configuration ``codebook`` at LODs 2-4, 64 rays x 32 steps, on the
    tiny object, reporting what ``codebook.object`` reports."""
    root = tiny.make_root(tmp)
    with open(os.path.join(tiny.REPO, 'perfbench', 'configs',
                           'codebook.json')) as f:
        cfg = json.load(f)
    cfg.update(name='codebook_tiny', harness=HARNESS,
               reduced=sorted(TINY_CODEBOOK))
    cfg['settings'].update(TINY_CODEBOOK)
    base = os.path.join(root, 'perfbench')
    tiny._json(os.path.join(base, 'configs', 'codebook_tiny.json'), cfg)
    tiny._json(os.path.join(base, 'limits', 'codebook.tiny.json'),
               {'limits': limits or {k: tiny.LOOSE for k in NUMBERS}})
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as f:
        b = json.load(f)
    b['configs'].append(dict(name='codebook_tiny', source='test',
                             file='perfbench/configs/codebook_tiny.json',
                             reduced=sorted(TINY_CODEBOOK), why='tiny'))
    b['workloads'].append(dict(name='codebook.tiny', config='codebook_tiny',
                               traffic='tiny_object', chips=1, why='tiny'))
    for m in b['end_to_end'] + b['per_layer']:
        if 'codebook.object' in m.get('workloads', ()):
            m['workloads'].append('codebook.tiny')
    tiny._json(path, b)
    return root


def _cell(root: str):
    b = bench.load(root)
    c = bench.cell(b, 'codebook.tiny')
    return bench.entry(root, 'codebook').Cell(
        root, bench.config(root, c), bench.traffic(root, c), SEED, 'cpu')


def test_tiny_run_reports_and_passes(tmp_path):
    root = make_root(str(tmp_path), _real_limits())
    r = runner.run(root, 'codebook.tiny', SEED, 0.2, False, 'cpu',
                   log=lambda *a, **k: None)
    assert r['correct'] is True and r['attempted'] > 0, r['checks']
    assert set(r['metrics']) == {'nerf_rays_per_s', 'setup_s'}
    assert set(r['checks']) == set(NUMBERS)
    for c in r['checks'].values():
        assert 0.0 <= c['value'] <= 1e-4          # program vs reference


def test_the_cell_reports_its_metrics(tmp_path):
    c = bench.cell(bench.load(make_root(str(tmp_path))), 'codebook.tiny')
    names = {m['name'] for m in c.per_layer}
    assert set(NEW + COUNTED) <= names and 'b1_roofline.codebook' in names
    assert not any(n.endswith('.nerf') for n in names)
    assert [m['name'] for m in c.end_to_end] == ['nerf_rays_per_s',
                                                 'setup_s']


def test_control_is_not_correct(tmp_path):
    limits = _real_limits()
    root = make_root(str(tmp_path), limits)
    r = control.readings(root, 'codebook.tiny', SEED, 'cpu',
                         variants=('program', 'control', 'half'))
    assert compare.judge(r['program'], limits)[0], r['program']
    assert not compare.judge(r['control'], limits)[0], r['control']
    assert not compare.judge(r['half'], limits)[0], r['half']


def test_a_logits_table_left_unchanged_is_not_correct(tmp_path):
    limits = _real_limits()
    cell = _cell(make_root(str(tmp_path), limits))
    cell.setup(only_checks=True)
    cell.free()
    ref = cell.reference()
    frozen = ('grid', 'logits', str(TINY_CODEBOOK['num_lods'] - 1))
    fault = cell.readings(cell.reference(frozen=frozen), ref)
    assert fault['table_change'] == 1.0, fault
    assert not compare.judge(fault, limits)[0]


def test_each_block_trains_from_the_start(tmp_path):
    """After set-up, and before each block, the trainer is back at the
    seed's weights with Adam's moments zero and its count 0."""
    cell = _cell(make_root(str(tmp_path)))
    cell.setup()
    tr, block = cell.tr, HARNESS['block_steps']

    def at_start():
        got = dict(C.leaves(tr.params))
        return (tr.opt_state['count'] == 0
                and all(torch.equal(got[p], t) for p, t in C.leaves(cell.p0))
                and all(not t.any() for m in ('mu', 'nu')
                        for _, t in C.leaves(tr.opt_state[m])))

    assert at_start()
    for _ in range(2):
        assert cell.block() == block
        assert tr.opt_state['count'] == block and not at_start()
    cell.restart(tr)
    assert at_start()


def test_a_dead_field_is_refused(tmp_path):
    """A density that is zero everywhere ends the run."""
    cell = _cell(make_root(str(tmp_path)))
    cell.setup(only_checks=True)
    assert cell.live_share() == 1.0
    with torch.no_grad():
        cell.tr.params['decoder_density']['layers'][-1]['b'][0] = -100.0
    assert cell.live_share() == 0.0
    with pytest.raises(RuntimeError, match='died'):
        cell.free()


def test_work_counts_the_rows_the_program_gathers(tmp_path):
    """``Cell.work``'s corner rows, from the shapes alone, equal the
    program's counter over a profiled block of training steps; the dense
    trace's sample counters feed ``slot_use`` and ``kept_share``."""
    from shacira_tpu_torch.utils import perf
    root = make_root(str(tmp_path))
    cell = _cell(root)
    cell.setup(only_checks=True)
    perf.reset_counts()
    n = 2
    with torch.profiler.profile() as prof:
        cell.train(cell.tr, n)
    w = cell.work(None, n)
    s = cell.s
    samples = s['num_rays_sampled_per_img'] * s['num_steps']
    assert w['samples'] == samples
    assert perf.counted('field/corner_rows') == n * w['corner_rows'] \
        == n * samples * s['num_lods'] * 8
    names = [e.name for e in prof.events()]
    for span in ('field/octree_query', 'field/gather', 'field/codebook_mix',
                 'backward/encode', 'trace/integrate'):
        assert span in names, span
    slots, kept = perf.counted('trace/slots'), perf.counted(
        'trace/kept_samples')
    assert slots == n * samples
    assert 0 < kept == perf.counted('trace/live_samples') < slots
    t = profile.Trace(steps=n, wall_s=1.0, busy_s=0.9, device_ops=100,
                      ranges_ms={}, kernels_s={}, gaps_s={}, extra=w)
    assert bench.reader(root, 'slot_use.codebook')(t) == pytest.approx(
        100.0 * kept / slots)
    assert bench.reader(root, 'kept_share.codebook')(t) == 100.0
    perf.reset_counts()


def test_the_new_readers_read_the_spans_and_the_work(tmp_path):
    root = make_root(str(tmp_path))
    s = bench.config(root, bench.cell(bench.load(root),
                                      'codebook.tiny'))['settings']
    extra = _cell(root).work(None, 2)
    t = profile.Trace(steps=2, wall_s=1.0, busy_s=0.9, device_ops=100,
                      ranges_ms={'field/encode': 9.0,
                                 'field/octree_query': 2.0,
                                 'field/gather': 3.0,
                                 'field/codebook_mix': 4.0},
                      kernels_s={'scatter_add_rows_kernel<4>': 0.004},
                      gaps_s={}, extra=extra)
    read = {m: bench.reader(root, m) for m in NEW}
    assert read['octree_query_ms.codebook'](t) == 2.0
    assert read['codebook_mix_ms.codebook'](t) == 4.0
    assert read['gather_roofline.codebook'](t) == pytest.approx(
        100.0 * vqad.gather_bound_s(s, extra['samples']) * 1e3 / 3.0)
    assert bench.reader(root, 'b1_roofline.codebook')(t) == pytest.approx(
        100.0 * extra['b1_bound_ms'] / 2.0)
    # a program without the spans: the readers give nothing
    bare = profile.Trace(steps=2, wall_s=1.0, busy_s=0.9, device_ops=100,
                         ranges_ms={'field/encode': 9.0}, kernels_s={},
                         gaps_s={}, extra=extra)
    assert all(read[m](bare) is None for m in NEW)


def test_work_of_the_configuration():
    with open(os.path.join(tiny.REPO, 'perfbench', 'configs',
                           'codebook.json')) as f:
        s = json.load(f)['settings']
    samples = 4096 * 1024
    assert vqad.table_rows(s) == 19_431_844
    assert vqad.corner_rows(s, samples) == 134_217_728
    # 8.59 GB written and 0.54 GB of indices read at 3.35 TB/s
    assert vqad.gather_bound_s(s, samples) * 1e3 == pytest.approx(
        (134_217_728 * 68) / 3.35e12 * 1e3)
    # B1 at F = 16: PERF.md's kernel table, row B1(f)
    assert vqad.b1_bound_s(s, samples) * 1e3 == pytest.approx(3.096,
                                                               abs=5e-4)
    head = 3 * 2 * (5 * 64 + 64 * 16 + 43 * 64 + 64 * 64 + 64 * 3)
    grid = 4 * (8 * 3 + 8 * vqad.mix_flops(16, 5))
    assert vqad.step_flops(s, samples) - vqad.step_flops(s, 0) == \
        samples * (grid + head + 20)
