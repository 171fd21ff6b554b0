"""The comparison that decides ``correct`` fails what it must: the
reference computed in bfloat16 in the program's place (the control), and
whole runs with the timed path broken underneath -- a step that leaves
its state unchanged, half of the batch left out with the mean over the
rest.  Tiny cells on the CPU, held to the real cells' limits."""
from __future__ import annotations

import json
import os

import pytest

import tiny
from perfbench import control
from perfbench.harness import compare, runner

REAL = {'lego.tiny': 'lego.object', 'kodak.tiny': 'kodak.photo'}
SEED = 2 ** 31 + 23


def _limits(cell: str) -> dict:
    with open(os.path.join(tiny.REPO, 'perfbench', 'limits',
                           REAL[cell] + '.json')) as f:
        return json.load(f)['limits']


@pytest.mark.parametrize('cell', sorted(REAL))
def test_control_is_not_correct(tmp_path, cell):
    limits = _limits(cell)
    root = tiny.make_root(str(tmp_path), {cell: limits})
    r = control.readings(root, cell, SEED, 'cpu',
                         variants=('program', 'control'))
    assert compare.judge(r['program'], limits)[0], r['program']
    assert not compare.judge(r['control'], limits)[0], r['control']


def _unchanged(monkeypatch):
    from shacira_tpu_torch import optim
    monkeypatch.setattr(optim, 'adam_update', lambda *a, **k: None)


def _half(monkeypatch):
    from shacira_tpu_torch.trainers import image_trainer, multiview_trainer
    nerf_step = multiview_trainer.MultiviewTrainer.step
    image_step = image_trainer.ImageTrainer.step

    def nerf(self, rays_o, rays_d, gt, draws, **kw):
        n = rays_o.shape[0] // 2
        d = multiview_trainer.StepDraws(draws.march_u[:n], draws.sga_u,
                                        draws.noise)
        return nerf_step(self, rays_o[:n], rays_d[:n], gt[:n], d, **kw)

    def image(self, coords, gt, draws, **kw):
        n = coords.shape[0] // 2
        return image_step(self, coords[:n], gt[:n], draws, **kw)

    monkeypatch.setattr(multiview_trainer.MultiviewTrainer, 'step', nerf)
    monkeypatch.setattr(image_trainer.ImageTrainer, 'step', image)


@pytest.mark.parametrize('fault', [_unchanged, _half],
                         ids=['state_unchanged', 'half_batch'])
@pytest.mark.parametrize('cell', sorted(REAL))
def test_broken_step_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root = tiny.make_root(str(tmp_path), {cell: _limits(cell)})
    fault(monkeypatch)
    r = runner.run(root, cell, SEED, 0.2, False, 'cpu',
                   log=lambda *a, **k: None)
    assert r['correct'] is False, r['checks']
