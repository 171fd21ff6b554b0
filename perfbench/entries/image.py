"""Entry ``image``: the program's image trainer (``ImageTrainer``, built
by ``apps/train_image.build_trainer``) on one in-memory photo.

Set-up builds one trainer with the benchmark's weights and warms it
through ``warmup_steps`` steps (one step is one epoch over the pixel
lattice) in blocks of ``block_steps``, the trainer's own chunk.  Its
first ``check_steps`` steps, its best state after them and its first
``div`` recalibration are recorded on the way by a wrapper of the
trainer's own ``step`` that changes nothing it does.  The window runs
whole blocks through the trainer's ``train``.
"""
from __future__ import annotations

import torch

from perfbench.harness import compare, program, roofline
from perfbench.reference import common as C
from perfbench.reference.image import (
    ImageReference, lattice, recalibrated_div)


class Recorder(program.Recorder):
    """Also keeps the best state after the checked steps and the first
    ``div`` recalibration's input and output."""
    DRAWS = ('sga_u', 'noise')

    def __init__(self, trainer, p0: dict, steps: int, recal: int):
        super().__init__(trainer, p0, steps)
        self.recal = recal

    def step(self, coords, gt, draws, **kw):
        self.calls += 1
        it, tr = self.calls, self.tr
        if it <= self.steps:
            self.keep_draws(it, draws)
        if it == self.steps + 1:
            # the best state after the checked steps
            self.best_loss = tr.best_loss.clone()
            self.best_change = program.diff_norms(tr.best_params, self.p0)
        if it == self.recal:
            self.recal_in = tr.params['grid']['codebook'].detach().clone()
        out = self.orig['step'](coords, gt, draws, **kw)
        self.stepped(it, out)
        if it == self.recal:
            self.recal_out = tr.params['grid']['latent_dec']['div'].clone()
        return out

    def outputs(self) -> dict:
        return dict(super().outputs(), best_loss=float(self.best_loss),
                    best_change=program.floats(self.best_change),
                    div=self.recal_out.cpu())

    def to_host(self):
        super().to_host()
        self.recal_in = self.recal_in.cpu()


class Cell(program.TrainerCell):
    FAMILY = 'image'
    throughput = 'image_pix_per_s'

    def build(self):
        from shacira_tpu_torch import config as cfg_mod
        from shacira_tpu_torch.apps import train_image
        from shacira_tpu_torch.datasets.image import ImageDataset
        self.image = self.inputs
        args = program.parse(cfg_mod.build_image_parser(), self.s,
                             self.pseed, self.device)
        ds = ImageDataset(self.image, num_samples=args.num_samples,
                          sample_mode=args.sample_mode, seed=args.seed)
        return train_image.build_trainer(args, ds)

    def recorder(self, tr, p0):
        return Recorder(tr, p0, self.h['check_steps'], self.recal_step())

    def checked_steps(self) -> int:
        return max(self.h['check_steps'] + 1, self.recal_step())

    @staticmethod
    def train(tr, n: int):
        tr.train(epochs=n, finalize=False)

    def recal_step(self) -> int:
        """The first step that recalibrates ``div``."""
        return int(self.s['norm_every'])

    def rate(self, steps: int, seconds: float) -> float:
        """Megapixels a second."""
        return self.image.shape[0] * self.image.shape[1] * steps / seconds \
            / 1e6

    def work(self, before, n: int) -> dict:
        s = self.s
        pixels = self.image.shape[0] * self.image.shape[1]
        rows = ImageReference(s).grid.rows
        ld = s['latent_dim'] or s['feature_dim']
        return {'samples': pixels,
                'b1_bound_ms': 1e3 * roofline.scatter_bound_s(
                    pixels * s['num_lods'] * 4, ld, rows),
                'flops_per_step': roofline.image_step_flops(s, rows, pixels)}

    def reference(self, dtype=torch.float32, half: bool = False) -> dict:
        s, rec, dev = self.s, self.rec, self.device
        ref = ImageReference(s)
        h, w = self.image.shape[:2]
        coords = torch.as_tensor(lattice(h, w), device=dev)
        gt = torch.as_tensor(self.image.reshape(-1, 3), device=dev)
        p0 = program.to(self.p0, dev)
        state = dict(C.zero_moments(p0), params=p0)
        out = {'loss': {}, 'rgb_loss': {}, 'params': {}}
        for it in range(1, self.h['check_steps'] + 1):
            r = ref.step(state, coords, gt, program.to(rec.draws[it], dev),
                         it, dtype, half)
            out['loss'][it] = r['loss']
            out['rgb_loss'][it] = r['rgb_loss']
            if it == 1:
                out['g1'] = program.flat_norms(r['opt_grads'])
            state = r['state']
            out['params'][it] = program.diff_norms(state['params'], p0)
        out['change'] = program.floats(out['params'][self.h['check_steps']])
        best = min(out['rgb_loss'], key=out['rgb_loss'].get)
        out['best_loss'] = out['rgb_loss'][best]
        out['best_change'] = program.floats(out['params'][best])
        cb = rec.recal_in.to(dev)
        out['div'] = recalibrated_div(cb.to(dtype), s['norm']).float().cpu()
        return out

    @staticmethod
    def readings(prog: dict, ref: dict) -> dict:
        out = program.first_steps(prog, ref)
        out['best_loss'] = compare.rel(prog['best_loss'], ref['best_loss'])
        out['best_change'], _ = compare.worst_leaf(
            prog['best_change'], ref['best_change'],
            compare.moving(ref['g1']))
        d = (prog['div'] - ref['div']).abs() / ref['div'].abs()
        out['recalib'] = float(d.max())
        return out
