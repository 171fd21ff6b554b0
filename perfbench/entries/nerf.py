"""Entry ``nerf``: the program's NeRF trainer (``MultiviewTrainer``, built
by ``apps/train_nerf.build_trainer``) on in-memory views.

Set-up builds one trainer with the benchmark's weights and warms it
through ``warmup_steps`` steps in blocks of ``block_steps`` (a block ends
at the prune).  Its first ``check_steps`` steps, its first prune and the
step after it are recorded on the way: the recorder wraps the trainer's
own ``step`` and ``prune`` and changes nothing they do (the prune's cell
jitter is drawn as the trainer draws it, then passed in).  The window
runs whole blocks through the trainer's ``train``.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from perfbench.harness import program, roofline
from perfbench.reference import common as C
from perfbench.reference.nerf import NerfReference, live_samples, ray_batches


class Recorder(program.Recorder):
    """Also wraps the trainer's ``prune``, and keeps the first prune and
    the step ``after`` it with the state that step starts from."""
    WRAPS = ('step', 'prune')
    DRAWS = ('march_u', 'sga_u', 'noise')

    def __init__(self, trainer, p0: dict, steps: int, after: int):
        super().__init__(trainer, p0, steps)
        self.after = after
        self.pruned = None

    def step(self, rays_o, rays_d, gt, draws, **kw):
        self.calls += 1
        it, tr = self.calls, self.tr
        if it <= self.steps or it == self.after:
            self.keep_draws(it, draws)
        if it == self.after:
            self.before = {'params': program.clone(tr.params),
                           'mu': program.clone(tr.opt_state['mu']),
                           'nu': program.clone(tr.opt_state['nu']),
                           'count': tr.opt_state['count'],
                           'occ': tr.occ_state['occ'].clone()}
        out = self.orig['step'](rays_o, rays_d, gt, draws, **kw)
        self.stepped(it, out)
        if it == self.after:
            self.loss_after = out['loss'].detach().clone()
            self.change_after = program.diff_norms(tr.params,
                                                   self.before['params'])
        return out

    def prune(self, u=None):
        tr = self.tr
        if self.pruned is not None or u is not None:
            return self.orig['prune'](u)
        u = torch.rand((tr.model_cfg.occ_cfg.num_cells, 3),
                       generator=tr.generator, device=tr.device)
        self.pruned = {'params': program.clone(tr.params), 'u': u.clone(),
                       'density': tr.occ_state['density'].clone(),
                       'occ': tr.occ_state['occ'].clone()}
        self.orig['prune'](u)
        self.pruned['density_after'] = tr.occ_state['density'].clone()

    def outputs(self) -> dict:
        return dict(super().outputs(), loss_after=float(self.loss_after),
                    change_after=program.floats(self.change_after),
                    density_after=self.pruned['density_after'].cpu())

    def to_host(self):
        super().to_host()
        cpu = lambda t: program.to(t, 'cpu')
        self.before = {k: cpu(v) if k != 'count' else v
                       for k, v in self.before.items()}
        self.pruned = cpu(self.pruned)


class Cell(program.TrainerCell):
    FAMILY = 'nerf'
    throughput = 'nerf_rays_per_s'

    # -- set-up -------------------------------------------------------------
    def build(self):
        from shacira_tpu_torch import config as cfg_mod
        from shacira_tpu_torch.apps import train_nerf
        from shacira_tpu_torch.datasets.nerf_synthetic import MultiviewData
        v = self.views = self.inputs
        data = MultiviewData(rgb=v.rgb, rays_o=v.rays_o, rays_d=v.rays_d,
                             masks=v.masks, h=v.h, w=v.w,
                             dist_min=v.dist_min, dist_max=v.dist_max)
        args = program.parse(cfg_mod.build_nerf_parser(), self.s, self.pseed,
                             self.device)
        return train_nerf.build_trainer(args, data)

    def recorder(self, tr, p0):
        return Recorder(tr, p0, self.h['check_steps'], self.checked_steps())

    def checked_steps(self) -> int:
        """Through the first prune (the end of the first block) and the
        step after it."""
        return self.h['block_steps'] + 1

    @staticmethod
    def train(tr, n: int):
        tr.train(num_iterations=n)

    # -- timed and traced blocks ---------------------------------------------
    def rate(self, steps: int, seconds: float) -> float:
        return self.tr.num_rays * steps / seconds

    def before_trace(self):
        """The ray draws and occupancy grid the traced block starts from."""
        return copy.deepcopy(self.tr.np_rng), self.tr.occ_state['occ'].clone()

    def work(self, before, n: int) -> dict:
        """Per-step work of the ``n`` steps whose ray batches ``before``'s
        generator draws next over its occupancy grid: samples kept under
        the budget, B1's least time, FLOPs."""
        rng, occ = before
        s, v = self.s, self.views
        R = self.tr.num_rays
        kept = []
        for _ in range(n):
            view = rng.randint(v.num_views)
            idx = rng.randint(0, v.rgb.shape[1], size=R)
            o = torch.as_tensor(v.rays_o[view, idx], device=self.device)
            d = torch.as_tensor(v.rays_d[view, idx], device=self.device)
            live = live_samples(occ, o, d, s['num_steps'], v.dist_min,
                                v.dist_max)
            budget = s['max_samples'] or live
            kept.append(min(live, budget))
        kept = float(np.mean(kept))
        table = NerfReference(s, v.dist_min, v.dist_max, v.num_views).grid
        ld = s['latent_dim'] or s['feature_dim']
        b1 = (roofline.scatter_bound_s(int(kept * s['num_lods'] * 8), ld,
                                       table.rows)
              + roofline.scatter_bound_s(int(kept), 5, R))
        return {'samples': kept, 'b1_bound_ms': b1 * 1e3,
                'flops_per_step': roofline.nerf_step_flops(s, table.rows,
                                                           int(kept))}

    # -- correctness --------------------------------------------------------
    def reference(self, dtype=torch.float32, half: bool = False) -> dict:
        """The reference's numbers (``dtype`` below float32 or ``half``:
        the control or a planted fault in the program's place)."""
        s, v, rec, dev = self.s, self.views, self.rec, self.device
        ref = NerfReference(s, v.dist_min, v.dist_max, v.num_views)
        R = int(s['num_rays_sampled_per_img'])
        after = self.h['block_steps'] + 1
        batches = ray_batches(self.pseed, after, v.num_views,
                              v.rgb.shape[1], R)

        def batch(it):
            view, idx = batches[it - 1]
            return [torch.as_tensor(a[view, idx], device=dev)
                    for a in (v.rays_o, v.rays_d, v.rgb)]

        res = ref.res
        state = dict(C.zero_moments(program.to(self.p0, dev)),
                     params=program.to(self.p0, dev))
        occ = torch.ones((res, res, res), dtype=torch.bool, device=dev)
        out = {'loss': {}}
        for it in range(1, self.h['check_steps'] + 1):
            r = ref.step(state, occ, *batch(it),
                         program.to(rec.draws[it], dev), it, dtype, half)
            out['loss'][it] = r['loss']
            if it == 1:
                out['g1'] = program.flat_norms(r['opt_grads'])
            state = r['state']
        out['change'] = program.floats(program.diff_norms(state['params'],
                                                          program.to(self.p0,
                                                                     dev)))
        del state
        p = rec.pruned
        _, density = ref.prune(program.to(p['params'], dev),
                               p['density'].to(dev), p['occ'].to(dev),
                               p['u'].to(dev), dtype)
        out['density_after'] = density.float().cpu()
        b = rec.before
        before = {'params': program.to(b['params'], dev),
                  'mu': program.to(b['mu'], dev),
                  'nu': program.to(b['nu'], dev), 'count': b['count']}
        r = ref.step(before, b['occ'].to(dev), *batch(after),
                     program.to(rec.draws[after], dev), after, dtype, half)
        out['loss_after'] = r['loss']
        out['g_after'] = program.flat_norms(r['opt_grads'])
        out['change_after'] = program.floats(program.diff_norms(
            r['state']['params'], before['params']))
        return out

    @staticmethod
    def readings(prog: dict, ref: dict) -> dict:
        """The numbers compared, of ``prog`` against the reference."""
        from perfbench.harness import compare
        out = program.first_steps(prog, ref)
        # the prune's running density grid, against its largest value
        d_p, d_r = prog['density_after'], ref['density_after']
        out['prune'] = float((d_p - d_r).abs().max()) / max(
            float(d_r.abs().max()), 1e-30)
        out['loss_after_prune'] = compare.rel(prog['loss_after'],
                                              ref['loss_after'])
        out['change_after_prune'], _ = compare.worst_leaf(
            prog['change_after'], ref['change_after'],
            compare.moving(ref['g_after']))
        return out
