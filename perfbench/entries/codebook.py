"""Entry ``codebook``: the program's NeRF trainer (``MultiviewTrainer``,
built by ``apps/train_nerf.build_trainer``) with VQAD's grid, the
CodebookOctreeGrid, on in-memory views.

Set-up builds one trainer with the benchmark's VQAD weights
(``harness/vqad.py``) and warms it through ``warmup_steps`` steps in
blocks of ``block_steps``.  Its first ``check_steps`` steps and the first
step of the second block are recorded on the way: the recorder wraps the
trainer's own ``step`` (VQAD's settings prune nothing) and changes
nothing it does.  The window runs whole blocks through the trainer's
``train``.

From these weights on the ``object`` mix the relu density is zero
everywhere by step 15-24 on every seed tried, and from then on every
gradient is zero.  So
each block of the window and of the traced run starts the training
again: the weights copied back from the seed's, Adam's moments zeroed and
its count 0, in place, inside the block's time.  Every measured step is
one of the first ``block_steps`` of a training run, while the field is
alive; :meth:`Cell.free` refuses a run whose field has died.
"""
from __future__ import annotations

import time

import torch

from perfbench.harness import compare, program, traffic, vqad, weights
from perfbench.reference import common as C
from perfbench.reference.nerf import ray_batches
from perfbench.reference.vqad import VqadReference


class Recorder(program.Recorder):
    """Also keeps the step ``after`` with the state it starts from."""
    DRAWS = ('march_u',)

    def __init__(self, trainer, p0: dict, steps: int, after: int):
        super().__init__(trainer, p0, steps)
        self.after = after

    def step(self, rays_o, rays_d, gt, draws, **kw):
        self.calls += 1
        it, tr = self.calls, self.tr
        if it <= self.steps or it == self.after:
            self.keep_draws(it, draws)
        if it == self.after:
            self.before = {'params': program.clone(tr.params),
                           'mu': program.clone(tr.opt_state['mu']),
                           'nu': program.clone(tr.opt_state['nu']),
                           'count': tr.opt_state['count']}
        out = self.orig['step'](rays_o, rays_d, gt, draws, **kw)
        self.stepped(it, out)
        if it == self.after:
            self.loss_after = out['loss'].detach().clone()
            self.change_after = program.diff_norms(tr.params,
                                                   self.before['params'])
        return out

    def outputs(self) -> dict:
        return dict(super().outputs(), loss_after=float(self.loss_after),
                    change_after=program.floats(self.change_after))

    def to_host(self):
        super().to_host()
        self.before = {k: program.to(v, 'cpu') if k != 'count' else v
                       for k, v in self.before.items()}


class Cell(program.TrainerCell):
    throughput = 'nerf_rays_per_s'
    restarting = False      # set once set-up has recorded its steps

    # -- set-up -------------------------------------------------------------
    def setup(self, only_checks: bool = False):
        """``TrainerCell.setup`` with VQAD's weights (the shared weights
        module draws SHACIRA's tree)."""
        t0 = time.perf_counter()
        import shacira_tpu_torch  # noqa: F401
        self.inputs = traffic.make(self.root, self.mix, self.seed,
                                   self.device)
        t1 = time.perf_counter()
        tr = self.build()
        p0 = vqad.make(self.s, self.seed * 2 + 1, self.device)
        if not weights.same_layout(p0, tr.params):
            raise RuntimeError('the program\'s parameter tree is not the '
                               'configuration\'s')
        self.p0 = program.to(p0, 'cpu')
        tr.set_params(p0)
        t2 = time.perf_counter()
        rec = self.recorder(tr, program.to(self.p0, self.device))
        last = self.checked_steps() if only_checks \
            else self.h['warmup_steps']
        done = 0
        while done < last:
            n = min(self.h['block_steps'], last - done)
            self.train(tr, n)
            done += n
        rec.detach()
        rec.to_host()
        self.tr, self.rec = tr, rec
        self.start = program.to(self.p0, self.device)
        self.restart(tr)
        self.restarting = True
        if self.device == 'cuda':
            torch.cuda.synchronize()
        self.phases = {'inputs': t1 - t0, 'trainer': t2 - t1,
                       'warm-up': time.perf_counter() - t2}

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
        """Through the first step of the second block."""
        return self.h['block_steps'] + 1

    def train(self, tr, n: int):
        """``n`` steps of the trainer's ``train``; once set-up is done,
        from the start."""
        if self.restarting:
            self.restart(tr)
        tr.train(num_iterations=n)

    def restart(self, tr):
        """The trainer back at the start: the seed's weights, Adam's
        moments zero and its count 0."""
        with torch.no_grad():
            for (_, p), (_, p0) in zip(C.leaves(tr.params),
                                       C.leaves(self.start)):
                p.copy_(p0)
            for m in ('mu', 'nu'):
                for _, t in C.leaves(tr.opt_state[m]):
                    t.zero_()
        tr.opt_state['count'] = 0

    def live_share(self) -> float:
        """Share of 65,536 points drawn uniformly in the octree's cube at
        which the program's field has a positive density (training
        mode)."""
        from shacira_tpu_torch.models.nefs import nerf
        tr = self.tr
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.pseed)
        pts = torch.rand((1 << 16, 3), generator=gen,
                         device=self.device) * 2 - 1
        with torch.no_grad():
            d = nerf.nerf_density(tr.params, tr.model_cfg, pts,
                                  structure=tr.structure_tables,
                                  training=True)
        return float((d > 0).float().mean())

    def free(self):
        """Refuses a field that has died: its steps are not this cell's
        (a dead field's gradients are all zero)."""
        live = self.live_share()
        if live < 0.5:
            raise RuntimeError(f'the field has died: its density is '
                               f'positive at {live:.3f} of the cube')
        self.start = None
        super().free()

    # -- timed and traced blocks ---------------------------------------------
    def rate(self, steps: int, seconds: float) -> float:
        return self.tr.num_rays * steps / seconds

    def work(self, before, n: int) -> dict:
        """Per-step work: every march sample goes through the field (no
        budget), so it is counted from the shapes alone."""
        s = self.s
        samples = int(s['num_rays_sampled_per_img']) * int(s['num_steps'])
        return {'samples': samples,
                'corner_rows': vqad.corner_rows(s, samples),
                'b1_bound_ms': vqad.b1_bound_s(s, samples) * 1e3,
                'gather_bound_ms': vqad.gather_bound_s(s, samples) * 1e3,
                'flops_per_step': vqad.step_flops(s, samples)}

    # -- correctness --------------------------------------------------------
    def reference(self, dtype=torch.float32, half: bool = False,
                  frozen: tuple = None) -> dict:
        """The reference's numbers (``dtype`` below float32, ``half`` or
        ``frozen``: the control or a planted fault in the program's
        place)."""
        s, v, rec, dev = self.s, self.views, self.rec, self.device
        ref = VqadReference(s, v.dist_min, v.dist_max)
        R = int(s['num_rays_sampled_per_img'])
        after = self.checked_steps()
        batches = ray_batches(self.pseed, after, v.num_views,
                              v.rgb.shape[1], R)

        def batch(it):
            view, idx = batches[it - 1]
            return [torch.as_tensor(a[view, idx], device=dev)
                    for a in (v.rays_o, v.rays_d, v.rgb)]

        def step(state, it):
            return ref.step(state, *batch(it),
                            program.to(rec.draws[it], dev), dtype, half,
                            frozen)

        p0 = program.to(self.p0, dev)
        state = dict(C.zero_moments(p0), params=p0)
        out = {'loss': {}}
        for it in range(1, self.h['check_steps'] + 1):
            r = step(state, it)
            out['loss'][it] = r['loss']
            if it == 1:
                out['g1'] = program.flat_norms(r['opt_grads'])
            state = r['state']
        out['change'] = program.floats(program.diff_norms(state['params'],
                                                          p0))
        del state, r
        b = rec.before
        before = {'params': program.to(b['params'], dev),
                  'mu': program.to(b['mu'], dev),
                  'nu': program.to(b['nu'], dev), 'count': b['count']}
        r = step(before, after)
        out['loss_after'] = r['loss']
        out['g_after'] = program.flat_norms(r['opt_grads'])
        out['change_after'] = program.floats(program.diff_norms(
            r['state']['params'], before['params']))
        return out

    @staticmethod
    def readings(prog: dict, ref: dict) -> dict:
        """The numbers compared, of ``prog`` against the reference.  The
        logits tables' gradients are ~1e-4 of the median leaf's, under
        what ``grad`` and ``change`` weigh (Adam moves them by its rate
        all the same), so the grid's tables are also held each to its own
        norm (``table_grad``, ``table_change``) and kept in
        ``change_after_block``."""
        out = program.first_steps(prog, ref)
        tables = [p for p in ref['g1'] if p[0] == 'grid']
        for name, key in (('table_grad', 'g1'), ('table_change', 'change')):
            out[name] = max(compare.rel(prog[key][p], ref[key][p])
                            for p in tables)
        out['loss_after_block'] = compare.rel(prog['loss_after'],
                                              ref['loss_after'])
        keep = set(compare.moving(ref['g_after'])) | set(tables)
        out['change_after_block'], _ = compare.worst_leaf(
            prog['change_after'], ref['change_after'], sorted(keep))
        return out
