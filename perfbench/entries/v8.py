"""Entry ``v8``: the program's NeRF trainer (``MultiviewTrainer``, built by
``apps/train_nerf.build_trainer``) in SHACIRA's V8 configuration on a
scene in RTMV's layout (the ``rtmv_scene`` kind, read by the program's
RTMV loader): the occupancy seeded from the scene's depth point cloud, the
``'voxel'`` march through the DDA (kernel V1 on the card), every crossing
slot through the field and the dense integration, a prune every 100 steps.

Set-up, the timed and traced blocks, the recorder (the first
``check_steps`` steps, the first prune and the step after it) and the
numbers compared are the ``nerf`` entry's.  Here the views carry the
point cloud, the reference is ``reference/voxel.py``, which seeds its own
occupancy from the cloud and walks its own DDA, and the work is counted
from the dense march's shapes (``harness/voxel.py``).

Set-up refuses a scene in which a ray the comparison reads has a direction
component in (-1e-9, 0]: the program's walk, as the JAX package's, stops
advancing on such a ray and the reference's does not.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from perfbench.harness import bench, program, voxel
from perfbench.reference import common as C
from perfbench.reference.nerf import ray_batches
from perfbench.reference.voxel import FAULTS, TINY, VoxelReference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
nerf = bench.entry(ROOT, 'nerf')


def stalling(dirs: np.ndarray) -> int:
    """Rays among ``dirs`` [..., 3] with a component in (-1e-9, 0]."""
    d = np.asarray(dirs)
    return int(((d > -TINY) & (d <= 0)).any(-1).sum())


class Cell(nerf.Cell):
    FAULTS = FAULTS

    # -- set-up -------------------------------------------------------------
    def build(self):
        from shacira_tpu_torch import config as cfg_mod
        from shacira_tpu_torch.apps import train_nerf
        v = self.views = self.inputs
        R = int(self.s['num_rays_sampled_per_img'])
        after = self.checked_steps()
        batches = ray_batches(self.pseed, after, v.num_views,
                              v.rgb.shape[1], R)
        for it in (*range(1, self.h['check_steps'] + 1), after):
            view, idx = batches[it - 1]
            n = stalling(v.rays_d[view, idx])
            if n:
                raise RuntimeError(f'{n} ray(s) of view {view} that the '
                                   'comparison reads have a direction '
                                   'component in (-1e-9, 0]')
        args = program.parse(cfg_mod.build_nerf_parser(), self.s, self.pseed,
                             self.device)
        return train_nerf.build_trainer(args, v)

    # -- timed and traced blocks ---------------------------------------------
    def before_trace(self):
        return None

    def work(self, before, n: int) -> dict:
        """Per-step work of the dense march, from its shapes."""
        s = self.s
        return {'samples': voxel.samples(s),
                'crossing_slots': voxel.crossing_slots(s),
                'b1_bound_ms': voxel.b1_bound_s(s) * 1e3,
                'dda_bound_ms': voxel.dda_bound_s(s) * 1e3,
                'flops_per_step': voxel.step_flops(s)}

    # -- correctness --------------------------------------------------------
    def reference(self, dtype=torch.float32, half: bool = False,
                  fault: str = None) -> dict:
        """The reference's numbers (``dtype`` below float32, ``half`` or a
        planted ``fault``: the control or a fault in the program's
        place)."""
        s, v, rec, dev = self.s, self.views, self.rec, self.device
        ref = VoxelReference(s, v.dist_min, v.dist_max, v.num_views, fault)
        R = int(s['num_rays_sampled_per_img'])
        after = self.checked_steps()
        batches = ray_batches(self.pseed, after, v.num_views,
                              v.rgb.shape[1], R)

        def step(state, occ, it):
            view, idx = batches[it - 1]
            rays = [torch.as_tensor(a[view, idx], device=dev)
                    for a in (v.rays_o, v.rays_d, v.rgb)]
            return ref.step(state, occ, *rays,
                            program.to(rec.draws[it], dev), it, dtype, half)

        p0 = program.to(self.p0, dev)
        state = dict(C.zero_moments(p0), params=p0)
        occ = ref.occupancy(v.pointcloud, dev)
        out = {'loss': {}}
        for it in range(1, self.h['check_steps'] + 1):
            r = step(state, occ, it)
            out['loss'][it] = r['loss']
            if it == 1:
                out['g1'] = program.flat_norms(r['opt_grads'])
            state = r['state']
        out['change'] = program.floats(program.diff_norms(state['params'],
                                                          p0))
        del state, r
        p = rec.pruned
        _, density = ref.prune(program.to(p['params'], dev),
                               p['density'].to(dev), p['occ'].to(dev),
                               p['u'].to(dev), dtype)
        out['density_after'] = density.float().cpu()
        b = rec.before
        before = {'params': program.to(b['params'], dev),
                  'mu': program.to(b['mu'], dev),
                  'nu': program.to(b['nu'], dev), 'count': b['count']}
        r = step(before, b['occ'].to(dev), after)
        out['loss_after'] = r['loss']
        out['g_after'] = program.flat_norms(r['opt_grads'])
        out['change_after'] = program.floats(program.diff_norms(
            r['state']['params'], before['params']))
        return out
