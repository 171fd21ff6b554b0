"""A benchmark root of tiny cells for the CPU tests: the repository's
entries, traffic kinds and mixes and metric readers, with configurations,
traffic mixes, limits and cells added as new files and entries only."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

TINY_NERF = dict(num_lods=4, min_grid_res=4, max_grid_res=16,
                 codebook_bitwidth=10, hidden_dim=16, num_steps=64,
                 max_samples=2048, num_rays_sampled_per_img=256,
                 prune_every=4, blas_level=4, epochs=10)
TINY_IMAGE = dict(num_lods=4, min_grid_res=4, max_grid_res=16,
                  codebook_bitwidth=8, hidden_dim=8, epochs=200)
TINY_OBJECT = dict(kind='multiview_object', views=4, res=16,
                   camera_angle_x=0.6911112070083618, radius=3.2,
                   elevation=[0.35, 0.8], aabb_scale=3.2, dist=[0.0, 6.0],
                   render_batch=2)
TINY_PHOTO = dict(kind='photo', h=16, w=24)
LOOSE = 1e9     # limits of a run that only has to finish
# the image cells' metrics, which the repository's cells do not report:
# the end-to-end rate and the image's share of the readers
IMAGE_RATE = dict(name='image_pix_per_s', unit='Mpix/s', better='higher',
                  bound=0.25, source='host_clock', workloads=[])
IMAGE_LAYERS = ('device_ops_per_step', 'encode_ms', 'codec_ms',
                'backward_ms', 'adam_ms', 'b1_roofline', 'idle_share', 'mfu')
NUMBERS = {'lego': ('loss', 'grad', 'change', 'prune', 'loss_after_prune',
                    'change_after_prune'),
           'kodak': ('loss', 'grad', 'change', 'best_loss', 'best_change',
                     'recalib')}


def _json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1)


def make_root(tmp: str, limits: dict = None) -> str:
    """A root with cells ``lego.tiny`` and ``kodak.tiny`` beside the
    repository's own."""
    root = os.path.join(tmp, 'root')
    for d in ('entries', 'metrics', 'traffic'):
        shutil.copytree(os.path.join(REPO, 'perfbench', d),
                        os.path.join(root, 'perfbench', d))
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    bench['end_to_end'].append(dict(IMAGE_RATE, workloads=['kodak.tiny']))
    for m in list(bench['per_layer']):
        base, part = m['name'].split('.')
        if part == 'nerf' and base in IMAGE_LAYERS:
            bench['per_layer'].append(dict(
                m, name=base + '.image', moves='image_pix_per_s',
                workloads=['kodak.tiny']))
    for name, base, over, harness, mix, mixdef, like in (
            ('lego_tiny', 'lego', TINY_NERF,
             dict(block_steps=4, warmup_steps=8, check_steps=3,
                  trace_steps=2), 'tiny_object', TINY_OBJECT,
             'lego.object'),
            ('kodak_tiny', 'kodak', TINY_IMAGE,
             dict(block_steps=10, warmup_steps=20, check_steps=3,
                  trace_steps=2), 'tiny_photo', TINY_PHOTO,
             None)):       # the image metrics above list kodak.tiny
        with open(os.path.join(REPO, 'perfbench', 'configs',
                               base + '.json')) as f:
            cfg = json.load(f)
        cfg['name'] = name
        cfg['settings'].update(over)
        cfg['harness'] = harness
        cfg['reduced'] = sorted(over)
        _json(os.path.join(root, 'perfbench', 'configs', name + '.json'), cfg)
        _json(os.path.join(root, 'perfbench', 'traffic', mix + '.json'),
              mixdef)
        cell = base + '.tiny'
        lim = (limits or {}).get(cell) or {k: LOOSE for k in NUMBERS[base]}
        _json(os.path.join(root, 'perfbench', 'limits', cell + '.json'),
              {'limits': lim})
        bench['configs'].append(dict(
            name=name, source='test', file=f'perfbench/configs/{name}.json',
            reduced=sorted(over), why='tiny'))
        bench['workloads'].append(dict(name=cell, config=name, traffic=mix,
                                       chips=1, why='tiny'))
        for m in bench['end_to_end'] + bench['per_layer']:
            if like in m.get('workloads', ()):
                m['workloads'].append(cell)
    _json(os.path.join(root, 'BENCHMARK.json'), bench)
    return root
