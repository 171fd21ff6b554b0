"""Initial weights from the seed, on the device, in a few large draws.

The tree is SHACIRA's: ``grid`` (the latent ``codebook``, the single
affine ``latent_dec`` with its ``div``, the bit estimator ``prob_model``)
and the MLP heads (``decoder_density`` and ``decoder_color`` of a NeRF,
``decoder_color`` of an image).  The draws follow the configuration: the
codebook normal or uniform at ``feature_std`` around ``feature_bias``,
the decode matrix normal at ``ldec_std``, the bit estimator normal at
0.01, each MLP layer uniform in +-1/sqrt(fan-in), a NeRF's first density
output biased to 1.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import common as C


def _mlp_dims(din: int, hidden: int, layers: int, dout: int):
    return [(din, hidden)] + [(hidden, hidden)] * (layers - 1) + \
        [(hidden, dout)]


def shapes(settings: dict, kind: str) -> dict:
    """{'normal': [(path, shape, std)], 'uniform': [(path, shape, bound)],
    'fixed': [(path, shape, value)]} of the configuration's tree."""
    s = settings
    dim = 3 if kind == 'nerf' else 2
    grid = C.Grid(C.geometric_resolutions(s['min_grid_res'],
                                          s['max_grid_res'], s['num_lods']),
                  s['codebook_bitwidth'], dim)
    ld = s['latent_dim'] or s['feature_dim']
    f = s['feature_dim']
    normal, uniform, fixed = [], [], []
    cb = ('grid', 'codebook')
    if s['init_grid'] == 'normal':
        normal.append((cb, (grid.rows, ld), s['feature_std']))
    else:
        uniform.append((cb, (grid.rows, ld), s['feature_std']))
    normal.append((('grid', 'latent_dec', 'layers', 0, 'scale'), (ld, f),
                   s['ldec_std']))
    if s['use_shift']:
        fixed.append((('grid', 'latent_dec', 'layers', 0, 'shift'), (1, f),
                      0.0))
    fixed.append((('grid', 'latent_dec', 'div'), (ld,), 1.0))
    for i in range(1, 5):
        keys = ('h', 'b', 'a') if i < 4 else ('h', 'b')
        for k in keys:
            normal.append((('grid', 'prob_model', f'f{i}', k), (1, ld), 0.01))
    heads = {}
    feats = f * s['num_lods']
    if kind == 'nerf':
        view = 3 + 6 * s['view_multires']
        heads['decoder_density'] = _mlp_dims(feats, s['hidden_dim'],
                                             s['num_layers'], 16)
        heads['decoder_color'] = _mlp_dims(16 + view, s['hidden_dim'],
                                           s['num_layers'] + 1, 3)
    else:
        heads['decoder_color'] = _mlp_dims(feats, s['hidden_dim'],
                                           s['num_layers'], 3)
    for name, dims in heads.items():
        for i, (din, dout) in enumerate(dims):
            k = 1.0 / np.sqrt(din)
            uniform.append(((name, 'layers', i, 'w'), (din, dout), k))
            uniform.append(((name, 'layers', i, 'b'), (dout,), k))
    return {'normal': normal, 'uniform': uniform, 'fixed': fixed}


def _put(tree: dict, path: tuple, value):
    node = tree
    for a, b in zip(path[:-1], path[1:]):
        if isinstance(b, int):
            node = node.setdefault(a, [])
            while len(node) <= b:
                node.append({})
        elif isinstance(node, list):
            node = node[a]
        else:
            node = node.setdefault(a, {})
    last = path[-1]
    node[last] = value


def make(settings: dict, kind: str, seed: int, device) -> dict:
    """The initial parameter tree of ``kind`` ('nerf' or 'image') for
    ``seed``: one normal and one uniform draw on the device, sliced."""
    sh = shapes(settings, kind)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_norm = sum(int(np.prod(s)) for _, s, _ in sh['normal'])
    n_unif = sum(int(np.prod(s)) for _, s, _ in sh['uniform'])
    z = torch.randn(n_norm, generator=gen, device=device)
    u = torch.rand(n_unif, generator=gen, device=device)
    tree, a = {}, 0
    for path, s, std in sh['normal']:
        n = int(np.prod(s))
        _put(tree, path, z[a:a + n].reshape(s) * std)
        a += n
    a = 0
    for path, s, k in sh['uniform']:
        n = int(np.prod(s))
        _put(tree, path, (u[a:a + n].reshape(s) * 2 - 1) * k)
        a += n
    for path, s, v in sh['fixed']:
        _put(tree, path, torch.full(s, v, device=device))
    grid = tree['grid']
    grid['codebook'] = grid['codebook'] + settings['feature_bias']
    if kind == 'nerf':
        tree['decoder_density']['layers'][-1]['b'][0] = 1.0
    return C.tree_map(lambda t: t.contiguous(), tree)


def same_layout(a: dict, b: dict) -> bool:
    """Both trees have the same leaf paths, shapes and dtypes."""
    la, lb = list(C.leaves(a)), list(C.leaves(b))
    return len(la) == len(lb) and all(
        pa == pb and ta.shape == tb.shape and ta.dtype == tb.dtype
        for (pa, ta), (pb, tb) in zip(la, lb))
