"""VQAD's (the CodebookOctreeGrid's) side of the harness: its initial
weights from the seed, and the work a step needs, counted from the
configuration's widths and the step's shapes (never from what the program
happened to launch).

The octree is dense over the active LODs (the program's default where the
data carries no point cloud), so LOD ``l`` has ``(2^l + 1)^3`` corners.
The tree: ``grid`` (per LOD the corner ``logits`` [corners, D] and a
``dictionary`` [D, F]) and the NeRF's MLP heads.  The draws follow the
settings: logits normal at ``feature_std``, dictionaries normal at
``feature_std`` around ``feature_bias``, each MLP layer uniform in
+-1/sqrt(fan-in), the first density output's bias 1.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from perfbench.harness import roofline
from perfbench.reference import common as C


def lods(s: dict) -> Tuple[int, ...]:
    return tuple(range(s['base_lod'], s['base_lod'] + s['num_lods']))


def dictionary_size(s: dict) -> int:
    return 2 ** s['codebook_bitwidth']


def corners(lod: int) -> int:
    """Corners of the dense octree at ``lod``: the whole lattice."""
    return (2 ** lod + 1) ** 3


def table_rows(s: dict) -> int:
    return sum(corners(l) for l in lods(s))


def _mlp_dims(din: int, hidden: int, layers: int, dout: int):
    return [(din, hidden)] + [(hidden, hidden)] * (layers - 1) + \
        [(hidden, dout)]


def head_dims(s: dict) -> dict:
    """(fan-in, fan-out) of each layer of the density and colour MLPs."""
    f = s['feature_dim'] * (s['num_lods'] if s['multiscale_type'] == 'cat'
                            else 1)
    view = 3 + 6 * s['view_multires']
    return {'decoder_density': _mlp_dims(f, s['hidden_dim'],
                                         s['num_layers'], 16),
            'decoder_color': _mlp_dims(16 + view, s['hidden_dim'],
                                       s['num_layers'] + 1, 3)}


def _slices(flat: torch.Tensor, shapes):
    """Consecutive slices of ``flat`` in the given shapes."""
    a = 0
    for shape in shapes:
        n = int(np.prod(shape))
        yield flat[a:a + n].reshape(shape)
        a += n


def make(s: dict, seed: int, device) -> dict:
    """The initial parameter tree for ``seed``: one normal and one uniform
    draw on the device, sliced."""
    D, F, L = dictionary_size(s), s['feature_dim'], s['num_lods']
    normal = [(corners(l), D) for l in lods(s)] + [(D, F)] * L
    heads = head_dims(s)
    uniform = [shape for dims in heads.values() for din, dout in dims
               for shape in ((din, dout), (dout,))]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    z = torch.randn(sum(int(np.prod(sh)) for sh in normal), generator=gen,
                    device=device)
    u = torch.rand(sum(int(np.prod(sh)) for sh in uniform), generator=gen,
                   device=device)
    drawn = [t * s['feature_std'] for t in _slices(z, normal)]
    tree = {'grid': {'logits': drawn[:L],
                     'dictionary': [t + s['feature_bias']
                                    for t in drawn[L:]]}}
    flat = _slices(u, uniform)
    for name, dims in heads.items():
        tree[name] = {'layers': [
            {key: (next(flat) * 2 - 1) * (1.0 / np.sqrt(din))
             for key in ('w', 'b')} for din, _ in dims]}
    tree['decoder_density']['layers'][-1]['b'][0] = 1.0
    return C.tree_map(lambda t: t.contiguous(), tree)


# ---------------------------------------------------------------------------
# the work of a step on ``samples`` field samples
# ---------------------------------------------------------------------------

def corner_rows(s: dict, samples: int) -> int:
    """Logit rows the step gathers: 8 corners a sample and LOD."""
    return samples * s['num_lods'] * 8


def gather_bound_s(s: dict, samples: int) -> float:
    """Least time of the logits gather: every gathered float32 row of D
    written once and its int32 index read once, at the HBM peak (the
    table's reads, at most the table once, are left out)."""
    rows = corner_rows(s, samples)
    byts = rows * dictionary_size(s) * 4 + rows * 4
    return byts / roofline.HBM_BYTES_PER_S


def b1_bound_s(s: dict, samples: int) -> float:
    """Least time of kernel B1 in the gather's backward, as
    ``roofline.scatter_bound_s`` counts it for every cell: every corner
    row's index and D-wide gradient read once and the logits tables of
    every LOD written once, at the HBM peak."""
    return roofline.scatter_bound_s(corner_rows(s, samples),
                                    dictionary_size(s), table_rows(s))


def mix_flops(d: int, f: int) -> int:
    """Forward and backward FLOPs of one corner's codebook mix and blend:
    the softmax over D (about 5 a logit), the straight-through keys (2 a
    logit), the dictionary product (2 D F) and the blend (2 F); the
    backward twice the products and the blend and the softmax's (about 4
    a logit)."""
    fwd = 5 * d + 2 * d + 2 * d * f + 2 * f
    bwd = 4 * d * f + 4 * f + 4 * d
    return fwd + bwd


def step_flops(s: dict, samples: int) -> int:
    """FLOPs of one step on ``samples`` field samples: per LOD the corner
    weights (3 products each) and 8 corners' mix, the density and colour
    MLPs (forward and twice again for the backward), the volume
    integration (about 20 a sample), and Adam (about 12 a parameter) over
    the tables, the dictionaries and the heads."""
    D, F = dictionary_size(s), s['feature_dim']
    grid = s['num_lods'] * (8 * 3 + 8 * mix_flops(D, F))
    head = 3 * 2 * sum(roofline.mlp_macs(d) for d in head_dims(s).values())
    params = (table_rows(s) * D + s['num_lods'] * D * F
              + sum(a * b + b for d in head_dims(s).values() for a, b in d))
    return samples * (grid + head + 20) + 12 * params
