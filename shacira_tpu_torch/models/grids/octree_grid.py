"""OctreeGrid (NGLOD) and CodebookOctreeGrid (VQAD).

Port of ``shacira_tpu/models/grids/octree_grid.py``: features live on the
corners of the occupied cells of a sparse octree (the dual octree and its
trinkets, ``ops/spc.py``); VQAD stores per corner softmax logits over a
learned per-LOD dictionary instead of raw features (a straight-through
one-hot mix while training, an argmax lookup in eval mode).

The structure (sorted morton codes, trinkets) is built once with torch on
the device it is asked for and stays fixed; only the feature tables are
parameters.  Every LOD's cells, morton search, corner rows and trilinear
weights come from ONE :func:`ops.spc.octree_corners`, on the card one
launch of kernel Q1.  Every LOD's corner rows are gathered with ONE
:func:`ops.scatter.gather_rows`, whose forward is one launch of kernel R1
and whose backward is one launch of kernel B1 over the tables of all
LODs.

VQAD's training mix and blend (softmax, argmax, straight-through keys,
dictionary product and the corners' sum) is :func:`ops.codebook.
codebook_mix`: on the card one launch of kernel M1 over every LOD forward
and one of M1(b) backward.

Spans (``record_function``, inside the field's ``field/encode``):
``field/octree_query`` (cells, morton search, trinkets and weights; Q1's
launch under the op record ``octree_query_launch``),
``field/gather`` (the corner rows' gather) and, for VQAD,
``field/codebook_mix`` (training: the mix and the blend of every LOD;
eval: each LOD's argmax lookup).  The mix's backward is the range
``backward/codebook_mix`` on autograd's thread.  While a profiler records
a training step, the counter
``field/corner_rows`` (rows gathered) adds host numbers
(``utils/perf.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from shacira_tpu_torch.ops import coding, spc
from shacira_tpu_torch.ops.codebook import codebook_mix
from shacira_tpu_torch.ops.scatter import gather_rows
from shacira_tpu_torch.utils import perf


@dataclass(frozen=True)
class OctreeGridConfig:
    feature_dim: int
    base_lod: int = 2
    num_lods: int = 1
    multiscale_type: str = 'sum'
    feature_std: float = 0.0
    feature_bias: float = 0.0

    @property
    def active_lods(self) -> Tuple[int, ...]:
        return tuple(self.base_lod + i for i in range(self.num_lods))

    @property
    def output_dim(self) -> int:
        return (self.feature_dim * self.num_lods
                if self.multiscale_type == 'cat' else self.feature_dim)


class OctreeStructure:
    """The fixed octree shared by both grid types: per active LOD the
    sorted morton codes of its cells, their trinkets and the number of
    corners, on the octree's device."""

    def __init__(self, octree: spc.Octree, active_lods):
        self.octree = octree
        self.active_lods = tuple(active_lods)
        self.codes, self.trinkets, self.num_corners = {}, {}, {}
        for lod in self.active_lods:
            corners, trinkets = spc.build_dual(octree, lod)
            self.codes[lod] = octree.level_codes[lod]
            self.trinkets[lod] = trinkets
            self.num_corners[lod] = int(corners.shape[0])

    @classmethod
    def make_dense(cls, cfg: OctreeGridConfig, device='cpu'):
        return cls(spc.Octree.make_dense(cfg.active_lods[-1], device),
                   cfg.active_lods)

    @classmethod
    def from_pointcloud(cls, cfg: OctreeGridConfig, pts, dilate: int = 2,
                        device=None):
        return cls(spc.Octree.from_pointcloud(pts, cfg.active_lods[-1],
                                              dilate=dilate, device=device),
                   cfg.active_lods)

    @classmethod
    def from_mesh(cls, cfg: OctreeGridConfig, path_or_arrays,
                  num_samples_on_mesh: int = 100_000, seed: int = 0,
                  dilate: int = 0, device=None):
        """Octree of a triangle mesh (an OBJ path or (verts, faces)):
        ``num_samples_on_mesh`` surface samples of the normalized mesh,
        drawn on the host with the JAX package's draws, quantized at the
        top LOD."""
        from shacira_tpu_torch.ops import mesh as mesh_ops
        if isinstance(path_or_arrays, str):
            verts, faces = mesh_ops.load_obj(path_or_arrays)
        else:
            verts, faces = path_or_arrays
        verts = mesh_ops.normalize_mesh(np.asarray(verts, np.float64))
        rng = np.random.RandomState(seed)
        surf = mesh_ops.sample_surface(rng, verts,
                                       np.asarray(faces, np.int64),
                                       num_samples_on_mesh)
        return cls.from_pointcloud(cfg, np.clip(surf, -1, 1), dilate=dilate,
                                   device=device)

    @classmethod
    def from_spc(cls, cfg: OctreeGridConfig, octree: spc.Octree):
        """Wrap an existing octree (ref OctreeGrid.from_spc)."""
        if octree.max_level < cfg.active_lods[-1]:
            raise ValueError(
                f'octree max_level {octree.max_level} < top active LOD '
                f'{cfg.active_lods[-1]}')
        return cls(octree, cfg.active_lods)

    def tables(self) -> dict:
        """Per-LOD codes and trinkets in ``active_lods`` order."""
        return {'codes': tuple(self.codes[l] for l in self.active_lods),
                'trinkets': tuple(self.trinkets[l] for l in self.active_lods)}


def _as_tables(structure) -> dict:
    """An OctreeStructure or its ``tables()``."""
    return structure.tables() if hasattr(structure, 'tables') else structure


def _normal(generator, shape, std, bias, device):
    return torch.randn(shape, generator=generator, device=device) * std + bias


def octree_grid_init(generator: torch.Generator, cfg: OctreeGridConfig,
                     structure: OctreeStructure, device) -> dict:
    """Per-LOD corner feature tables [corners, F], N(bias, std)."""
    return {'features': [
        _normal(generator, (structure.num_corners[lod], cfg.feature_dim),
                cfg.feature_std, cfg.feature_bias, device)
        for lod in cfg.active_lods]}


def _blend(cf, w, valid):
    """Trilinear sum of corner values [N, 8, F]; zeros outside the
    octree."""
    out = torch.sum(cf * w[..., None], dim=-2)
    return torch.where(valid[..., None], out, 0.0)


def _corners(cfg: OctreeGridConfig, structure, coords):
    """Each LOD's (corner rows, trilinear weights, valid) of the points
    ``coords`` [N, 3]: :func:`spc.octree_corners`, on the card one launch
    of kernel Q1 over every LOD."""
    with record_function('field/octree_query'):
        return spc.octree_corners(coords, _as_tables(structure),
                                  cfg.active_lods)


def _gather(tables, parts):
    """Each LOD's corner rows of its table, in one :func:`gather_rows`."""
    idxs = [p[0] for p in parts]
    with record_function('field/gather'):
        if perf.tracing() and torch.is_grad_enabled():
            perf.count('field/corner_rows', sum(i.numel() for i in idxs))
        return gather_rows(tables, idxs)


def _multiscale(feats, cfg, lead):
    stacked = torch.stack(feats, dim=1)                   # [N, L, F]
    out = (stacked.sum(dim=1) if cfg.multiscale_type == 'sum'
           else stacked.reshape(stacked.shape[0], -1))
    return out.reshape(*lead, out.shape[-1])


def interpolate(params: dict, cfg: OctreeGridConfig, structure,
                coords: torch.Tensor) -> torch.Tensor:
    """coords [..., 3] -> [..., output_dim]; ``structure`` an
    OctreeStructure or its ``tables()``."""
    lead = coords.shape[:-1]
    c = coords.reshape(-1, 3)
    parts = _corners(cfg, structure, c)
    cfs = _gather(params['features'], parts)
    return _multiscale([_blend(cf, w, v) for cf, (_, w, v)
                        in zip(cfs, parts)], cfg, lead)


def grid_size_bits(params: dict) -> int:
    return sum(int(f.numel()) * 32 for f in params['features'])


# ---------------------------------------------------------------------------
# VQAD: CodebookOctreeGrid
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CodebookOctreeGridConfig(OctreeGridConfig):
    codebook_bitwidth: int = 4

    @property
    def dictionary_size(self) -> int:
        return 2 ** self.codebook_bitwidth


def codebook_grid_init(generator: torch.Generator,
                       cfg: CodebookOctreeGridConfig,
                       structure: OctreeStructure, device) -> dict:
    """Per LOD: corner logits [corners, D], N(0, std), and a dictionary
    [D, F], N(bias, std)."""
    logits, dicts = [], []
    for lod in cfg.active_lods:
        logits.append(_normal(generator, (structure.num_corners[lod],
                                          cfg.dictionary_size),
                              cfg.feature_std, 0.0, device))
        dicts.append(_normal(generator, (cfg.dictionary_size,
                                         cfg.feature_dim),
                             cfg.feature_std, cfg.feature_bias, device))
    return {'logits': logits, 'dictionary': dicts}


def _codebook_lookup(l: torch.Tensor, dictionary: torch.Tensor
                     ) -> torch.Tensor:
    """Eval mode: the dictionary entries of gathered logits [..., D] at
    their argmax (the first maximum, as in training)."""
    with record_function('field/codebook_mix'):
        return dictionary[torch.argmax(l, dim=-1)]


def codebook_interpolate(params: dict, cfg: CodebookOctreeGridConfig,
                         structure, coords: torch.Tensor, *,
                         training: bool = True) -> torch.Tensor:
    """coords [..., 3] -> [..., output_dim]: training mixes the dictionary
    with the straight-through softmax (:func:`codebook_mix`, the blend
    included); eval looks the argmax up."""
    lead = coords.shape[:-1]
    c = coords.reshape(-1, 3)
    parts = _corners(cfg, structure, c)
    logits = _gather(params['logits'], parts)
    if training:
        with record_function('field/codebook_mix'):
            feats = codebook_mix(logits, params['dictionary'],
                                 [w for _, w, _ in parts],
                                 [v for _, _, v in parts])
    else:
        feats = [_blend(_codebook_lookup(l, dictionary), w, v)
                 for l, dictionary, (_, w, v)
                 in zip(logits, params['dictionary'], parts)]
    return _multiscale(feats, cfg, lead)


def codebook_indices(params: dict) -> list:
    """Each LOD's argmax dictionary index per corner, int32 on the host."""
    return [torch.argmax(l.detach(), dim=-1).to(torch.int32).cpu().numpy()
            for l in params['logits']]


def codebook_grid_size_bits(params: dict, use_codec: bool = False):
    """(0, dictionary f32 bits + entropy-coded argmax indices): the
    histogram estimate, or with ``use_codec`` real arithmetic codestreams."""
    dict_bits = sum(int(d.numel()) * 32 for d in params['dictionary'])
    index_bits = 0.0
    for assign in codebook_indices(params):
        index_bits += (coding.coded_size_bits(assign) if use_codec
                       else coding.entropy_bits_histogram(assign))
    return 0.0, index_bits + dict_bits

