"""OctreeGrid (NGLOD) and CodebookOctreeGrid (VQAD).

Port of ``shacira_tpu/models/grids/octree_grid.py``: features live on the
corners of the occupied cells of a sparse octree (the dual octree and its
trinkets, ``ops/spc.py``); VQAD stores per corner softmax logits over a
learned per-LOD dictionary instead of raw features (a straight-through
one-hot mix while training, an argmax lookup in eval mode).

The structure (sorted morton codes, trinkets) is built once with torch on
the device it is asked for and stays fixed; only the feature tables are
parameters.  Every LOD's corner rows are gathered with ONE
:func:`ops.scatter.gather_rows`, whose backward is one launch of kernel B1
over the tables of all LODs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from shacira_tpu_torch.ops import coding, spc
from shacira_tpu_torch.ops.scatter import gather_rows


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


def _lod_corners(codes, trinkets, coords, lod: int):
    """One LOD's corner rows [N, 8] int32, trilinear weights [N, 8] and
    whether each point's cell is in the octree [N]."""
    cells = torch.floor((coords * 0.5 + 0.5) * (2 ** lod)).to(torch.int32)
    cells = torch.clamp(cells, 0, 2 ** lod - 1)
    pidx = spc.query_cells(codes, cells)
    corner_idx = trinkets[torch.clamp(pidx, min=0)]
    return corner_idx, spc.trilinear_coeffs(coords, cells, lod), pidx >= 0


def _blend(cf, w, valid):
    """Trilinear sum of corner values [N, 8, F]; zeros outside the
    octree."""
    out = torch.sum(cf * w[..., None], dim=-2)
    return torch.where(valid[..., None], out, 0.0)


def _corners(cfg: OctreeGridConfig, structure, coords):
    tables = _as_tables(structure)
    return [_lod_corners(tables['codes'][i], tables['trinkets'][i], coords,
                         lod) for i, lod in enumerate(cfg.active_lods)]


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
    cfs = gather_rows(params['features'], [p[0] for p in parts])
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


def _codebook_lookup(l: torch.Tensor, dictionary: torch.Tensor,
                     training: bool) -> torch.Tensor:
    """Dictionary entries of gathered logits [..., D]: training mixes with
    the straight-through softmax ``y_soft + (hard - y_soft).detach()``;
    eval looks the argmax up (both argmaxes take the first maximum)."""
    if training:
        y_soft = torch.softmax(l, dim=-1)
        # the one-hot of the argmax, built in f32 (F.one_hot's int64 would
        # double the largest tensor of the step)
        hard = torch.zeros_like(y_soft).scatter_(
            -1, torch.argmax(y_soft, dim=-1, keepdim=True), 1.0)
        keys = y_soft + (hard - y_soft).detach()
        return torch.einsum('...d,df->...f', keys, dictionary)
    return dictionary[torch.argmax(l, dim=-1)]


def codebook_interpolate(params: dict, cfg: CodebookOctreeGridConfig,
                         structure, coords: torch.Tensor, *,
                         training: bool = True) -> torch.Tensor:
    lead = coords.shape[:-1]
    c = coords.reshape(-1, 3)
    parts = _corners(cfg, structure, c)
    logits = gather_rows(params['logits'], [p[0] for p in parts])
    feats = []
    for l, dictionary, (_, w, v) in zip(logits, params['dictionary'], parts):
        feats.append(_blend(_codebook_lookup(l, dictionary, training), w, v))
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

