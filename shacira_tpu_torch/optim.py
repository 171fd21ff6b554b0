"""Adam over labelled parameter groups with per-step learning rates.

Port of ``shacira_tpu/optim.py``.  Parameters are a nested dict/list tree of
tensors; each leaf gets a group label from its path (``shacira_label_fn``)
and every group gets its own learning rate at each update, so the trainer
can rescale the grid lr and warm up the decoder lr per step.  Update math
is torch Adam's (bias-corrected moments; 'adam' adds L2 to the gradient,
'adamw' decays the parameter).  Unlike the JAX package the update runs in
place on the parameter and moment tensors, which saves a copy of the
7.9M-row codebook and its moments each step.

Across the ranks of a data-parallel mesh (``parallel/mesh.py``),
:func:`adam_update_mesh` averages the gradients first; a row-sharded leaf
(the codebook under the trainers' ``shard_table_work``) keeps its moments
on this rank's ``T/n`` rows only, updates those rows and all-gathers them
back into the replicated table.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from shacira_tpu_torch.parallel import mesh as pmesh


def tree_leaves_with_path(tree, prefix=()) -> Iterator[Tuple[tuple, object]]:
    """(path, leaf) pairs of a dict/list tree, keys as strings, in sorted
    dict-key order (the order of JAX's tree flattening)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def shacira_label_fn(path: tuple) -> str:
    """Group of a parameter path: latent decoder (its ``div`` and ``dft``
    frozen), prob model, MLP decoders, grid codebook, rest."""
    joined = '/'.join(path)
    if 'latent_dec' in joined:
        if path[-1] in ('div', 'dft'):
            return 'frozen'
        return 'latent_dec'
    if 'prob_model' in joined:
        return 'prob_models'
    if 'decoder' in joined:
        return 'decoder'
    if 'grid' in joined:
        return 'grid'
    return 'rest'


def label_params(params, label_fn: Callable[[tuple], str] = shacira_label_fn
                 ) -> Dict[tuple, str]:
    return {path: label_fn(path) for path, _ in tree_leaves_with_path(params)}


def adam_init(params) -> dict:
    """Zero moments shaped like ``params`` and a step count of 0."""
    return {'mu': tree_map(torch.zeros_like, params),
            'nu': tree_map(torch.zeros_like, params), 'count': 0}


@torch.no_grad()
def adam_update(grads: Dict[tuple, torch.Tensor], state: dict, params,
                labels: Dict[tuple, str], lr: Dict[str, float],
                weight_decay: Dict[str, float], b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                decoupled: bool = False,
                rows: Optional[Dict[tuple, slice]] = None):
    """One Adam step in place.

    ``grads`` maps a leaf path to its gradient (a missing path counts as a
    zero gradient, as JAX's grad of an unused parameter is zero).  Groups
    labelled 'frozen' or absent from ``lr`` stay untouched.  A leaf in
    ``rows`` updates only those rows: its gradient and moments hold just
    them."""
    rows = rows or {}
    state['count'] += 1
    count = state['count']
    # bias corrections in float32, as the JAX package computes them
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    mus = dict(tree_leaves_with_path(state['mu']))
    nus = dict(tree_leaves_with_path(state['nu']))
    for path, p in tree_leaves_with_path(params):
        lbl = labels[path]
        if lbl == 'frozen' or lbl not in lr:
            continue
        if path in rows:
            p = p[rows[path]]
        g = grads.get(path)
        g = torch.zeros_like(p) if g is None else g.to(p.dtype)
        glr = lr[lbl]              # float or 0-d tensor (no host sync)
        wd = weight_decay.get(lbl, 0.0)
        if wd and not decoupled:
            g = g + wd * p
        m, v = mus[path], nus[path]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        step = glr * (m / c1) / (torch.sqrt(v / c2) + eps)
        if wd and decoupled:
            step = step + glr * wd * p
        p.sub_(step)


@torch.no_grad()
def adam_update_mesh(grads: Dict[tuple, torch.Tensor], state: dict, params,
                     labels: Dict[tuple, str], lr: Dict[str, float],
                     weight_decay: Dict[str, float], mesh: pmesh.Mesh,
                     row_paths=(), **kw):
    """:func:`adam_update` of the gradient averaged over the mesh's ranks,
    each rank passing its own.

    Every leaf's gradient is mean-all-reduced (one flat buffer), except a
    leaf of ``row_paths`` [T, ...], whose moments hold this rank's
    ``row_sharding(mesh, T)`` rows: its gradient is either the whole
    table's (reduce-scattered to those rows) or already those rows summed
    over the ranks (the backward of ``mesh.all_gather_rows``), and over n
    it is their mean.  Adam updates those rows, which are then
    all-gathered into the table, so every rank ends with the same
    parameters.  The gradient tensors are reduced in place."""
    grads = dict(grads)
    leaves = dict(tree_leaves_with_path(params))
    flat = []
    for path, p in leaves.items():
        if (path in row_paths or labels[path] == 'frozen'
                or labels[path] not in lr):
            continue
        if grads.get(path) is None:
            grads[path] = torch.zeros_like(p)
        flat.append(grads[path])
    pmesh.all_reduce_mean_(mesh, flat)
    rows = {}
    for path in row_paths:
        p = leaves[path]
        rows[path] = pmesh.row_sharding(mesh, p.shape[0])
        g = grads.get(path)
        if g is None:
            g = torch.zeros_like(p[rows[path]])
        elif g.shape[0] == p.shape[0] and mesh.size > 1:
            g = pmesh.reduce_scatter_rows(mesh, g)
        grads[path] = g / mesh.size
    adam_update(grads, state, params, labels, lr, weight_decay, rows=rows,
                **kw)
    for path, sl in rows.items():
        p = leaves[path]
        pmesh.all_gather_rows(mesh, p[sl].clone(), out=p)
