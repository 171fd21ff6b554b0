"""Adam over labelled parameter groups with per-step learning rates.

Port of ``shacira_tpu/optim.py``.  Parameters are a nested dict/list tree of
tensors; each leaf gets a group label from its path (``shacira_label_fn``)
and every group gets its own learning rate at each update, so the trainer
can rescale the grid lr and warm up the decoder lr per step.  Update math
is torch Adam's (bias-corrected moments; 'adam' adds L2 to the gradient,
'adamw' decays the parameter).  Unlike the JAX package the update runs in
place on the parameter and moment tensors, which saves a copy of the
7.9M-row codebook and its moments each step.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch


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
                decoupled: bool = False):
    """One Adam step in place.

    ``grads`` maps a leaf path to its gradient (a missing path counts as a
    zero gradient, as JAX's grad of an unused parameter is zero).  Groups
    labelled 'frozen' or absent from ``lr`` stay untouched."""
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
