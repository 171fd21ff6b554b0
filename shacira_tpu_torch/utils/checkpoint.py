"""Checkpoint and resume.

Port of ``shacira_tpu/utils/checkpoint.py``, in its file format: a state
dict whose tensors are stored as numpy arrays, pickled atomically.  A model
file is ``{'format': 'full', 'params', 'configs'}`` (the port's config
dataclasses) or ``{'format': 'state_dict', 'params'}``.

Files written by the JAX package load here without importing it: every
object of a JAX-package class (its ``AdamState``, its config dataclasses)
is rebuilt as a :class:`JaxObject` that keeps the class's name and the
pickled fields.  So a JAX model file's params load (its configs come back
as ``JaxObject`` objects) and a JAX resume state restores into a port trainer;
a JAX random key cannot seed a ``torch.Generator``, so such a restore keeps
the trainer's generator.

A trainer's resume state holds what the JAX package's holds, under its
field names: epoch or iteration, params, Adam state, rate-loss noise, the
random generator's state (``torch.Generator.get_state``), the best
validation params and PSNR; for the image trainer also the train-loss best
(``best_params``, ``best_loss``, ``best_psnr``) and ``_resampled_epoch``;
for the multiview trainer the occupancy state.  Like the JAX package it
keeps neither the ray-batch stream nor the adapted budgets: a resumed
multiview run draws new ray batches and starts again from the base
budgets.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from shacira_tpu_torch import optim
from shacira_tpu_torch.parallel import mesh as pmesh
from shacira_tpu_torch.utils.convert import params_from_jax

_JAX_PACKAGE = 'shacira_tpu'


def _to_host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def save_state(path: str, state: Dict[str, Any]) -> None:
    """Atomically pickle a state dict, its tensors as numpy arrays."""
    host_state = optim.tree_map(_to_host, state)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d or '.', suffix='.tmp')
    try:
        with os.fdopen(fd, 'wb') as f:
            pickle.dump(host_state, f, protocol=4)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class JaxObject:
    """An object of a JAX-package class, rebuilt without importing it:
    ``jax_class`` is the class's dotted name, ``args`` what its
    constructor got (a named tuple's fields), ``fields`` its pickled
    state (a dataclass's attributes)."""
    jax_class = ''

    def __new__(cls, *args):
        obj = super().__new__(cls)
        obj.args = args
        obj.fields = {}
        return obj

    def __setstate__(self, state):
        self.fields = dict(state) if isinstance(state, dict) else {
            'state': state}

    def __repr__(self):
        return f'JaxObject({self.jax_class}, {self.args or self.fields})'


class _Unpickler(pickle.Unpickler):
    """Rebuilds the JAX package's classes as :class:`JaxObject` instead of
    importing them."""

    def find_class(self, module, name):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + '.'):
            return type(name, (JaxObject,),
                        {'jax_class': f'{module}.{name}'})
        return super().find_class(module, name)


def load_state(path: str) -> Dict[str, Any]:
    """A state dict written by :func:`save_state` or by the JAX package,
    its arrays as numpy."""
    with open(path, 'rb') as f:
        return _Unpickler(f).load()


def _adam_state(opt, dev) -> dict:
    """The port's Adam state from a saved one: the port's dict or the JAX
    package's ``AdamState(mu, nu, count)``."""
    if isinstance(opt, JaxObject):
        mu, nu, count = opt.args
    else:
        mu, nu, count = opt['mu'], opt['nu'], opt['count']
    return {'mu': params_from_jax(mu, dev), 'nu': params_from_jax(nu, dev),
            'count': int(count)}


def _whole_opt_state(trainer) -> dict:
    """The trainer's Adam state with the codebook's moments whole: under
    ``shard_table_work`` a rank holds their rows, and every rank takes
    part in gathering them."""
    opt = trainer.opt_state
    if not getattr(trainer, 'shard_table_work', False):
        return opt
    opt = dict(opt)
    for k in ('mu', 'nu'):
        tree = optim.tree_map(lambda t: t, opt[k])
        tree['grid']['codebook'] = pmesh.all_gather_rows(
            trainer.mesh, tree['grid']['codebook'])
        opt[k] = tree
    return opt


def save_trainer(trainer, path: str) -> None:
    """Save an image or multiview trainer's resumable state.  A trainer on
    a mesh calls it on every rank and rank 0 writes; the file loads at any
    world size."""
    image = hasattr(trainer, 'best_params')
    opt_state = _whole_opt_state(trainer)
    if not getattr(trainer, 'is_writer', True):
        return
    state = {
        'epoch': trainer.epoch if image else None,
        'iteration': None if image else trainer.iteration,
        'params': trainer.params,
        'opt_state': opt_state,
        'noise': trainer.noise,
        'rng': trainer.generator.get_state(),
    }
    if image:
        state['best_params'] = trainer.best_params
        state['best_loss'] = trainer.best_loss
        state['best_psnr'] = trainer.best_psnr
        state['_resampled_epoch'] = trainer._resampled_epoch
    if trainer.val_best_params is not None:
        state['val_best_params'] = trainer.val_best_params
        state['best_val_psnr'] = trainer.best_val_psnr
    if hasattr(trainer, 'occ_state'):
        state['occ_state'] = trainer.occ_state
    save_state(path, state)


def restore_trainer(trainer, path: str) -> Dict[str, Any]:
    """Restore a trainer's state in place (a multiview trainer's grids
    derived from the occupancy rebuilt); returns the raw state dict."""
    state = load_state(path)
    dev = trainer.device
    trainer.set_params(params_from_jax(state['params'], dev),
                       _adam_state(state['opt_state'], dev))
    trainer.noise = torch.as_tensor(state['noise'], device=dev)
    rng = np.asarray(state['rng'])
    if rng.dtype == np.uint8:            # a torch.Generator state
        trainer.generator.set_state(torch.as_tensor(rng))
    if state.get('epoch') is not None:
        trainer.epoch = int(state['epoch'])
    if state.get('iteration') is not None:
        trainer.iteration = int(state['iteration'])
    if 'best_params' in state and hasattr(trainer, 'best_params'):
        trainer.best_params = params_from_jax(state['best_params'], dev)
        trainer.best_loss = torch.as_tensor(state['best_loss'], device=dev)
        trainer.best_psnr = torch.as_tensor(state['best_psnr'], device=dev)
    if 'val_best_params' in state:
        # host tensors, as validate() keeps them
        trainer.val_best_params = params_from_jax(state['val_best_params'])
        trainer.best_val_psnr = state['best_val_psnr']
    if '_resampled_epoch' in state:
        trainer._resampled_epoch = int(state['_resampled_epoch'])
    if 'occ_state' in state and hasattr(trainer, 'set_occupancy'):
        trainer.set_occupancy(params_from_jax(state['occ_state'], dev))
    return state


def save_model(path: str, params, model_format: str = 'full',
               configs: Dict[str, Any] = None) -> None:
    """Save a trained model: ``'full'`` stores the params with the config
    dataclasses that rebuild the field, ``'state_dict'`` the params only."""
    if model_format == 'full':
        save_state(path, {'format': 'full', 'params': params,
                          'configs': configs or {}})
    elif model_format == 'state_dict':
        save_state(path, {'format': 'state_dict', 'params': params})
    else:
        raise ValueError(model_format)


def load_model(path: str, device='cpu') -> Dict[str, Any]:
    """A model saved by :func:`save_model` here or by the JAX package, its
    params as tensors on ``device``."""
    state = load_state(path)
    state['params'] = params_from_jax(state['params'], device)
    return state


def check_like(params, reference, what: str) -> None:
    """Raise unless ``params`` has the leaves and shapes of ``reference``."""
    got, want = ({p: tuple(t.shape)
                  for p, t in optim.tree_leaves_with_path(tree)}
                 for tree in (params, reference))
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:4]
        raise ValueError(f'{what} does not fit this model: {diff}')
