"""Checkpoint and resume.

Port of ``shacira_tpu/utils/checkpoint.py``, in its file format: a state
dict whose tensors are stored as numpy arrays, pickled atomically.  A model
file is ``{'format': 'full', 'params', 'configs'}`` (the port's config
dataclasses) or ``{'format': 'state_dict', 'params'}``.  A ``'state_dict'``
model file written by the JAX package therefore loads here
(``utils/convert.params_from_jax``); its ``'full'`` files and resume
states pickle JAX-package objects and are refused, since unpickling them
would import that package.

A trainer's resume state holds what the JAX package's holds: iteration,
params, Adam state, rate-loss noise, the random generator's state
(``torch.Generator.get_state``), the best validation params and PSNR, and
the occupancy state.  Like the JAX package it keeps neither the ray-batch
stream nor the adapted budgets: a resumed run draws new ray batches and
starts again from the base budgets.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict

import torch

from shacira_tpu_torch import optim
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


class _Unpickler(pickle.Unpickler):
    """Refuses the JAX package's classes instead of importing them."""

    def find_class(self, module, name):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + '.'):
            raise pickle.UnpicklingError(
                f'this file pickles {module}.{name} of the JAX package: '
                "the port loads JAX model files saved with model_format="
                "'state_dict' (params only), not 'full' files or resume "
                'states')
        return super().find_class(module, name)


def load_state(path: str) -> Dict[str, Any]:
    """A state dict written by :func:`save_state` (or a JAX ``'state_dict'``
    model file), its arrays as numpy."""
    with open(path, 'rb') as f:
        return _Unpickler(f).load()


def save_trainer(trainer, path: str) -> None:
    """Save a multiview trainer's resumable state."""
    state = {
        'epoch': None,
        'iteration': trainer.iteration,
        'params': trainer.params,
        'opt_state': trainer.opt_state,
        'noise': trainer.noise,
        'rng': trainer.generator.get_state(),
        'occ_state': trainer.occ_state,
    }
    if trainer.val_best_params is not None:
        state['val_best_params'] = trainer.val_best_params
        state['best_val_psnr'] = trainer.best_val_psnr
    save_state(path, state)


def restore_trainer(trainer, path: str) -> Dict[str, Any]:
    """Restore a trainer's state in place (the grids it derives from the
    occupancy rebuilt); returns the raw state dict."""
    state = load_state(path)
    dev = trainer.device
    opt = state['opt_state']
    trainer.set_params(params_from_jax(state['params'], dev),
                       {'mu': params_from_jax(opt['mu'], dev),
                        'nu': params_from_jax(opt['nu'], dev),
                        'count': int(opt['count'])})
    trainer.noise = torch.as_tensor(state['noise'], device=dev)
    trainer.generator.set_state(torch.as_tensor(state['rng']))
    trainer.iteration = int(state['iteration'])
    if 'val_best_params' in state:
        # host tensors, as validate() keeps them
        trainer.val_best_params = params_from_jax(state['val_best_params'])
        trainer.best_val_psnr = state['best_val_psnr']
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
    """A model saved by :func:`save_model` (here or, as ``'state_dict'``,
    by the JAX package), its params as tensors on ``device``."""
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
