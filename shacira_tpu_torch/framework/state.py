"""Shared experiment and scene state with field-watch events.

The port's copy of ``shacira_tpu/framework/state.py``: state objects
shared between trainer, renderer and logger components, with an observer
mechanism (``watch``) that calls back on attribute changes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List


class Watchable:
    """Attribute-change notifications: ``watch(field, callback)`` calls
    ``callback(obj, field, value)`` on every assignment to ``field``."""

    def __init__(self):
        object.__setattr__(self, '_watchers', {})

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        for cb in self._watchers.get(name, []):
            cb(self, name, value)

    def watch(self, fieldname: str, callback: Callable):
        self._watchers.setdefault(fieldname, []).append(callback)


class OptimizationState(Watchable):
    """Optimization progress: epoch, iteration, losses and metrics."""

    def __init__(self):
        super().__init__()
        self.running = False
        self.epoch = 0
        self.iteration = 0
        self.iterations_per_epoch = 0
        self.elapsed_time = 0.0
        self.losses: Dict[str, List[float]] = {}
        self.metrics: Dict[str, List[float]] = {}

    def log(self, **kv):
        for k, v in kv.items():
            target = self.losses if 'loss' in k else self.metrics
            target.setdefault(k, []).append(float(v))


class SceneState(Watchable):
    """Named objects visible to viewers and loggers."""

    def __init__(self):
        super().__init__()
        self.objects: Dict[str, Any] = {}

    def add(self, name: str, obj: Any):
        self.objects[name] = obj


class WispState(Watchable):
    """Top-level shared state."""

    def __init__(self):
        super().__init__()
        self.optimization = OptimizationState()
        self.graph = SceneState()
        self.extras: Dict[str, Any] = {}
