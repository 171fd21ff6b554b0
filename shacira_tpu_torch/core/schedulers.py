"""Hyper-parameter decay schedules (entropy weight, SGA temperature, decoder
lr warm-up).  Port of ``shacira_tpu/core/schedulers.py``; host-side numpy."""
from __future__ import annotations

import numpy as np


def schedule(name: str, steps, total_steps: int, start: float, end: float,
             *, decay_period: float = None, temperature: float = None):
    """Value of the named decay at each entry of ``steps`` (float64).

    'fix' constant; 'linear' start -> end over total_steps then held;
    'exp' start * T^(s / (total * decay_period)) floored at end;
    'inv_sqrt' start * sqrt(total / (total + s)); 'cosine' half-cosine from
    start to end."""
    s = np.asarray(steps, np.float64)
    n = float(total_steps)
    if name == 'fix':
        return np.full_like(s, start)
    if name == 'linear':
        return start + (end - start) * np.minimum(s / n, 1.0)
    if name == 'exp':
        return np.maximum(
            end, start * np.asarray(temperature) ** (s / (n * decay_period)))
    if name == 'inv_sqrt':
        return start * np.sqrt(n / (n + s))
    if name == 'cosine':
        return end + 0.5 * (start - end) * (1.0 + np.cos(np.pi * s / n))
    raise ValueError(f'Unknown decay name: {name}')


class DecayScheduler:
    """Callable wrapper over :func:`schedule`."""

    def __init__(self, total_steps, decay_name='fix', start=0.0, end=0.0,
                 params=None):
        p = params or {}
        self._args = (decay_name, total_steps, start, end)
        self._kw = {'decay_period': p.get('decay_period'),
                    'temperature': p.get('temperature')}

    def __call__(self, step):
        name, total, start, end = self._args
        return float(schedule(name, step, total, start, end, **self._kw))
