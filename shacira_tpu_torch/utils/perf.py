"""Profiling: ``device_sync``, the counter registry and ``trace_to``, the
port of ``shacira_tpu/utils/perf.py``.

The JAX package syncs by fetching one element because its relay's
``block_until_ready`` did not block; here ``torch.cuda.synchronize`` does.
Spans are ``torch.profiler.record_function`` ranges, opened where the work
happens; the trace context writes them to a Chrome trace.

Counters: :func:`count` adds a host number or a device scalar under a name.
Host numbers (the kernels' launch counts) are always added.  A device
scalar is added only while a ``torch.profiler`` session records
(:func:`tracing`), in place into one device accumulator per name, so a
step neither syncs nor launches anything for it when nothing profiles;
:func:`counted` reads a total once, after the block.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Dict, Optional, Union

import torch
from torch.profiler import ProfilerActivity, profile

_host: Dict[str, float] = {}
_device: Dict[str, torch.Tensor] = {}
_lock = threading.Lock()      # the autograd and render threads count too


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x=None):
    """Wait for the card's pending work when ``x`` (a tensor or a tree of
    them) lies on it; nothing on the CPU or for ``None``."""
    t = _first_tensor(x)
    if t is not None and t.device.type == 'cuda':
        torch.cuda.synchronize(t.device)


def tracing() -> bool:
    """True while a ``torch.profiler`` session records."""
    return torch.autograd._profiler_enabled()


def count(name: str, value: Union[int, float, torch.Tensor]):
    """Add ``value`` to counter ``name``: a host number always, a device
    scalar only while :func:`tracing` (one in-place add, no sync)."""
    if not isinstance(value, torch.Tensor):
        with _lock:
            _host[name] = _host.get(name, 0) + value
        return
    if not tracing():
        return
    with _lock:
        acc = _device.get(name)
        if acc is None:
            # the first value's copy is the accumulator: one device op, as
            # each later add is
            _device[name] = value.detach().to(
                torch.float64 if value.is_floating_point() else torch.int64,
                copy=True)
        else:
            acc.add_(value.detach())


def counted(name: str) -> float:
    """Counter ``name``'s total (0 where nothing was counted); reads the
    device once."""
    acc = _device.get(name)
    return float(_host.get(name, 0)) + (0.0 if acc is None else float(acc))


def counts() -> Dict[str, float]:
    """Every counter's total."""
    return {n: counted(n) for n in sorted(set(_host) | set(_device))}


def reset_counts():
    """Drop every counter and device accumulator."""
    with _lock:
        _host.clear()
        _device.clear()


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]):
    """Profile the block (host, and the card where there is one) and write
    a Chrome trace, ``log_dir/trace.json``, and each counter's total over
    the block, ``log_dir/counters.json``; nothing for ``None``."""
    if log_dir is None:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = counts()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
    block = {n: v - before.get(n, 0.0) for n, v in counts().items()}
    with open(os.path.join(log_dir, 'counters.json'), 'w') as f:
        json.dump({n: v for n, v in block.items() if v}, f, indent=1)
