"""Profiling: ``device_sync``, ``PerfTimer``, ``named_range`` and
``trace_to``, the port of ``shacira_tpu/utils/perf.py``.

The JAX package syncs by fetching one element because its relay's
``block_until_ready`` did not block; here ``torch.cuda.synchronize`` does.
Named ranges go to ``torch.profiler`` (and to NVTX on the card), the trace
context to a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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


class PerfTimer:
    """Named checkpoint timer: :meth:`check` returns the seconds since the
    previous checkpoint, after syncing the device of ``sync_value``."""

    def __init__(self, activate: bool = True):
        self.activate = activate
        self.reset()

    def reset(self):
        self.start = time.time()
        self.prev = self.start
        self.records = []

    def check(self, name: str = '', sync_value=None) -> float:
        if not self.activate:
            return 0.0
        device_sync(sync_value)
        now = time.time()
        dt = now - self.prev
        self.prev = now
        self.records.append((name, dt))
        return dt

    def summary(self) -> str:
        total = sum(dt for _, dt in self.records)
        lines = [f'{n or "?"}: {dt * 1e3:.2f} ms '
                 f'({dt / max(total, 1e-12):.0%})' for n, dt in self.records]
        return ' | '.join(lines)


@contextlib.contextmanager
def named_range(name: str):
    """A ``torch.profiler`` range, and an NVTX range when a card is
    present."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]):
    """Profile the block (host, and the card where there is one) and write
    a Chrome trace, ``log_dir/trace.json``; nothing for ``None``."""
    if log_dir is None:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
