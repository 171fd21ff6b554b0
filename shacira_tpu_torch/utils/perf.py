"""Profiling: ``trace_to``, the port of ``shacira_tpu/utils/perf.py``'s
trace context over ``torch.profiler``."""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile


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
