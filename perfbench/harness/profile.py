"""Reduce a ``torch.profiler`` trace of a block of training steps to what
the per-layer metrics read.

Every ``record_function`` range of the program is reduced by its name,
whatever the name: a range the program adds later is read with no change
here.  A range's device time is that of the kernels its operations
launched, down through every operation and range nested in it (the
arithmetic of the port's ``chip_smoke.py``, ``_range_device_us``, which
stops at the ranges it knows); a range nested in one of its own name is
not counted again, so a kernel counts in a range's time once.  The busy
time is the sum of every device operation (kernels, copies and fills) on
the card's one stream.  Idle gaps between device operations are named by
what the host was doing: the innermost range, else the outermost host
operation, that covers the gap.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional



def is_range(event) -> bool:
    """A ``record_function`` range (a user annotation) on the host."""
    return bool(getattr(event, 'is_user_annotation', False))


def range_device_us(event, ancestors=frozenset()) -> float:
    """Device microseconds of the kernels an operation launched, down
    through every child.  A child that repeats an ancestor's correlation
    id (CUPTI's 'Command Buffer Full' inside the launching operation) is
    not counted again."""
    own = sum(k.duration for k in event.kernels)
    counted = 0.0 if event.id in ancestors else own
    ancestors = ancestors | {event.id}
    for ch in event.cpu_children:
        counted += range_device_us(ch, ancestors)
    return counted


def _inside_own_name(event) -> bool:
    p = event.cpu_parent
    while p is not None:
        if p.name == event.name and is_range(p):
            return True
        p = p.cpu_parent
    return False


@dataclass
class Trace:
    """Per-step numbers of a profiled block of ``steps`` steps."""
    steps: int
    wall_s: float
    busy_s: float
    device_ops: int
    ranges_ms: Dict[str, float]                 # device ms a step, by range
    kernels_s: Dict[str, float]                 # device seconds, whole block
    gaps_s: Dict[str, float]                    # idle seconds by host work
    extra: Dict[str, float] = field(default_factory=dict)

    def range_ms(self, *names) -> Optional[float]:
        """Device ms a step of the named ranges together; None where none
        of them holds device work."""
        v = sum(self.ranges_ms.get(n, 0.0) for n in names)
        return v if v > 0 else None

    def kernel_ms(self, fragment: str) -> Optional[float]:
        """Device ms a step of the kernels whose name holds ``fragment``."""
        v = sum(s for n, s in self.kernels_s.items() if fragment in n)
        return v * 1e3 / self.steps if v > 0 else None

    @property
    def busy_ms(self) -> float:
        return self.busy_s * 1e3 / self.steps

    @property
    def wall_ms(self) -> float:
        return self.wall_s * 1e3 / self.steps

    def top(self, what: Dict[str, float], n: int = 10) -> List[list]:
        return [[k[:160], v] for k, v in
                sorted(what.items(), key=lambda kv: -kv[1])[:n]]


def _host_label(active: list) -> str:
    """The innermost range, else the outermost host operation, of the
    host events ``active`` ((start, end, depth, name, is a range)) at one
    moment."""
    ranges = [(d, n) for _, _, d, n, r in active if r]
    if ranges:
        return max(ranges)[1]
    ops = [(d, n) for _, _, d, n, _ in active]
    return min(ops)[1] if ops else 'host (outside operations)'


def reduce(events, steps: int, wall_s: float) -> Trace:
    """The trace of ``steps`` steps whose profiled block took ``wall_s``."""
    from torch.autograd import DeviceType
    ranges: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    spans, cpu = [], []
    events = list(events)
    names = {e.name for e in events
             if e.device_type != DeviceType.CUDA and is_range(e)}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # a range's mirror on the device's timeline is no operation
            if is_range(e) or e.name in names:
                continue
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
            spans.append((e.time_range.start, e.time_range.end))
            continue
        rng = is_range(e)
        if rng and not _inside_own_name(e):
            ranges[e.name] = ranges.get(e.name, 0.0) + range_device_us(e)
        depth, p = 0, e.cpu_parent
        while p is not None:
            depth, p = depth + 1, p.cpu_parent
        cpu.append((e.time_range.start, e.time_range.end, depth, e.name,
                    rng))
    cpu.sort()
    spans.sort()
    # idle gaps, each named by the host work around its midpoint (a sweep
    # over the host events in start order)
    gaps: Dict[str, float] = {}
    active, i = [], 0
    reach = spans[0][1] if spans else 0.0
    for start, end in spans[1:]:
        if start > reach:
            t = 0.5 * (start + reach)
            while i < len(cpu) and cpu[i][0] <= t:
                active.append(cpu[i])
                i += 1
            active = [a for a in active if a[1] >= t]
            label = _host_label(active)
            gaps[label] = gaps.get(label, 0.0) + (start - reach) * 1e-6
        reach = max(reach, end)
    busy_us = sum(kernels.values())
    return Trace(steps=steps, wall_s=wall_s, busy_s=busy_us * 1e-6,
                 device_ops=len(spans),
                 ranges_ms={k: v / 1e3 / steps for k, v in ranges.items()},
                 kernels_s={k: v * 1e-6 for k, v in kernels.items()},
                 gaps_s=gaps)


def profile_block(run, steps: int) -> Trace:
    """Profile ``run()`` (``steps`` training steps) on the card."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return reduce(prof.events(), steps, wall)
