"""The readers of the program's own spans and counters: the encode's
backward range, and the compaction's slot use and kept share from the
counter registry of the process that trained; None where the program
keeps no counters (a program older than the registry)."""
from __future__ import annotations

import sys

import pytest
import torch

import tiny
from perfbench.harness import bench, profile

METRICS = ('encode_backward_ms.nerf', 'slot_use.nerf', 'kept_share.nerf')


def _trace(ranges=None):
    return profile.Trace(steps=10, wall_s=0.6, busy_s=0.55, device_ops=100,
                         ranges_ms=ranges or {}, kernels_s={}, gaps_s={})


@pytest.fixture
def registry():
    from shacira_tpu_torch.utils import perf
    perf.reset_counts()
    with torch.profiler.profile():
        for live, kept in ((300, 100), (500, 100)):
            perf.count('trace/live_samples', torch.tensor(live))
            perf.count('trace/kept_samples', torch.tensor(kept))
            perf.count('trace/slots', 400)
    yield perf
    perf.reset_counts()


def test_readers_read_the_range_and_the_counters(tmp_path, registry):
    root = tiny.make_root(str(tmp_path))
    read = {m: bench.reader(root, m) for m in METRICS}
    t = _trace({'backward/encode': 7.5, 'field/encode': 30.0})
    assert read['encode_backward_ms.nerf'](t) == 7.5
    assert read['slot_use.nerf'](t) == pytest.approx(25.0)      # 200 / 800
    assert read['kept_share.nerf'](t) == pytest.approx(25.0)    # 200 / 800
    assert read['encode_backward_ms.nerf'](_trace()) is None


def test_readers_give_none_without_the_registry(tmp_path, monkeypatch):
    root = tiny.make_root(str(tmp_path))
    # the program at a commit without the registry: its import fails
    monkeypatch.setitem(sys.modules, 'shacira_tpu_torch.utils.perf', None)
    for m in METRICS:
        assert bench.reader(root, m)(_trace()) is None


def test_readers_give_none_where_nothing_was_counted(tmp_path):
    from shacira_tpu_torch.utils import perf
    perf.reset_counts()
    root = tiny.make_root(str(tmp_path))
    assert bench.reader(root, 'slot_use.nerf')(_trace()) is None
    assert bench.reader(root, 'kept_share.nerf')(_trace()) is None
