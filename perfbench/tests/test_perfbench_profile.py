"""The trace reduction on a hand-made profile: device time given to each
range by its name, a kernel once in each, busy time, operations, and idle
gaps named by the host work around them."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import tiny
from perfbench.harness import profile


class _Range(SimpleNamespace):
    def elapsed_us(self):
        return self.end - self.start


def _event(name, start, end, dev=DeviceType.CPU, kernels=(), parent=None,
           eid=0):
    e = SimpleNamespace(name=name, device_type=dev, id=eid,
                        time_range=_Range(start=start, end=end),
                        kernels=[SimpleNamespace(duration=d)
                                 for d in kernels],
                        cpu_children=[], cpu_parent=parent,
                        is_user_annotation='/' in name)
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def test_reduce_attributes_once_and_names_gaps():
    encode = _event('field/encode', 0, 100, eid=1)
    mul = _event('aten::mul', 10, 20, kernels=(30,), parent=encode, eid=2)
    # a child repeating its parent's correlation id counts nothing again
    _event('Command Buffer Full', 12, 14, kernels=(30,), parent=mul, eid=2)
    adam = _event('step/adam', 120, 200, eid=3)
    _event('aten::add_', 130, 140, kernels=(10,), parent=adam, eid=4)
    events = [encode, adam] + encode.cpu_children + \
        mul.cpu_children + adam.cpu_children + [
            _event('mul_kernel', 20, 50, DeviceType.CUDA),
            _event('scatter_add_rows_kernel<1>', 80, 90, DeviceType.CUDA),
            _event('add_kernel', 150, 160, DeviceType.CUDA)]
    t = profile.reduce(events, steps=2, wall_s=200e-6)
    assert t.device_ops == 3
    assert t.busy_s == pytest.approx(50e-6)
    assert t.ranges_ms['field/encode'] == pytest.approx(30 / 1e3 / 2)
    assert t.ranges_ms['step/adam'] == pytest.approx(10 / 1e3 / 2)
    assert t.kernel_ms('scatter_add_rows_kernel') == pytest.approx(
        10 / 1e3 / 2)
    # 50-80 inside field/encode; 90-150 centred at 120, inside step/adam
    assert t.gaps_s == {'field/encode': pytest.approx(30e-6),
                        'step/adam': pytest.approx(60e-6)}
    assert t.top(t.kernels_s, 1) == [['mul_kernel', pytest.approx(30e-6)]]


def test_any_range_is_read_by_name_and_leaves_the_others_as_they_are():
    """A range no reader knew of (one the program adds later, here nested
    in 'field/encode' and one around the backward) is reduced by its name;
    the ranges around it, and the backward taken as what no forward or
    step range holds, read as before."""
    from perfbench.harness import bench

    def events(new: bool):
        encode = _event('field/encode', 0, 100, eid=1)
        inner = (_event('field/encode_hash', 5, 40, parent=encode, eid=5)
                 if new else encode)
        _event('aten::mul', 10, 20, kernels=(30,), parent=inner, eid=2)
        # a range nested in one of its own name counts once
        again = _event('field/encode', 41, 60, parent=encode, eid=6)
        _event('aten::add', 42, 50, kernels=(5,), parent=again, eid=7)
        back = (_event('step/backward', 110, 130, eid=8) if new else None)
        _event('autograd::mm', 112, 118, kernels=(20,), parent=back, eid=9)
        out, todo = [], [e for e in (encode, back) if e is not None]
        while todo:
            e = todo.pop()
            out.append(e)
            todo.extend(e.cpu_children)
        mm = [e for e in out if e.name == 'autograd::mm']
        if not mm:
            out.append(_event('autograd::mm', 112, 118, kernels=(20,),
                              eid=9))
        return out + [_event('mul_kernel', 20, 50, DeviceType.CUDA),
                      _event('add_kernel', 55, 60, DeviceType.CUDA),
                      _event('mm_kernel', 120, 140, DeviceType.CUDA)]

    read = {m: bench.reader(tiny.REPO, m + '.nerf')
            for m in ('encode_ms', 'backward_ms')}
    old = profile.reduce(events(False), steps=1, wall_s=150e-6)
    new = profile.reduce(events(True), steps=1, wall_s=150e-6)
    assert new.ranges_ms['field/encode_hash'] == pytest.approx(30 / 1e3)
    assert new.ranges_ms['step/backward'] == pytest.approx(20 / 1e3)
    assert old.ranges_ms['field/encode'] == pytest.approx(35 / 1e3)
    for m, r in read.items():
        assert r(new) == pytest.approx(r(old)), m
    assert read['backward_ms'](old) == pytest.approx(20 / 1e3)
