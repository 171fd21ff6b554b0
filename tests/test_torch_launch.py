"""The launch seam of the port's CUDA kernels (``kernels/launch.py``) on the
CPU, with stand-in library functions: the C signature bound once a
library, the current stream passed last, a non-zero return raised, the
CPU / CUDA / other-device choice and its launch counter, the alignment
helper, and every kernel's declared parameters against its C prototype
in ``csrc/``.

No JAX import."""
import ctypes
import re
import types

import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.accel import occupancy  # noqa: E402
from shacira_tpu_torch.kernels import build, launch  # noqa: E402
from shacira_tpu_torch.ops import (  # noqa: E402
    codebook, hashgrid, paged_hash, scatter, spc)
from shacira_tpu_torch.utils import perf  # noqa: E402

STREAM = 0x5eed


class _StandIn:
    """A library function: counts the signatures set on it, records its
    calls and returns ``ret``."""

    def __init__(self, ret=0):
        self._argtypes, self.restype = None, None
        self.signatures_set, self.calls, self.ret = 0, [], ret

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.signatures_set += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


class _Params(ctypes.Structure):
    _fields_ = [('n', ctypes.c_int)]


@pytest.fixture
def stream(monkeypatch):
    """``torch.cuda.current_stream`` stubbed: every device's stream is
    ``STREAM``; records the devices asked for."""
    asked = []

    def current_stream(device=None):
        asked.append(device)
        return types.SimpleNamespace(cuda_stream=STREAM)

    monkeypatch.setattr(torch.cuda, 'current_stream', current_stream)
    return asked


@pytest.fixture
def counters():
    perf.reset_counts()
    yield
    perf.reset_counts()


def test_signature_is_bound_once_per_library(stream):
    entry = launch.Entry('src', 'kern', 'pi', _Params, 'q')
    lib_a = types.SimpleNamespace(kern=_StandIn())
    lib_b = types.SimpleNamespace(kern=_StandIn())
    dev = torch.device('cuda', 1)
    params = _Params(3)
    for _ in range(2):
        entry(dev, 11, 2, params, 5, lib=lib_a)
    entry(dev, 12, 4, params, 6, lib=lib_b)
    want = (ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Params),
            ctypes.c_longlong, ctypes.c_void_p)
    for lib, calls in ((lib_a, 2), (lib_b, 1)):
        assert lib.kern.signatures_set == 1
        assert lib.kern.argtypes == want and lib.kern.restype is ctypes.c_int
        assert len(lib.kern.calls) == calls
        assert all(c[-1] == STREAM for c in lib.kern.calls)
    assert lib_a.kern.calls[0] == (11, 2, params, 5, STREAM)
    assert stream == [dev] * 3


def test_default_library_is_the_sources_build(monkeypatch, stream):
    lib = types.SimpleNamespace(kern=_StandIn())
    loaded = []
    monkeypatch.setattr(launch, 'load',
                        lambda name: loaded.append(name) or lib)
    launch.Entry('src', 'kern', 'p')(torch.device('cuda'), 7)
    assert loaded == ['src'] and lib.kern.calls == [(7, STREAM)]


def test_nonzero_return_raises_with_the_symbol(stream):
    lib = types.SimpleNamespace(kern=_StandIn(ret=700))
    with pytest.raises(RuntimeError,
                       match=r'^kern launch failed: CUDA error 700$'):
        launch.Entry('src', 'kern', 'p')(torch.device('cuda'), 1, lib=lib)


def test_dispatch_takes_the_plain_twin_on_the_cpu(counters):
    def kernel():
        raise AssertionError('the kernel path ran for a CPU tensor')

    out = launch.dispatch('op', torch.zeros(1).device, lambda: 'plain',
                          kernel)
    assert out == 'plain' and perf.counts() == {}


def test_dispatch_refuses_other_devices(counters):
    def refuse():
        raise AssertionError('a path ran for a meta tensor')

    with pytest.raises(RuntimeError, match='^op: unsupported device meta$'):
        launch.dispatch('op', torch.zeros(1, device='meta').device, refuse,
                        refuse)
    assert perf.counts() == {}


@pytest.mark.parametrize('launches', [0, 1, 3])
def test_dispatch_counts_the_kernels_launches(counters, launches):
    def plain():
        raise AssertionError('the plain twin ran for a CUDA tensor')

    out = launch.dispatch('op', torch.device('cuda'), plain,
                          lambda: ('kernel', launches))
    assert out == 'kernel'
    assert perf.counts() == ({'launches/op': launches} if launches else {})


def test_aligned_f32_clones_only_a_misaligned_tensor():
    base = torch.arange(9, dtype=torch.float32)
    assert base.data_ptr() % 16 == 0
    assert launch.aligned_f32(base) is base
    view = base[1:]                      # 4 bytes past an aligned address
    got = launch.aligned_f32(view)
    assert got.data_ptr() % 16 == 0 and got.data_ptr() != view.data_ptr()
    assert torch.equal(got, view)
    wide = torch.arange(6, dtype=torch.float64).reshape(2, 3).t()
    got = launch.aligned_f32(wide)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.data_ptr() % 16 == 0 and torch.equal(got, wide.float())


def _c_prototype(source: str, symbol: str) -> list:
    """The parameter types of ``extern "C" int <symbol>(...)`` in
    ``csrc/<source>.cu``: 'p' for a pointer, else the C type."""
    text = (build.CSRC / f'{source}.cu').read_text()
    m = re.search(r'extern "C" int ' + symbol + r'\(([^)]*)\)', text)
    assert m, f'no C entry point {symbol} in {source}.cu'
    out = []
    for param in m.group(1).split(','):
        ctype = param.rsplit(None, 1)[0] if '*' not in param else 'p'
        out.append(' '.join(ctype.split()))
    return out


_C_NAMES = {ctypes.c_void_p: 'p', ctypes.c_int: 'int',
            ctypes.c_longlong: 'long long'}


@pytest.mark.parametrize('entry', [
    hashgrid._ENCODE, hashgrid._ENCODE_BACKWARD, scatter._SCATTER,
    scatter._GATHER, paged_hash._GATHER, paged_hash._SCATTER,
    occupancy._DDA, codebook._FORWARD, codebook._BACKWARD, spc._QUERY],
    ids=lambda e: e.symbol)
def test_entry_matches_its_c_prototype(entry):
    got = ['p' if issubclass(t, ctypes._Pointer) else _C_NAMES[t]
           for t in entry.argtypes]
    assert got == _c_prototype(entry.source, entry.symbol)
