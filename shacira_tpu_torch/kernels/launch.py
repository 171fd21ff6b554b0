"""Bind, launch and choose the port's hand-written CUDA kernels.

Every C entry point of ``csrc/`` takes its arguments, then the CUDA stream,
and returns 0 or a CUDA error code.  An ops module declares each one as an
:class:`Entry` and picks it or its plain PyTorch twin with :func:`dispatch`.
"""
from __future__ import annotations

import ctypes

import torch

from shacira_tpu_torch.kernels.build import load
from shacira_tpu_torch.utils import perf

_C_TYPES = {'p': ctypes.c_void_p, 'i': ctypes.c_int, 'q': ctypes.c_longlong}


class Entry:
    """C function ``symbol`` of ``csrc/<source>.cu``; ``params``, its C
    parameters before the stream: strings of the codes ``p`` (pointer),
    ``i`` (int), ``q`` (int64), or a ``ctypes.Structure`` class for a
    pointer to one (pass the struct or an array of them)."""

    def __init__(self, source: str, symbol: str, *params):
        self.source, self.symbol = source, symbol
        argtypes = []
        for p in params:
            if isinstance(p, str):
                argtypes += [_C_TYPES[c] for c in p]
            else:
                argtypes.append(ctypes.POINTER(p))
        self.argtypes = (*argtypes, ctypes.c_void_p)

    def bind(self, lib=None):
        """The function of ``lib`` (default: ``build.load(source)``), its
        signature set once (ctypes keeps one function object a library)."""
        fn = getattr(load(self.source) if lib is None else lib, self.symbol)
        if fn.argtypes is None:
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
        return fn

    def __call__(self, device: torch.device, *args, lib=None):
        """Launch on ``device``'s current stream; raise on an error code."""
        err = self.bind(lib)(*args,
                             torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'{self.symbol} launch failed: CUDA error '
                               f'{err}')


def aligned_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous f32, cloned only when not 16-byte aligned (the
    kernels' vector loads)."""
    t = t.float().contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def dispatch(name: str, device: torch.device, plain, kernel):
    """``plain()`` on a CPU device; on a CUDA device ``kernel()``, which
    returns (result, launches made), the launches added to
    ``launches/<name>``; any other device raises."""
    if device.type == 'cpu':
        return plain()
    if device.type != 'cuda':
        raise RuntimeError(f'{name}: unsupported device {device}')
    out, launches = kernel()
    if launches:
        perf.count(f'launches/{name}', launches)
    return out
