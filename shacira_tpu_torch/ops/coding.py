"""Entropy coding for compressed-size measurement (host side, numpy).

Port of ``shacira_tpu/ops/coding.py``:

* :func:`entropy_bits_histogram` -- the information estimate
  ``sum(counts * clamp(-log2(p + 1e-10), 0, 1000))`` of integer symbols;
* :class:`ArithmeticCoder` -- a static-CDF arithmetic codec (encoder and
  decoder) producing a real bit stream, for the final size in kB;
* :func:`coded_size_bits` -- the bits of such a stream.

The coder runs natively: ``csrc/range_coder.cpp`` is built with g++ into
``build/range_coder/`` at the repository root the first time it is needed
and loaded with ``ctypes``.  A failed build raises: at lego scale (7,879,908
symbols per latent channel) the pure-Python coder, kept as the plain
version (``_encode_py`` / ``_decode_py``, same bitstream), takes minutes.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_PRECISION = 16   # CDF quantization bits
_STATE_BITS = 32
_FULL = (1 << _STATE_BITS) - 1
_HALF = 1 << (_STATE_BITS - 1)
_QUARTER = 1 << (_STATE_BITS - 2)

_SOURCE = Path(__file__).resolve().parent.parent / 'csrc' / 'range_coder.cpp'
_LIBRARY = (Path(__file__).resolve().parents[2] / 'build' / 'range_coder'
            / 'librange_coder.so')


def entropy_bits_histogram(values: np.ndarray) -> float:
    """Histogram self-entropy bits of integer symbols."""
    values = np.asarray(values).reshape(-1)
    _, counts = np.unique(values, return_counts=True)
    probs = counts / counts.sum()
    info = np.clip(-np.log(probs + 1e-10) / np.log(2.0), 0, 1000)
    return float(np.sum(info * counts))


def _quantize_cdf(probs: np.ndarray) -> np.ndarray:
    """Strictly increasing integer CDF with a ``_PRECISION``-bit total."""
    probs = np.asarray(probs, np.float64)
    probs = probs / probs.sum()
    n = len(probs)
    scale = (1 << _PRECISION) - n
    freq = np.maximum(1, np.round(probs * scale).astype(np.int64))
    cdf = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(freq, out=cdf[1:])
    total = int(cdf[-1])
    # rescale to <= 2^PRECISION, keep every symbol slot non-empty
    cdf = cdf * scale // total + np.arange(n + 1)
    return cdf


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, bit: int):
        self.acc = (self.acc << 1) | bit
        self.nbits += 1
        if self.nbits == 8:
            self.bytes.append(self.acc)
            self.acc = 0
            self.nbits = 0

    def finish(self) -> bytes:
        if self.nbits:
            self.bytes.append(self.acc << (8 - self.nbits))
        return bytes(self.bytes)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self) -> int:
        byte_i, bit_i = divmod(self.pos, 8)
        self.pos += 1
        if byte_i >= len(self.data):
            return 0
        return (self.data[byte_i] >> (7 - bit_i)) & 1


def _build_native() -> Path:
    """Compile ``csrc/range_coder.cpp`` with g++ unless an up-to-date
    library exists; raise when the build fails."""
    if (_LIBRARY.exists()
            and _LIBRARY.stat().st_mtime >= _SOURCE.stat().st_mtime):
        return _LIBRARY
    _LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIBRARY.with_suffix(f'.{os.getpid()}.tmp')
    try:
        proc = subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
                               str(_SOURCE), '-o', str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError('g++ not found: the native range coder cannot be '
                           'built') from e
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed for {_SOURCE.name}:\n{proc.stderr}')
    os.replace(tmp, _LIBRARY)     # atomic: a concurrent build never sees half
    return _LIBRARY


@functools.cache
def native_lib() -> ctypes.CDLL:
    """Build if needed and load the native range coder."""
    lib = ctypes.CDLL(str(_build_native()))
    lib.rc_encode.restype = ctypes.c_int64
    lib.rc_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.rc_decode.restype = ctypes.c_int
    lib.rc_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    return lib


def _checked_probs(probs: np.ndarray) -> np.ndarray:
    p = np.ascontiguousarray(probs, np.float64)
    if p.ndim != 1 or not 0 < len(p) < (1 << _PRECISION):
        raise ValueError(f'an alphabet of 1 .. {(1 << _PRECISION) - 1} '
                         f'symbols is needed, got probs of shape {p.shape}')
    return p


class ArithmeticCoder:
    """Static-model arithmetic coder (Witten-Neal-Cleary, 32-bit state),
    native; ``_encode_py`` / ``_decode_py`` are its plain Python version
    with the identical bitstream."""

    @staticmethod
    def encode(symbols: np.ndarray, probs: np.ndarray) -> bytes:
        """Code ``symbols`` (each in ``[0, len(probs))``) with the CDF of
        ``probs``."""
        p = _checked_probs(probs)
        syms = np.ascontiguousarray(symbols, np.int32).reshape(-1)
        if len(syms) and not (syms.min() >= 0 and syms.max() < len(p)):
            raise ValueError('symbols outside the alphabet of probs')
        cap = len(syms) * 4 + 64
        out = np.zeros(cap, np.uint8)
        n = native_lib().rc_encode(
            syms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(syms),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError('rc_encode: the stream outgrew its buffer')
        return bytes(out[:n])

    @staticmethod
    def _encode_py(symbols: np.ndarray, probs: np.ndarray) -> bytes:
        cdf = _quantize_cdf(probs)
        total = int(cdf[-1])
        low, high, pending = 0, _FULL, 0
        w = _BitWriter()

        def emit(bit, pending):
            w.write(bit)
            for _ in range(pending):
                w.write(1 - bit)
            return 0

        for s in np.asarray(symbols, np.int64):
            s = int(s)
            span = high - low + 1
            high = low + span * int(cdf[s + 1]) // total - 1
            low = low + span * int(cdf[s]) // total
            while True:
                if high < _HALF:
                    pending = emit(0, pending)
                elif low >= _HALF:
                    pending = emit(1, pending)
                    low -= _HALF
                    high -= _HALF
                elif low >= _QUARTER and high < 3 * _QUARTER:
                    pending += 1
                    low -= _QUARTER
                    high -= _QUARTER
                else:
                    break
                low <<= 1
                high = (high << 1) | 1
        pending += 1
        if low < _QUARTER:
            emit(0, pending)
        else:
            emit(1, pending)
        return w.finish()

    @staticmethod
    def decode(data: bytes, probs: np.ndarray, num_symbols: int) -> np.ndarray:
        """The ``num_symbols`` symbols (int64) coded in ``data``."""
        p = _checked_probs(probs)
        buf = np.frombuffer(data, np.uint8)
        out = np.zeros(num_symbols, np.int32)
        rc = native_lib().rc_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            num_symbols, p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(p), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(f'rc_decode failed ({rc})')
        return out.astype(np.int64)

    @staticmethod
    def _decode_py(data: bytes, probs: np.ndarray,
                   num_symbols: int) -> np.ndarray:
        cdf = _quantize_cdf(probs)
        total = int(cdf[-1])
        r = _BitReader(data)
        code = 0
        for _ in range(_STATE_BITS):
            code = (code << 1) | r.read()
        low, high = 0, _FULL
        out = np.zeros(num_symbols, dtype=np.int64)
        for i in range(num_symbols):
            span = high - low + 1
            val = ((code - low + 1) * total - 1) // span
            s = int(np.searchsorted(cdf, val, side='right')) - 1
            s = min(max(s, 0), len(probs) - 1)
            out[i] = s
            high = low + span * int(cdf[s + 1]) // total - 1
            low = low + span * int(cdf[s]) // total
            while True:
                if high < _HALF:
                    pass
                elif low >= _HALF:
                    low -= _HALF
                    high -= _HALF
                    code -= _HALF
                elif low >= _QUARTER and high < 3 * _QUARTER:
                    low -= _QUARTER
                    high -= _QUARTER
                    code -= _QUARTER
                else:
                    break
                low <<= 1
                high = (high << 1) | 1
                code = (code << 1) | r.read()
        return out


def coded_size_bits(values: np.ndarray, probs: np.ndarray = None) -> int:
    """Bits of a real arithmetic codestream of integer symbols: the symbols
    are shifted to a dense 0-based alphabet and coded with their empirical
    histogram CDF, or with caller-supplied per-alphabet ``probs`` (a
    BitEstimator model CDF)."""
    values = np.asarray(values).reshape(-1).astype(np.int64)
    uniq, inv = np.unique(values, return_inverse=True)
    if probs is None:
        counts = np.bincount(inv)
        probs = counts / counts.sum()
    else:
        probs = np.asarray(probs, np.float64)
        if probs.shape[0] != uniq.shape[0]:
            raise ValueError(f'{probs.shape[0]} probabilities for '
                             f'{uniq.shape[0]} distinct symbols')
        probs = np.maximum(probs, 1e-10)
        probs = probs / probs.sum()
    stream = ArithmeticCoder.encode(inv, probs)
    return len(stream) * 8
