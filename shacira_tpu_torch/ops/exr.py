"""Minimal native OpenEXR codec (single-part scanline, NO_COMPRESSION).

The port's own copy of ``shacira_tpu/ops/exr.py`` (numpy only): the subset
of the format that RTMV input and image export need.

  * write: FLOAT channels, increasing-y scanlines, no compression;
  * read: FLOAT or HALF channels, no compression (compressed files raise;
    ``datasets/rtmv.py`` then tries cv2 and imageio, where installed).

Layout (OpenEXR 2.x, single part): magic/version, attribute list
(name\0 type\0 size payload ... \0), a uint64 line-offset table (one entry
per scanline chunk), then per-scanline chunks of
``int32 y | int32 size | channel-planar pixel rows`` with channels in
alphabetical order.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 20000630
_FLOAT, _HALF, _UINT = 2, 1, 0


def _attr(name: str, typ: str, payload: bytes) -> bytes:
    return (name.encode() + b'\0' + typ.encode() + b'\0'
            + struct.pack('<i', len(payload)) + payload)


def _chlist(names: List[str]) -> bytes:
    out = b''
    for n in sorted(names):
        out += (n.encode() + b'\0' + struct.pack('<i', _FLOAT)
                + b'\0\0\0\0' + struct.pack('<ii', 1, 1))
    return out + b'\0'


def write_exr(path: str, channels: Dict[str, np.ndarray]) -> None:
    """Write a float32 EXR.  ``channels``: name -> [H, W] plane."""
    names = sorted(channels)
    h, w = next(iter(channels.values())).shape
    for n, v in channels.items():
        assert v.shape == (h, w), (n, v.shape)
    header = b''
    header += _attr('channels', 'chlist', _chlist(names))
    header += _attr('compression', 'compression', b'\0')
    box = struct.pack('<iiii', 0, 0, w - 1, h - 1)
    header += _attr('dataWindow', 'box2i', box)
    header += _attr('displayWindow', 'box2i', box)
    header += _attr('lineOrder', 'lineOrder', b'\0')
    header += _attr('pixelAspectRatio', 'float', struct.pack('<f', 1.0))
    header += _attr('screenWindowCenter', 'v2f', struct.pack('<ff', 0., 0.))
    header += _attr('screenWindowWidth', 'float', struct.pack('<f', 1.0))
    header += b'\0'

    preamble = struct.pack('<ii', _MAGIC, 2) + header
    table_pos = len(preamble)
    data_pos = table_pos + 8 * h
    chunk_size = 8 + 4 * w * len(names)
    offsets = [data_pos + i * chunk_size for i in range(h)]

    planes = [np.ascontiguousarray(channels[n], np.float32) for n in names]
    with open(path, 'wb') as f:
        f.write(preamble)
        f.write(struct.pack(f'<{h}Q', *offsets))
        for y in range(h):
            f.write(struct.pack('<ii', y, 4 * w * len(names)))
            for p in planes:
                f.write(p[y].tobytes())


def _read_attrs(buf: bytes, pos: int) -> Tuple[dict, int]:
    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b'\0', pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b'\0', pos)
        typ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from('<i', buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos:pos + size])
        pos += size
    return attrs, pos + 1


def _parse_chlist(payload: bytes) -> List[Tuple[str, int]]:
    chans, pos = [], 0
    while payload[pos] != 0:
        e = payload.index(b'\0', pos)
        name = payload[pos:e].decode()
        pos = e + 1
        (ptype,) = struct.unpack_from('<i', payload, pos)
        pos += 4 + 4 + 8          # pLinear+reserved, x/ySampling
        chans.append((name, ptype))
    return chans


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Read an uncompressed EXR -> {channel: [H, W] float32}."""
    with open(path, 'rb') as f:
        buf = f.read()
    magic, version = struct.unpack_from('<ii', buf, 0)
    if magic != _MAGIC:
        raise ValueError(f'{path}: not an EXR file')
    # version flag bits: 0x200 tiled, 0x800 deep, 0x1000 multi-part
    if version & 0x200:
        raise NotImplementedError('tiled EXR not supported')
    if version & (0x800 | 0x1000):
        raise NotImplementedError('deep/multi-part EXR not supported')
    attrs, pos = _read_attrs(buf, 8)
    if attrs['compression'][1][0] != 0:
        raise NotImplementedError(
            f'{path}: compressed EXR (type {attrs["compression"][1][0]}): '
            'only NO_COMPRESSION is supported natively')
    x0, y0, x1, y1 = struct.unpack('<iiii', attrs['dataWindow'][1])
    h, w = y1 - y0 + 1, x1 - x0 + 1
    chans = _parse_chlist(attrs['channels'][1])       # alphabetical order
    sizes = {name: (2 if pt == _HALF else 4) for name, pt in chans}
    out = {name: np.empty((h, w), np.float32) for name, _ in chans}
    pos += 8 * h                                      # skip offset table
    for _ in range(h):
        y, size = struct.unpack_from('<ii', buf, pos)
        pos += 8
        for name, ptype in chans:
            nb = sizes[name] * w
            row = np.frombuffer(
                buf, dtype=(np.float16 if ptype == _HALF else np.float32),
                count=w, offset=pos)
            if ptype == _UINT:
                raise NotImplementedError('UINT channels not supported')
            out[name][y - y0] = row.astype(np.float32)
            pos += nb
    return out


def read_exr_rgba(path: str) -> np.ndarray:
    """[H, W, C] float32 with channels ordered R, G, B, A, then any others
    (e.g. depth) alphabetically: the layout datasets/rtmv.py consumes.

    When extra channels exist but 'A' is absent, an opaque alpha plane is
    inserted so slot 3 is always alpha (consumers index positionally; a
    depth channel must never land in the alpha slot)."""
    chans = read_exr(path)
    order = [c for c in ('R', 'G', 'B', 'A') if c in chans]
    extras = sorted(c for c in chans if c not in ('R', 'G', 'B', 'A'))
    planes = [chans[c] for c in order]
    if extras and 'A' not in chans:
        planes.append(np.ones_like(planes[0]))
    planes += [chans[c] for c in extras]
    return np.stack(planes, axis=-1)
