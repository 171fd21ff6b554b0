"""Geometric primitive packs for vectorial debug layers.

The port's copy of ``shacira_tpu/core/primitives.py`` (numpy):
``PrimitivesPack`` and the line geometry of the gizmos (an axis-aligned
box wireframe, a world grid, the axes) and of the occupied cells of an
occupancy grid.  ``render/overlay.py`` rasterizes them over rendered
frames in software.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from shacira_tpu_torch.core import colors
from shacira_tpu_torch.core.transforms import ObjectTransform


def _as_rows(a, width: int) -> np.ndarray:
    a = np.asarray(a, np.float32)
    if a.ndim == 1:
        a = a[None, :]
    if a.shape[-1] == 3 and width == 4:          # RGB -> RGBA
        a = np.concatenate([a, np.ones_like(a[..., :1])], axis=-1)
    if a.shape[-1] != width:
        raise ValueError(f'expected rows of width {width}, got {a.shape}')
    return a


@dataclass
class PrimitivesPack:
    """A growable pack of line and point primitives with per-vertex colors.

    ``add_lines`` / ``add_points`` accept single primitives ``(3,)`` or
    batches ``(B, 3)`` with RGB or RGBA colors; ``lines`` / ``points``
    concatenate them into single arrays.
    """
    _lines_start: List[np.ndarray] = field(default_factory=list)
    _lines_end: List[np.ndarray] = field(default_factory=list)
    _lines_color: List[np.ndarray] = field(default_factory=list)
    _points_pos: List[np.ndarray] = field(default_factory=list)
    _points_color: List[np.ndarray] = field(default_factory=list)
    transform: Optional[ObjectTransform] = None
    line_width: float = 1.0
    point_size: float = 1.0

    def add_lines(self, start, end, color=colors.white) -> None:
        start, end = _as_rows(start, 3), _as_rows(end, 3)
        color = np.broadcast_to(_as_rows(color, 4), (start.shape[0], 4))
        self._lines_start.append(start)
        self._lines_end.append(end)
        self._lines_color.append(np.array(color, np.float32))

    def add_points(self, pos, color=colors.white) -> None:
        pos = _as_rows(pos, 3)
        color = np.broadcast_to(_as_rows(color, 4), (pos.shape[0], 4))
        self._points_pos.append(pos)
        self._points_color.append(np.array(color, np.float32))

    def append(self, other: 'PrimitivesPack') -> None:
        """Concatenate other's primitives into self (the two transforms are
        assumed equal)."""
        self._lines_start.extend(other._lines_start)
        self._lines_end.extend(other._lines_end)
        self._lines_color.extend(other._lines_color)
        self._points_pos.extend(other._points_pos)
        self._points_color.extend(other._points_color)

    @property
    def lines(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        if not self._lines_start:
            return None
        return (np.concatenate(self._lines_start),
                np.concatenate(self._lines_end),
                np.concatenate(self._lines_color))

    @property
    def points(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if not self._points_pos:
            return None
        return (np.concatenate(self._points_pos),
                np.concatenate(self._points_color))

    def world_lines(self):
        """Lines with the pack transform applied (identity if None)."""
        ln = self.lines
        if ln is None:
            return None
        s, e, c = ln
        if self.transform is not None:
            s = self.transform.apply_points(s)
            e = self.transform.apply_points(e)
        return s, e, c

    def world_points(self):
        pt = self.points
        if pt is None:
            return None
        p, c = pt
        if self.transform is not None:
            p = self.transform.apply_points(p)
        return p, c

    def __eq__(self, other):
        if not isinstance(other, PrimitivesPack):
            return NotImplemented
        for a, b in ((self.lines, other.lines), (self.points, other.points)):
            if (a is None) != (b is None):
                return False
            if a is not None and not all(
                    np.array_equal(x, y) for x, y in zip(a, b)):
                return False
        return True


# ---------------------------------------------------------------------------
# Gizmo and data-layer geometry
# ---------------------------------------------------------------------------

_BOX_EDGES = np.array([(0, 1), (0, 2), (1, 3), (2, 3),
                       (4, 5), (4, 6), (5, 7), (6, 7),
                       (0, 4), (1, 5), (2, 6), (3, 7)], np.int32)
_BOX_CORNERS = np.stack(np.meshgrid([0., 1.], [0., 1.], [0., 1.],
                                    indexing='ij'), -1).reshape(8, 3)


def aabb_lines(center, half, color=colors.soft_blue) -> PrimitivesPack:
    """Wireframe of one or more axis-aligned boxes.

    Args:
        center: [3] or [B, 3] box centers.
        half: scalar, [3], or [B, 3] half-extents.
    """
    center = np.atleast_2d(np.asarray(center, np.float32))
    half = np.broadcast_to(np.asarray(half, np.float32), center.shape)
    corners = (center[:, None, :]
               + (2.0 * _BOX_CORNERS[None] - 1.0) * half[:, None, :])
    start = corners[:, _BOX_EDGES[:, 0], :].reshape(-1, 3)
    end = corners[:, _BOX_EDGES[:, 1], :].reshape(-1, 3)
    pack = PrimitivesPack()
    pack.add_lines(start, end, color)
    return pack


def world_grid(squares_per_axis: int = 20, grid_size: float = 1.0,
               plane: str = 'xy', color=colors.gray) -> PrimitivesPack:
    """World-grid gizmo: a planar grid of squares spanning
    [-grid_size, grid_size] on the chosen plane."""
    axes = {'xy': (0, 1), 'xz': (0, 2), 'yz': (1, 2)}[plane]
    ticks = np.linspace(-grid_size, grid_size, squares_per_axis + 1,
                        dtype=np.float32)
    n = len(ticks)
    start = np.zeros((2 * n, 3), np.float32)
    end = np.zeros((2 * n, 3), np.float32)
    a, b = axes
    start[:n, a] = ticks
    start[:n, b] = -grid_size
    end[:n, a] = ticks
    end[:n, b] = grid_size
    start[n:, b] = ticks
    start[n:, a] = -grid_size
    end[n:, b] = ticks
    end[n:, a] = grid_size
    pack = PrimitivesPack()
    pack.add_lines(start, end, color)
    return pack


def axes_gizmo(length: float = 1.0, origin=(0.0, 0.0, 0.0)) -> PrimitivesPack:
    """World-axes gizmo: X red, Y green, Z blue."""
    o = np.asarray(origin, np.float32)
    pack = PrimitivesPack()
    for axis, color in enumerate((colors.red, colors.green, colors.blue)):
        e = o.copy()
        e[axis] += length
        pack.add_lines(o, e, color)
    return pack


def occupancy_wireframe(occ: np.ndarray, color=colors.soft_blue,
                        max_cells: int = 4096,
                        extent: float = 1.0) -> PrimitivesPack:
    """Wireframe of the occupied cells of a dense [R, R, R] occupancy grid
    (a bool array or tensor) spanning [-extent, extent].  Cells are
    subsampled uniformly beyond ``max_cells`` to bound the draw cost."""
    if isinstance(occ, torch.Tensor):
        occ = occ.cpu().numpy()
    occ = np.asarray(occ)
    r = occ.shape[0]
    idx = np.argwhere(occ)
    if len(idx) == 0:
        return PrimitivesPack()
    if len(idx) > max_cells:
        sel = np.linspace(0, len(idx) - 1, max_cells).astype(np.int64)
        idx = idx[sel]
    cell = 2.0 * extent / r
    center = (idx + 0.5) * cell - extent
    return aabb_lines(center, 0.5 * cell, color)
