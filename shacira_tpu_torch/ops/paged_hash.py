"""Spatially-paged hash-grid encode: block-local kernels B2 and B3.

Port of ``shacira_tpu/ops/paged_hash.py``.  In the ``'paged'`` hash layout
(``ops/hashgrid.py``) a hashed LOD's corner entries live in the page of
their coarse spatial bin, so samples grouped into blocks that share one
*grouping cell* (``page_res // 2`` per axis) read only the 4^3-page
neighbourhood of that cell; dense (direct-indexed) LODs read a small
per-cell window ("slab") of their table.

The JAX package computes this block-local encode with two Pallas kernels
written for the TPU (one-hot MXU matmuls over VMEM-resident windows):

* B2, ``_gather_kernel`` -- the forward: trilinear interpolation of the raw
  latents at every slot row for every direct and paged LOD;
* B3, ``_scatter_kernel`` -- its backward: the table gradient.

Here they are the CUDA kernels ``csrc/paged_hash.cu``.  In
``paged_gather`` a CUDA block takes the slots of one kernel block, a warp
32 consecutive slots at one LOD; the corner rows are built from per-axis
terms and read from the ``[T, ld]`` table directly.  It can also return
the fine occupancy row of ``fine_mode='kernel'`` (:func:`pack_occupancy`,
:func:`occupancy_row_plain`).  In ``paged_scatter`` one thread walks a
chain of ``CHAIN`` consecutive slots at one LOD and carries each corner's
update into the next slot's corner of the same row in registers before its
float atomics (:func:`chain_updates` and :func:`group_merge` mirror
that).  The TPU's staging of table windows (``_slab_tables``,
``occ_slab_tables``) and the fold of window partials back into the table
have no counterpart.  Beside each kernel is a plain PyTorch version of the
same function, clipping included; a CPU tensor takes it, a CUDA tensor
launches the kernel or raises.  Each wrapper counts its launches in the
counter registry (``launches/paged_gather``, of them
``launches/paged_gather_occupancy`` with the occupancy row,
``launches/paged_scatter``; ``utils/perf.py``).

Corner math, shared by kernels and plain versions:

* cell and fraction as ``hashgrid._cell_and_frac``;
* paged LODs: ``entry = fold_hash(xor_prime_hash(corner), E)``, page axis
  ``(corner * page_res) // res``, neighbourhood select
  ``psel = clip(page_axis - (2 c - 1), 0, 3)`` (``c`` the block's grouping
  cell) and page ``clip(2 c - 1 + psel, 0, page_res - 1)``; row
  ``page * E + entry``;
* direct LODs: the cell's slab window starts at
  ``clip(floor((c / group_res - margin) * res), 0, res - w)`` per axis and
  corner indices are clipped into ``[0, w - 1]`` of that window.

Under the cover condition (:func:`validate_paged_cover`) the clips never
bind and both equal the plain ``hashgrid`` encode of the paged spec.

The JAX kernels round table values (and direct-LOD weight products) to bf16
by default (``use_bf16=True``); the port computes in f32 throughout.  On the
card the gradient's summation order changes from run to run (atomics), so
it is not bitwise reproducible; the plain version is.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from shacira_tpu_torch.kernels import launch
from shacira_tpu_torch.ops.hashgrid import (
    PRIMES, HashGridSpec, _U32, _cell_and_frac, _corner_offsets,
    _corner_weights, fold_hash, paged_params, use_direct_index)
from shacira_tpu_torch.ops.scatter import scatter_add_plain
from shacira_tpu_torch.utils import perf

NEIGH = 4                 # pages per axis of a grouping cell's neighbourhood
N_NEIGH = NEIGH ** 3
# static segment-cover slack of the direct-LOD slab windows ([0,1] coords)
DIRECT_MARGIN = 1.0 / 32.0
MAX_LODS = 32             # LODs the kernels' parameter block holds


def group_res_of(page_res: int) -> int:
    return page_res // 2


def lod_is_paged(res: int, spec: HashGridSpec) -> bool:
    """True when a LOD takes the paged path: hashed, page-divisible table,
    and fine enough (res >= 2 * page_res) for the 4^3 page neighbourhood to
    cover every corner."""
    return (spec.dim == 3 and spec.hash_layout == 'paged'
            and paged_params(res, spec.codebook_size, spec.dim,
                             spec.page_res) is not None
            and res >= 2 * spec.page_res)


def paged_lods(spec: HashGridSpec):
    """(non_paged, paged) LOD index tuples; the paged LODs are a suffix."""
    flags = [lod_is_paged(r, spec) for r in spec.resolutions]
    pag = tuple(i for i, f in enumerate(flags) if f)
    non = tuple(i for i, f in enumerate(flags) if not f)
    if pag and min(pag) < max(non + (-1,)):
        raise ValueError(f'paged LODs {pag} are not a suffix of {flags}')
    return non, pag


def blocklocal_lods(spec: HashGridSpec):
    """(rest, direct, paged) LOD index tuples: ``direct`` (dense) and
    ``paged`` LODs run in the block-local kernels, ``rest`` (hashed but not
    pageable) through the plain encode."""
    non, pag = paged_lods(spec)
    direct = tuple(l for l in non if use_direct_index(
        spec.resolutions[l], spec.codebook_size, spec.dim))
    rest = tuple(l for l in non if l not in direct)
    return rest, direct, pag


def validate_paged_cover(spec: HashGridSpec, seg_half01: float):
    """Raise unless every paged LOD's corner pages provably lie in the 4^3
    neighbourhood of the sample's grouping cell
    (``2 * page_res * seg_half01 + page_res / res < 1``) and segments stay
    within the direct-LOD slab margin."""
    p = spec.page_res
    for res in spec.resolutions:
        if lod_is_paged(res, spec):
            margin = 2 * p * seg_half01 + p / res
            if margin >= 1.0:
                raise ValueError(
                    f'paged cover violated at res {res}: '
                    f'2*page_res*seg_half + page_res/res = {margin:.3f} >= 1; '
                    'shorten segments, lower page_res, or disable '
                    'hash_layout=paged')
    if seg_half01 > DIRECT_MARGIN:
        raise ValueError(
            f'segment half-length {seg_half01:.4f} (01 coords) exceeds the '
            f'direct-LOD slab margin {DIRECT_MARGIN}; shorten segments or '
            'disable hash_layout=paged')


def direct_slab_width(res: int, group_res: int = 8) -> int:
    """Cells per axis of a grouping cell's window at a direct LOD: every
    corner cell of a sample within ``DIRECT_MARGIN`` of the cell."""
    return min(int(np.ceil(res * (1.0 / group_res + 2.0 * DIRECT_MARGIN)))
               + 2, res)


@functools.lru_cache(maxsize=None)
def _slab_starts_np(res: int, group_res: int = 8):
    """([group_res] window starts per axis, width) of a direct LOD."""
    w = direct_slab_width(res, group_res)
    c = np.arange(group_res)
    lo = np.floor((c / group_res - DIRECT_MARGIN) * res).astype(np.int64)
    return np.clip(lo, 0, res - w).astype(np.int32), w


@functools.lru_cache(maxsize=None)
def _neighbor_pages_np(dim: int = 3, page_res: int = 16):
    """[n_cells, 64] global page ids of each grouping cell's 4^3 page
    neighbourhood (pages 2c-1 .. 2c+2 per axis, clamped), slot
    ``(i * 4 + j) * 4 + k``."""
    g = group_res_of(page_res)
    cells = np.arange(g ** 3)
    cx, cy, cz = cells // (g * g), (cells // g) % g, cells % g
    out = np.zeros((g ** 3, N_NEIGH), np.int32)
    for i in range(NEIGH):
        for j in range(NEIGH):
            for k in range(NEIGH):
                px = np.clip(2 * cx - 1 + i, 0, page_res - 1)
                py = np.clip(2 * cy - 1 + j, 0, page_res - 1)
                pz = np.clip(2 * cz - 1 + k, 0, page_res - 1)
                out[:, (i * NEIGH + j) * NEIGH + k] = (
                    px * page_res * page_res + py * page_res + pz)
    return out


# ---------------------------------------------------------------------------
# Segment grouping
# ---------------------------------------------------------------------------

def group_segments(centers01: torch.Tensor, live: torch.Tensor,
                   segs_per_block: int, n_blocks: int,
                   group_res: int = 8) -> dict:
    """Group live segments into blocks of ``segs_per_block`` that share a
    grouping cell, with no host sync (a stable sort and scatters).

    Args:
        centers01: [K, 3] segment centers in [0, 1].
        live: [K] bool.
        n_blocks: static block capacity (``ceil(K / spb) + n_cells`` never
            overflows).
    Returns dict: ``slotseg_to_seg`` [n_blocks * spb] int64 source segment
    per slot (K for padding), ``seg_to_slotseg`` [K] slot of each segment
    (``n_blocks * spb`` for dead ones), ``block_cell`` [n_blocks] int32
    (``n_cells`` for pad blocks), ``cell_used`` [n_cells] bool.
    """
    k = centers01.shape[0]
    dev = centers01.device
    spb = segs_per_block
    n_cells = group_res ** 3
    n_slotseg = n_blocks * spb
    c = torch.clamp(torch.floor(centers01 * group_res), 0,
                    group_res - 1).long()
    cell = (c[:, 0] * group_res + c[:, 1]) * group_res + c[:, 2]
    key = torch.where(live, cell, torch.full_like(cell, n_cells))
    skey, seg_order = torch.sort(key, stable=True)

    counts = torch.zeros((n_cells + 1,), dtype=torch.long, device=dev)
    counts.scatter_add_(0, key, torch.ones_like(key))
    blocks_per_cell = -(-counts[:n_cells] // spb)
    slot_base = (torch.cumsum(blocks_per_cell, 0) - blocks_per_cell) * spb
    cum_counts = torch.cumsum(counts, 0) - counts                 # exclusive
    rank = torch.arange(k, device=dev) - cum_counts[skey]
    slot = torch.where(skey < n_cells,
                       slot_base[torch.clamp(skey, max=n_cells - 1)] + rank,
                       torch.full_like(skey, n_slotseg))
    slot = torch.clamp(slot, max=n_slotseg)          # overflow -> dump slot
    slotseg_to_seg = torch.full((n_slotseg + 1,), k, dtype=torch.long,
                                device=dev)
    slotseg_to_seg.scatter_(0, slot, seg_order)
    slotseg_to_seg = slotseg_to_seg[:n_slotseg]
    seg_to_slotseg = torch.empty((k,), dtype=torch.long, device=dev)
    seg_to_slotseg.scatter_(0, seg_order, slot)

    first_seg = slotseg_to_seg[::spb]                             # [n_blocks]
    bcell = torch.where(first_seg < k,
                        key[torch.clamp(first_seg, max=k - 1)],
                        torch.full_like(first_seg, n_cells))
    return {'slotseg_to_seg': slotseg_to_seg,
            'seg_to_slotseg': seg_to_slotseg,
            'block_cell': bcell.to(torch.int32),
            'cell_used': counts[:n_cells] > 0}


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        n = x.shape[0]
        ctx.save_for_backward(inv_perm)
        out = x[torch.clamp(perm, max=n - 1)]
        return torch.where((perm < n)[:, None], out, torch.zeros_like(out))

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        m = g.shape[0]
        gx = g[torch.clamp(inv_perm, max=m - 1)]
        gx = torch.where((inv_perm < m)[:, None], gx, torch.zeros_like(gx))
        return gx, None, None


def permute_rows(x: torch.Tensor, perm: torch.Tensor,
                 inv_perm: torch.Tensor) -> torch.Tensor:
    """Differentiable row permutation with padding: ``out[i] = x[perm[i]]``
    (zeros where ``perm[i] >= len(x)``); the backward is a gather by
    ``inv_perm`` (the inverse over the valid range), not a scatter."""
    return _PermuteRows.apply(x, perm, inv_perm)


# ---------------------------------------------------------------------------
# Static description of the block-local encode
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PagedStatic:
    """Which LODs the block-local encode covers, and its geometry."""
    spec: HashGridSpec
    lods: tuple              # paged LOD indices
    direct_lods: tuple = ()  # direct LODs, through per-cell slab windows
    occ_res: int = 0         # >0: one more output row, the fine occupancy
                             # of a [occ_res]^3 grid (:func:`pack_occupancy`)

    @property
    def all_lods(self):
        """Output order: direct LODs (the coarser prefix), then paged."""
        return tuple(self.direct_lods) + tuple(self.lods)

    @property
    def page_res(self) -> int:
        return self.spec.page_res

    @property
    def group_res(self) -> int:
        return group_res_of(self.spec.page_res)

    @property
    def n_cells(self) -> int:
        return self.group_res ** 3

    @property
    def entries_per_page(self) -> int:
        if not self.lods:
            return 0
        return paged_params(self.spec.resolutions[self.lods[0]],
                            self.spec.codebook_size, 3, self.spec.page_res)[1]


def default_static(spec: HashGridSpec, occ_res: int = 0) -> PagedStatic:
    """The block-local encode of every direct and paged LOD (and, with
    ``occ_res``, the occupancy row)."""
    _, direct, pag = blocklocal_lods(spec)
    return PagedStatic(spec=spec, lods=pag, direct_lods=direct,
                       occ_res=occ_res)


# ---------------------------------------------------------------------------
# The occupancy row (fine_mode='kernel')
#
# B2 can also return, per slot, the fine occupancy of the sample's cell in a
# [res]^3 grid, so that the tracer's per-sample fine query rides the encode.
# The TPU kernel reads it from a per-grouping-cell window of the grid
# (``occ_slab_tables``, bits packed along z), clamping the cell into that
# window; the port reads the grid itself (:func:`pack_occupancy`) and clamps
# the same way, so the two agree bit for bit: x and y in cells to
# ``[0, w - 1]`` of the window, z in bytes to ``[0, wb - 1]`` with the bit
# taken from the unclamped ``z & 7``.  Outside ``[-1, 1]^3`` the row is 0.
# ---------------------------------------------------------------------------

def occ_slab_width(res: int, group_res: int = 8):
    """(cells w, z-bytes wb) of a grouping cell's occupancy window: every
    cell of a sample within ``DIRECT_MARGIN`` of the cell (no corner
    straddle, one cell of floor straddle)."""
    w = min(int(np.ceil(res * (1.0 / group_res + 2.0 * DIRECT_MARGIN))) + 1,
            res)
    return w, (w + 6) // 8 + 1


def occ_starts(c: torch.Tensor, res: int, group_res: int = 8) -> torch.Tensor:
    """Occupancy-window starts (cells) of grouping-cell coordinates ``c``:
    ``floor((c / group_res - DIRECT_MARGIN) * res)`` in integer arithmetic
    in units of 1/32, clipped to ``[0, res - w]``."""
    w, _ = occ_slab_width(res, group_res)
    m32 = round(DIRECT_MARGIN * 32)
    st = torch.div((c * (32 // group_res) - m32) * res, 32,
                   rounding_mode='floor')
    return torch.clamp(st, 0, res - w)


def pack_occupancy(occ: torch.Tensor) -> torch.Tensor:
    """Occupancy grid [res, res, res] bool (``[x, y, z]``) -> the layout the
    occupancy row reads: uint8 [res, res, res // 8 + 1], bit k of byte zb
    holding ``occ[x, y, 8 zb + k]``, and one zero byte past each z row (the
    last byte of a window at the grid's far side).  Trainers build it once
    per prune."""
    res = occ.shape[0]
    if occ.shape != (res, res, res) or res % 8:
        raise ValueError(f'occupancy [res]^3 with res % 8 == 0 expected, '
                         f'got {tuple(occ.shape)}')
    bits = occ.reshape(res, res, res // 8, 8).to(torch.uint8)
    weight = torch.ones((), dtype=torch.uint8, device=occ.device) << \
        torch.arange(8, dtype=torch.uint8, device=occ.device)
    packed = (bits * weight).sum(dim=-1).to(torch.uint8)
    return torch.nn.functional.pad(packed, (0, 1))


def occupancy_bytes(coords_s: torch.Tensor, c3: torch.Tensor, res: int,
                    group_res: int):
    """Where the occupancy row of each slot reads (grouping-cell
    coordinates ``c3`` [NS, 3]): the index [NS] of its byte in the flat
    packed grid, window clamps applied, its bit [NS], and whether the
    sample lies in ``[-1, 1]^3`` [NS].  The cell is
    ``accel/occupancy.query``'s: ``floor(clip((c * 0.5 + 0.5) * res, 0,
    f32(res - 1e-5)))``."""
    w, wb = occ_slab_width(res, group_res)
    c = coords_s.float()
    x = torch.clamp((c * 0.5 + 0.5) * res, 0.0,
                    float(np.float32(res - 1e-5)))
    pos = torch.floor(x).long()
    inside = torch.all((c >= -1.0) & (c <= 1.0), dim=-1)
    st = occ_starts(c3, res, group_res)
    cell = st + torch.clamp(pos - st, 0, w - 1)              # x, y used
    zb0 = st[:, 2] >> 3
    zb = zb0 + torch.clamp((pos[:, 2] >> 3) - zb0, 0, wb - 1)
    index = (cell[:, 0] * res + cell[:, 1]) * (res // 8 + 1) + zb
    return index, pos[:, 2] & 7, inside


def occupancy_row_plain(coords_s: torch.Tensor, c3: torch.Tensor,
                        occ_packed: torch.Tensor, res: int,
                        group_res: int) -> torch.Tensor:
    """[NS] f32 in {0, 1}: the fine occupancy of each slot's cell read
    through its block's window (:func:`occupancy_bytes`), 0 outside
    ``[-1, 1]^3``."""
    index, bit, inside = occupancy_bytes(coords_s, c3, res, group_res)
    byte = occ_packed.reshape(-1)[index].long()
    return ((byte >> bit) & 1).float() * inside.float()


# B2 divides by each paged LOD's resolution through a multiply-high
# reciprocal: ((c * page_res) * recip) >> 32 == (c * page_res) // res for
# every numerator below RECIP_NUM_LIMIT and res up to RECIP_RES_LIMIT (held
# exhaustively by a CPU test); _kernel_params refuses anything beyond.
RECIP_RES_LIMIT = 2048
RECIP_NUM_LIMIT = 1 << 16


def page_recip(res: int) -> int:
    """``ceil(2^32 / res)``, B2's reciprocal of a paged LOD's resolution."""
    return -(-(1 << 32) // res)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of B2 and B3
# ---------------------------------------------------------------------------

def _slot_cells(block_cell: torch.Tensor, ns: int, g: int):
    """Per-slot block cell id [NS] (pads clamped to a valid cell) and its
    three grouping-cell coordinates [NS, 3], plus the live-slot mask of
    non-pad blocks [NS]."""
    b = ns // block_cell.shape[0]
    bc = block_cell.long()[:, None].expand(-1, b).reshape(-1)
    live = bc < g ** 3
    bc = torch.clamp(bc, max=g ** 3 - 1)
    c3 = torch.stack([bc // (g * g), (bc // g) % g, bc % g], dim=-1)
    return bc, c3, live


def _lod_rows(coords_s, bc, c3, lod, static: PagedStatic):
    """Global table rows [NS, 8] and weights [NS, 8] of one LOD's corners,
    clipped as the kernels clip them."""
    spec = static.spec
    res = spec.resolutions[lod]
    dev = coords_s.device
    pos, frac = _cell_and_frac(coords_s, res)
    offs = _corner_offsets(spec, dev)                         # [8, 3]
    w = _corner_weights(frac, spec)
    if lod in static.direct_lods:
        starts, width = _slab_starts_np(res, static.group_res)
        st = torch.as_tensor(starts, dtype=torch.long, device=dev)[c3]
        local = torch.clamp((pos - st)[:, None, :] + offs[None], 0, width - 1)
        cell = st[:, None, :] + local
        row = cell[..., 0] + cell[..., 1] * res + cell[..., 2] * res * res
    else:
        p = static.page_res
        e = static.entries_per_page
        cp = pos[:, None, :] + offs[None]                     # [NS, 8, 3]
        acc = (cp[..., 0] * PRIMES[0]) & _U32
        for d in range(1, 3):
            acc = acc ^ ((cp[..., d] * PRIMES[d]) & _U32)
        ent = fold_hash(acc, e)
        pax = torch.div(cp * p, res, rounding_mode='floor')
        psel = torch.clamp(pax - (2 * c3[:, None, :] - 1), 0, NEIGH - 1)
        slot = (psel[..., 0] * NEIGH + psel[..., 1]) * NEIGH + psel[..., 2]
        neigh = torch.as_tensor(_neighbor_pages_np(3, p), dtype=torch.long,
                                device=dev)
        row = neigh[bc[:, None], slot] * e + ent
    return row + spec.lod_first_idx[lod], w


CHAIN = 16        # CHAIN of csrc/paged_hash.cu: slots a B3 thread walks
GROUP = 8         # kGroup there: corners of a slot


def group_merge(keys: torch.Tensor, vals: torch.Tensor):
    """Plain mirror of B3's merge (``GroupMerge`` in ``csrc/paged_hash.cu``).

    Row ``i`` of ``keys`` [T, K] (int64, negative = no update; K a multiple
    of ``GROUP``) and ``vals`` [T, K] is what thread ``i`` walks, a slot's
    ``GROUP`` corners at a time.  Equal keys of a group merge into their
    first occurrence; a held pair whose key reappears in the next group
    joins it, the others are issued; a group without a key changes
    nothing.  Returns the (keys [M], sums [M]) that reach the table, one
    global atomic each (sums that are exactly zero are dropped, as the
    kernel drops them).  A ``cuda`` test holds their count to the atomics
    the kernel's counting build issues."""
    t = keys.shape[0]
    keys = keys.reshape(t, -1, GROUP)
    vals = vals.float().reshape(t, -1, GROUP)
    first = torch.ones((GROUP, GROUP), dtype=torch.bool,
                       device=keys.device).tril(-1)          # i < j
    held_k = torch.full((t, GROUP), -1, dtype=torch.long, device=keys.device)
    held_v = torch.zeros((t, GROUP), device=keys.device)
    out_k, out_v = [], []
    for gi in range(keys.shape[1]):
        k, v = keys[:, gi], vals[:, gi]
        live = k >= 0
        has = live.any(dim=1)
        same = (k[:, :, None] == k[:, None, :]) & live[:, :, None]
        # j merges into the first i < j with its key
        dup = (same & first).any(dim=2)
        owner = torch.argmax((same & (first | torch.eye(
            GROUP, dtype=torch.bool, device=k.device))).int(), dim=2)
        v = torch.zeros_like(v).scatter_add_(1, owner, torch.where(live, v,
                                                                   0.0))
        k = torch.where(dup, -1, k)
        # held pairs whose key reappears join it
        match = ((held_k[:, :, None] == k[:, None, :])
                 & (held_k >= 0)[..., None])
        v = v + (match * held_v[..., None]).sum(dim=1)
        gone = (held_k >= 0) & ~match.any(dim=2) & has[:, None]
        out_k.append(held_k[gone])
        out_v.append(held_v[gone])
        held_k = torch.where(has[:, None], k, held_k)
        held_v = torch.where(has[:, None], v, held_v)
    out_k = torch.cat(out_k + [held_k.reshape(-1)])
    out_v = torch.cat(out_v + [held_v.reshape(-1)])
    keep = (out_k >= 0) & (out_v != 0)
    return out_k[keep], out_v[keep]


def chain_updates(coords_s, slot_valid, block_cell, g, static: PagedStatic,
                  li: int, d: int = 0):
    """Plain mirror of B3's walk at output LOD ``li`` and column ``d``: the
    (LOD-local row, w * g) groups [n_chains, CHAIN * 8] each thread hands
    to its merge (:func:`group_merge`), slot by slot; pad blocks, invalid
    slots, zero gradients and padding past the last slot carry row -1 (the
    kernel skips them)."""
    ns = coords_s.shape[0]
    lod = static.all_lods[li]
    bc, c3, live = _slot_cells(block_cell, ns, static.group_res)
    rows, w = _lod_rows(coords_s.float(), bc, c3, lod, static)
    gv = g[:, li, d:d + 1].float()
    keep = (live & slot_valid)[:, None] & (gv != 0)
    rows = torch.where(keep, rows - static.spec.lod_first_idx[lod], -1)
    vals = torch.where(keep, w * gv, 0.0)
    pad = -ns % CHAIN
    rows = torch.nn.functional.pad(rows, (0, 0, 0, pad), value=-1)
    vals = torch.nn.functional.pad(vals, (0, 0, 0, pad))
    return rows.reshape(-1, CHAIN * 8), vals.reshape(-1, CHAIN * 8)


def paged_gather_plain(coords_s, slot_valid, block_cell, z,
                       static: PagedStatic, occ=None) -> torch.Tensor:
    """Plain version of B2: [NS, L, ld] f32 interpolated latents of
    ``static.all_lods`` at the slot coords, and with ``static.occ_res`` one
    more row (every column) holding the occupancy row read from ``occ``
    (:func:`pack_occupancy`); pad blocks and invalid slots give 0."""
    ns, ld = coords_s.shape[0], z.shape[-1]
    bc, c3, live = _slot_cells(block_cell, ns, static.group_res)
    keep = (live & slot_valid).float()[:, None]
    table = z.float()
    out = []
    for lod in static.all_lods:
        rows, w = _lod_rows(coords_s.float(), bc, c3, lod, static)
        out.append(torch.sum(table[rows] * w[..., None], dim=1) * keep)
    if static.occ_res:
        row = occupancy_row_plain(coords_s, c3, occ, static.occ_res,
                                  static.group_res)
        out.append(row[:, None].expand(-1, ld) * keep)
    if not out:
        return torch.zeros((ns, 0, ld), device=z.device)
    return torch.stack(out, dim=1)


def paged_scatter_plain(coords_s, slot_valid, block_cell, g,
                        static: PagedStatic) -> torch.Tensor:
    """Plain version of B3: the [T, ld] f32 table gradient of
    :func:`paged_gather_plain` for the output gradient ``g`` [NS, L, ld]."""
    ns, ld = coords_s.shape[0], g.shape[-1]
    bc, c3, live = _slot_cells(block_cell, ns, static.group_res)
    keep = (live & slot_valid).float()[:, None]
    rows_all, vals_all = [], []
    for li, lod in enumerate(static.all_lods):
        rows, w = _lod_rows(coords_s.float(), bc, c3, lod, static)
        vals = w[..., None] * (g[:, li].float() * keep)[:, None, :]
        rows_all.append(rows.reshape(-1))
        vals_all.append(vals.reshape(-1, ld))
    if not rows_all:
        return torch.zeros((static.spec.total_size, ld), device=g.device)
    return scatter_add_plain(torch.cat(rows_all), torch.cat(vals_all),
                             static.spec.total_size)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

class _KernelParams(ctypes.Structure):
    """Mirror of ``struct PagedParams`` in ``csrc/paged_hash.cu``."""
    _fields_ = [('n_lods', ctypes.c_int), ('n_direct', ctypes.c_int),
                ('res', ctypes.c_int * MAX_LODS),
                ('width', ctypes.c_int * MAX_LODS),
                ('hi', ctypes.c_float * MAX_LODS),
                ('row_off', ctypes.c_longlong * MAX_LODS),
                ('entries', ctypes.c_int), ('page_res', ctypes.c_int),
                ('group_res', ctypes.c_int), ('margin32', ctypes.c_int),
                ('ld', ctypes.c_int), ('block_rows', ctypes.c_int),
                ('recip', ctypes.c_uint * MAX_LODS),
                ('occ', ctypes.c_void_p), ('occ_res', ctypes.c_int),
                ('occ_w', ctypes.c_int), ('occ_wb', ctypes.c_int),
                ('occ_hi', ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def _kernel_params(static: PagedStatic, ld: int, block_rows: int):
    lods = static.all_lods
    g = static.group_res
    spec = static.spec
    if len(lods) > MAX_LODS:
        raise ValueError(f'{len(lods)} LODs: the kernels take {MAX_LODS}')
    if 32 % g:
        raise NotImplementedError(
            'the paged kernels compute slab starts in integer arithmetic '
            'in units of 1/32: group_res must divide 32')
    if spec.total_size * ld >= 2 ** 31:
        raise ValueError('the paged kernels index the table in int32')
    p = _KernelParams()
    p.n_lods, p.n_direct = len(lods), len(static.direct_lods)
    for i, lod in enumerate(lods):
        res = spec.resolutions[lod]
        p.res[i] = res
        p.hi[i] = float(np.float32(res - 1 - 1e-5))
        p.row_off[i] = spec.lod_first_idx[lod]
        if i < p.n_direct:
            p.width[i] = direct_slab_width(res, g)
        else:
            if (res > RECIP_RES_LIMIT
                    or (res - 1) * static.page_res >= RECIP_NUM_LIMIT):
                raise ValueError(
                    f'paged LOD res {res}: the page-axis reciprocal is '
                    f'exact up to res {RECIP_RES_LIMIT} and numerators '
                    f'below {RECIP_NUM_LIMIT}')
            p.recip[i] = page_recip(res)
    p.entries = static.entries_per_page
    p.page_res, p.group_res = static.page_res, g
    p.margin32 = round(DIRECT_MARGIN * 32)
    p.ld, p.block_rows = ld, block_rows
    if static.occ_res:
        p.occ_res = static.occ_res
        p.occ_w, p.occ_wb = occ_slab_width(static.occ_res, g)
        p.occ_hi = float(np.float32(static.occ_res - 1e-5))
    return p


def _check(coords_s, slot_valid, block_cell, static):
    ns = coords_s.shape[0]
    if coords_s.dim() != 2 or coords_s.shape[1] != 3:
        raise ValueError(f'coords_s [NS, 3] expected, got '
                         f'{tuple(coords_s.shape)}')
    if slot_valid.shape != (ns,) or block_cell.dim() != 1:
        raise ValueError('slot_valid [NS] and block_cell [NB] expected')
    if ns % block_cell.shape[0]:
        raise ValueError(f'{ns} slots do not split into '
                         f'{block_cell.shape[0]} blocks')
    if static.spec.dim != 3:
        raise ValueError('the paged encode is 3D only')


_GATHER = launch.Entry('paged_hash', 'paged_gather', 'pppppq', _KernelParams)
_SCATTER = launch.Entry('paged_hash', 'paged_scatter', 'pppppq', _KernelParams)


def _launch(entry, coords_s, slot_valid, block_cell, src, dst, static,
            lib=None, occ=None):
    """Launch ``entry`` (B2 or B3) of ``lib`` (default: the kernels built
    from ``csrc/paged_hash.cu``) on the current stream; ``occ`` is the
    packed occupancy grid of B2's occupancy row."""
    ns = coords_s.shape[0]
    params = _kernel_params(static, dst.shape[-1], ns // block_cell.shape[0])
    if occ is not None:
        params = _KernelParams.from_buffer_copy(params)
        params.occ = occ.data_ptr()
    entry(coords_s.device, coords_s.data_ptr(), slot_valid.data_ptr(),
          block_cell.data_ptr(), src.data_ptr(), dst.data_ptr(), ns, params,
          lib=lib)


def _device_inputs(coords_s, slot_valid, block_cell):
    return (coords_s.to(torch.float32).contiguous(),
            slot_valid.to(torch.bool).contiguous(),
            block_cell.to(torch.int32).contiguous())


def _check_occ(static: PagedStatic, occ):
    if not static.occ_res:
        return None
    res = static.occ_res
    if occ is None or tuple(occ.shape) != (res, res, res // 8 + 1) \
            or occ.dtype != torch.uint8:
        raise ValueError(f'the occupancy row needs the packed grid uint8 '
                         f'[{res}, {res}, {res // 8 + 1}] (pack_occupancy)')
    return occ.contiguous()


def paged_gather(coords_s, slot_valid, block_cell, z, static: PagedStatic,
                 occ=None) -> torch.Tensor:
    """B2: [NS, L(+1), ld] f32 latents of ``static.all_lods`` at the slot
    coords (and the occupancy row, read from ``occ``, when
    ``static.occ_res``).  CPU tensors take :func:`paged_gather_plain`;
    CUDA tensors launch the kernel."""
    _check(coords_s, slot_valid, block_cell, static)
    occ = _check_occ(static, occ)

    def kernel():
        out = _launch_gather(coords_s, slot_valid, block_cell, z, static, occ)
        if out.numel() and occ is not None:
            perf.count('launches/paged_gather_occupancy', 1)
        return out, int(out.numel() > 0)

    return launch.dispatch(
        'paged_gather', z.device, lambda: paged_gather_plain(
            coords_s, slot_valid, block_cell, z, static, occ), kernel)


def _launch_gather(coords_s, slot_valid, block_cell, z, static: PagedStatic,
                   occ=None, lib=None) -> torch.Tensor:
    """Launch ``paged_gather`` of ``lib`` (default: the kernel built from
    ``csrc/paged_hash.cu``) into a fresh [NS, L(+1), ld] output."""
    ns, ld = coords_s.shape[0], z.shape[-1]
    rows = len(static.all_lods) + (1 if static.occ_res else 0)
    out = torch.empty((ns, rows, ld), dtype=torch.float32, device=z.device)
    if out.numel() == 0:
        return out
    coords_s, slot_valid, block_cell = _device_inputs(coords_s, slot_valid,
                                                      block_cell)
    _launch(_GATHER, coords_s, slot_valid, block_cell,
            z.to(torch.float32).contiguous(), out, static, lib, occ)
    return out


def paged_scatter(coords_s, slot_valid, block_cell, g,
                  static: PagedStatic) -> torch.Tensor:
    """B3: the [T, ld] f32 table gradient of :func:`paged_gather` for the
    output gradient ``g`` [NS, L, ld].  CPU tensors take
    :func:`paged_scatter_plain`; CUDA tensors launch the kernel."""
    _check(coords_s, slot_valid, block_cell, static)
    return launch.dispatch(
        'paged_scatter', g.device,
        lambda: paged_scatter_plain(coords_s, slot_valid, block_cell, g,
                                    static),
        lambda: (_launch_scatter(coords_s, slot_valid, block_cell, g, static),
                 int(g.numel() > 0)))


def _launch_scatter(coords_s, slot_valid, block_cell, g, static: PagedStatic,
                    lib=None) -> torch.Tensor:
    """Launch ``paged_scatter`` of ``lib`` (default: the kernel built from
    ``csrc/paged_hash.cu``) into a fresh zero-filled f32 table gradient."""
    grad = torch.zeros((static.spec.total_size, g.shape[-1]),
                       dtype=torch.float32, device=g.device)
    if g.numel() == 0:
        return grad
    coords_s, slot_valid, block_cell = _device_inputs(coords_s, slot_valid,
                                                      block_cell)
    _launch(_SCATTER, coords_s, slot_valid, block_cell,
            g.to(torch.float32).contiguous(), grad, static, lib)
    return grad


class _PagedInterp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords_s, slot_valid, block_cell, z, static, occ):
        ctx.save_for_backward(coords_s, slot_valid, block_cell)
        ctx.static = static
        ctx.z_dtype = z.dtype
        return paged_gather(coords_s, slot_valid, block_cell, z, static, occ)

    @staticmethod
    def backward(ctx, g):
        coords_s, slot_valid, block_cell = ctx.saved_tensors
        static = ctx.static
        with record_function('backward/encode'):
            # the occupancy row has no gradient: B3 sees the latent rows
            g = g[:, :len(static.all_lods)].contiguous()
            grad = paged_scatter(coords_s, slot_valid, block_cell, g,
                                 static).to(ctx.z_dtype)
        return None, None, None, grad, None, None


def paged_interp_lods(coords_s: torch.Tensor, slot_valid: torch.Tensor,
                      block_cell: torch.Tensor, z: torch.Tensor,
                      static: PagedStatic, occ=None) -> torch.Tensor:
    """Interpolate the block-local LODs' latents at slotted sample coords.

    Args:
        coords_s: [NS, 3] slot coords in [-1, 1] (NS = n_blocks * B).
        slot_valid: [NS] bool.
        block_cell: [n_blocks] int32 grouping cell (``n_cells`` for pads).
        z: [total_size, ld] full latent table (only the covered LODs' rows
            are read; the gradient is zero elsewhere).
        occ: with ``static.occ_res``, the packed occupancy grid
            (:func:`pack_occupancy`).
    Returns: [NS, len(static.all_lods) (+1), ld] f32 in ascending LOD order,
        then the occupancy row in {0, 1} when ``static.occ_res`` (invalid
        slots zero).  Forward B2, backward B3.
    """
    return _PagedInterp.apply(coords_s, slot_valid, block_cell, z, static,
                              occ)
