"""Radiance-field tracer: 'ray' march + masked volume integration.

Port of the ``'ray'`` branches of ``shacira_tpu/tracers/rf_tracer.py``.
Every ray carries a fixed sample axis with a boolean mask (masked samples
add no optical thickness); with ``max_samples`` the field is evaluated only
on up to K occupied samples (budgeted stride compaction) and integrated in
compact form, the per-ray sums running through the scatter kernel
(``ops/scatter.segment_sum``).

The segmented march (``segment_size > 0``): segments of ``segment_size``
samples are culled at their midpoint against a dilated coarse occupancy
grid and compacted to ``seg_budget``.  With ``fine_mode='exact'`` every
sample of those segments is fine-queried; without a paged encode split the
live rows are compacted to ``max_samples`` and evaluated (flat layout),
with one the fine-live segments are compacted to ``eval_seg_budget``
(``_stage2_take``).  The paged branch (``eval_seg_budget > 0`` and a 3-way
``encode_split``) groups the stage-2 segments by grouping cell
(``ops/paged_hash.group_segments``), encodes all their rows block-locally,
compacts rows to ``max_samples`` and finishes (direct decode, head) there.
``fine_mode='deferred'`` takes a strided prefix of the coarse-live
segments and fine-queries only those; ``'kernel'`` moves that fine query
into the encode (kernel B2's occupancy row): grouping keeps the
sub-segments whose midpoint lies in a dilated fine cell
(``occ_state['fine_dil']``), and the row compaction runs after the encode.

Lean stage 1 (``lean_stage1``, ``'deferred'``): segment midpoints are
analytic, stage 1 compacts straight to ``eval_seg_budget`` and the
survivors' depths come from a counter hash of (step seed, segment, sample);
with ``super_factor > 1`` a super-segment cull runs first.  With
``term_tau > 0`` segments behind an estimated optical depth of ``term_tau``
(from the occupancy's decayed-max density) are culled too.  Budgets and
strides stay device tensors: no host sync.

Integration (exclusive transmittance):
    tau_i = density_i * delta_i * mask_i
    T_i   = exp(-sum_{j<i} tau_j)
    w_i   = T_i * (1 - exp(-tau_i))
    rgb = sum w_i c_i ; alpha = sum w_i ; depth = sum w_i t_i
White background: rgb + (1 - alpha); black: alpha * rgb.

The 'voxel' march (``raymarch_type='voxel'``) walks each ray through the
occupancy grid with the bounded DDA (``accel/occupancy.voxel_crossings``,
kernel V1 on the card) and samples ``num_steps`` points inside each of its
first ``max_intersections`` occupied crossings.  Densely, every sample is
evaluated (masked) or, with ``max_samples``, the occupied ones compacted.
On the paged layout (``eval_seg_budget > 0``, ``max_samples > 0``) a
crossing is a segment: the crossings are stride-compacted to
``eval_seg_budget`` before any sample exists (:func:`_trace_voxel_fused`)
and their ``num_steps`` samples go through :func:`_trace_paged`; with
``term_tau`` the crossings behind an estimated optical depth of
``term_tau`` are dropped first (:func:`crossing_term_mask`).

A field returns (rgb, density) or (rgb, density, extras), ``extras`` a
dict of per-sample channels ``{name: [..., k]}``: the dense and the flat
compact paths (the 'ray' and 'voxel' marches, and the flat segmented march)
integrate each with the rgb's weights into an ``[R, k]`` buffer of that
name, the compact path in the same ``segment_sum`` payload as rgb, alpha
and depth; the paged trace's head returns (rgb, density) only, as in the
JAX tracer.

While a profiler records, a training step's flat compaction counts its
live samples, those kept under the budget and the budget's slots
(``trace/live_samples``, ``trace/kept_samples``, ``trace/slots`` in
``utils/perf.py``); the dense trace (no budget) keeps every live sample
and has a slot for every march sample.  Renders, which take no gradient,
count nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from shacira_tpu_torch.accel import occupancy as occ
from shacira_tpu_torch.core.rays import Rays
from shacira_tpu_torch.ops import paged_hash as ph
from shacira_tpu_torch.ops.scatter import segment_sum
from shacira_tpu_torch.utils import perf


@dataclass(frozen=True)
class RFTracerConfig:
    raymarch_type: str = 'ray'     # 'ray' | 'voxel'
    num_steps: int = 64
    bg_color: str = 'white'
    max_intersections: int = 64    # 'voxel': DDA crossings kept per ray
    max_samples: int = 0           # >0: compact to K occupied samples
    # segmented march (paged layout): samples per culling segment
    segment_size: int = 0
    seg_budget: int = 0            # live-segment budget (0: 8*max_samples/G)
    coarse_level: int = 5          # coarse culling grid res = 2**level
    seg_dilation: int = 1          # coarse-cell dilation radius
    eval_seg_budget: int = 0       # second-stage segment budget (paged)
    group_segs_per_block: int = 8  # segments per paged-kernel block
    group_res: int = 8             # grouping cells per axis (page_res // 2)
    group_seg_size: int = 0        # samples per grouped sub-segment (0: G)
    fine_mode: str = 'exact'       # 'exact' | 'deferred' | 'kernel'
    # transmittance culling: drop segments whose estimated optical depth
    # in front of them exceeds term_tau (0 disables)
    term_tau: float = 0.0
    # two-level cull (lean stage 1 only): super-segments of super_factor
    # segments tested first on a super_dilation-dilated grid
    super_factor: int = 0
    super_dilation: int = 0
    lean_stage1: bool = False      # analytic midpoints, hashed jitter

    def __post_init__(self):
        if self.raymarch_type not in ('ray', 'voxel'):
            raise ValueError(f'raymarch_type {self.raymarch_type!r}')
        if self.lean_stage1 and self.fine_mode == 'kernel':
            # the reference's lean march takes a (2,) seed, but its
            # march_jitter_shape hands 'kernel' an [R, num_steps] array,
            # which _lean_seed feeds to jax.random.randint as a key
            raise ValueError(
                "fine_mode='kernel' with lean_stage1 crashes in the "
                'reference (shacira_tpu/tracers/rf_tracer.py:134: its '
                '[R, num_steps] jitter reaches _lean_seed as a PRNG key), '
                "so it has no counterpart; use fine_mode='deferred'")


def march_jitter_shape(cfg: RFTracerConfig, num_rays: int):
    """Shape of the U(0,1) march jitter :func:`trace` consumes: [R,
    max_intersections, num_steps] for the voxel march, two uniforms (its
    step seed) for the lean march, [R, num_steps] for the others."""
    if cfg.raymarch_type == 'voxel':
        return (num_rays, cfg.max_intersections, cfg.num_steps)
    if cfg.lean_stage1 and cfg.fine_mode == 'deferred':
        return (2,)
    return (num_rays, cfg.num_steps)


def _lean_seed(u: torch.Tensor) -> torch.Tensor:
    """uint32 step seed (an int64 tensor in [0, 2^32)) from the (2,)
    U(0,1) array of :func:`march_jitter_shape`: 16 bits from each."""
    if tuple(u.shape) != (2,) or not u.is_floating_point():
        raise ValueError(f'the lean march takes a (2,) float jitter, got '
                         f'{tuple(u.shape)} {u.dtype}')
    lo = torch.floor(u[0] * 65536.0).long()
    hi = torch.floor(u[1] * 65536.0).long()
    return lo | (hi << 16)


_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``x`` in [0, 2^32) as int64, with ``c`` split
    in 16-bit halves so that no product passes 2^49 (int64 has no
    unsigned wrap, and PyTorch's uint32 lacks multiplication)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _hash01(seed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Counter-hash jitter: the murmur3-style uint32 mix of ``idx + seed``
    -> U[0, 1) in f32, bit for bit the JAX function's (its uint32 products
    wrap; the uint32 -> f32 conversion rounds to nearest even, so values
    near 2^32 give 1.0 on both sides)."""
    x = (idx.long() + seed) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (2.0 ** -32)


def per_device_cfg(cfg: RFTracerConfig, n: int) -> RFTracerConfig:
    """Tracer config of one rank of a mesh of ``n`` that traces its ``R/n``
    rays on its own.

    Rays are independent, so each rank runs the whole trace -- march,
    budgeted compactions, segment grouping, B2/B3, compact integration --
    on its rays with every global row budget divided by ``n``; ray and
    segment ids, and the lean march's hash counter, are the rank's own.
    Per-ray quantities (num_steps, max_intersections, segment geometry)
    are unchanged.  With budgets ample enough that nothing truncates, the
    ranks integrate exactly the samples of one trace of all the rays;
    under budget pressure the stride drop applies per rank instead of
    globally (the same uniform drop, rank-local).  A budget <= 0 passes
    through.

    Raises ValueError when a budget does not divide ``n`` (the trainer
    then traces the whole batch on every rank)."""
    def div(v: int, name: str) -> int:
        if v <= 0:
            return v
        if v % n:
            raise ValueError(f'{name}={v} must divide the mesh size {n} '
                             f'for a per-rank trace')
        return v // n

    return replace(cfg, max_samples=div(cfg.max_samples, 'max_samples'),
                   seg_budget=div(cfg.seg_budget, 'seg_budget'),
                   eval_seg_budget=div(cfg.eval_seg_budget,
                                       'eval_seg_budget'))


def integration_weights(density, deltas, mask):
    """Per-sample volume-rendering weights (exclusive transmittance)."""
    tau = density * deltas * mask
    cum = torch.cumsum(tau, dim=-1)
    return torch.exp(-(cum - tau)) * (1.0 - torch.exp(-tau))


def volume_integrate(color, density, deltas, depth, mask):
    """Dense masked integration: color [R,S,3], the rest [R,S] ->
    rgb [R,3], alpha [R,1], depth [R,1]."""
    w = integration_weights(density, deltas, mask)
    rgb = torch.sum(w[..., None] * color, dim=-2)
    alpha = torch.sum(w, dim=-1, keepdim=True)
    depth_out = torch.sum(w * depth, dim=-1, keepdim=True)
    return rgb, alpha, depth_out


def _stride_compact(flat_mask: torch.Tensor, budget: int):
    """Budgeted stable compaction of a boolean mask [n].

    On overflow, keep every ``stride``-th live row so the kept rows stay
    uniformly spread.  Returns (src [budget] int64 source positions,
    valid [budget] bool, slots [n] int64: the slot of each source row, or
    ``budget`` for dropped rows)."""
    return _stride_compact_counts(flat_mask, budget)[:3]


def _stride_compact_counts(flat_mask: torch.Tensor, budget: int):
    """:func:`_stride_compact`'s three results, then the live rows and
    the rows kept, device int64 scalars."""
    n = flat_mask.shape[0]
    dev = flat_mask.device
    cs = torch.cumsum(flat_mask.long(), dim=0)                 # inclusive
    total = cs[-1]
    stride = torch.clamp(-(-total // budget), min=1)           # ceil div
    pos = cs - 1                                               # live rank
    q = torch.div(pos, stride, rounding_mode='floor')
    kept = flat_mask & (pos - q * stride == 0) & (q < budget)
    slots = torch.where(kept, q, torch.full_like(q, budget))
    # rows dropped by the budget land in a dump slot that is cut off
    src = torch.zeros((budget + 1,), dtype=torch.long, device=dev)
    src.scatter_(0, slots, torch.arange(n, device=dev))
    n_keep = -(-total // stride)
    valid = torch.arange(budget, device=dev) < torch.clamp(n_keep, max=budget)
    return src[:budget], valid, slots, total, n_keep


def _segmented_excl_f64(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of ``x`` [K] restarting at ``start`` [K] bool
    (``start[0]`` must be True), as a float64 global cumsum minus each
    segment's base: float64 keeps the cancellation far below f32
    resolution over a million rows."""
    k = x.shape[0]
    c = torch.cumsum(x.double(), dim=0) - x.double()           # global excl
    seg = torch.cumsum(start.long(), dim=0) - 1                # segment no.
    # position of each segment's head (non-heads write a dump slot); this
    # avoids torch.cummax, whose CUDA scan is far slower than cumsum
    head = torch.zeros((k + 1,), dtype=torch.long, device=x.device)
    head.scatter_(0, torch.where(start, seg, torch.full_like(seg, k)),
                  torch.arange(k, device=x.device))
    return (c - c[head[seg]]).to(x.dtype)


class _SegmentedCumsumExcl(torch.autograd.Function):
    """Per-segment exclusive prefix sum.  Its transpose -- the backward --
    is the reverse-order exclusive prefix sum within each segment, so
    neither direction scatters."""

    @staticmethod
    def forward(ctx, tau, ray_start):
        ctx.save_for_backward(ray_start)
        return _segmented_excl_f64(tau, ray_start)

    @staticmethod
    def backward(ctx, g):
        (ray_start,) = ctx.saved_tensors
        ray_end = torch.cat([ray_start[1:], ray_start.new_ones((1,))])
        rev = _segmented_excl_f64(torch.flip(g, (0,)),
                                  torch.flip(ray_end, (0,)))
        return torch.flip(rev, (0,)), None


def _segmented_cumsum_excl(tau: torch.Tensor,
                           ray_start: torch.Tensor) -> torch.Tensor:
    """Exclusive per-segment prefix sum of ``tau`` [K]; segments begin where
    ``ray_start`` is True."""
    return _SegmentedCumsumExcl.apply(tau, ray_start)


def _eval_field(field_fn, coords, dirs):
    """A field's outputs as (color, density, extras dict): ``field_fn``
    returns (color, density) or (color, density, extras)."""
    out = field_fn(coords, dirs)
    if len(out) == 3:
        return out
    color, density = out
    return color, density, {}


def volume_integrate_compact(color, density, deltas, depth, valid, ray_id,
                             num_rays: int, extras=None) -> dict:
    """Compact-form masked volume integration.

    Rows are sorted by (ray, depth) over the valid prefix (the invariant of
    :func:`_stride_compact`); invalid tail rows add nothing.  Equal to
    :func:`volume_integrate` on a dense scatter-back of the rows.

    Args: color [K,3], density [K], deltas [K], depth [K], valid [K] bool,
        ray_id [K] int, num_rays R; extras: optional {name: [K, k]}
        per-sample channels, summed as ``w * extra`` in the same payload.
    Returns: dict rgb [R,3], alpha [R,1], depth [R,1] and one [R, k] entry
        per extra channel, before background compositing.
    """
    tau = density * deltas * valid.to(density.dtype)
    ray_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                      device=ray_id.device),
                           ray_id[1:] != ray_id[:-1]])
    transmittance = torch.exp(-_segmented_cumsum_excl(tau, ray_start))
    w = transmittance * (1.0 - torch.exp(-tau))     # 0 exactly when invalid
    cols = [w[:, None] * color, w[:, None], (w * depth)[:, None]]
    extras = extras or {}
    cols += [w[:, None] * v for v in extras.values()]
    sums = segment_sum(ray_id, torch.cat(cols, dim=-1).float(), num_rays)
    out = {'rgb': sums[:, :3], 'alpha': sums[:, 3:4], 'depth': sums[:, 4:5]}
    off = 5
    for name, v in extras.items():
        out[name] = sums[:, off:off + v.shape[-1]]
        off += v.shape[-1]
    return out


# ---------------------------------------------------------------------------
# Segmented march (deferred fine mode) and the paged trace
# ---------------------------------------------------------------------------

def _coarse_res(cfg: RFTracerConfig, occ_cfg: occ.OccupancyGridConfig) -> int:
    """Coarse grid resolution, clamped to the fine grid's."""
    return min(2 ** cfg.coarse_level, occ_cfg.res)


def segment_cover_radius(cfg: RFTracerConfig,
                         occ_cfg: occ.OccupancyGridConfig) -> float:
    """Spatial radius around a segment midpoint covered by its dilated
    coarse cell."""
    return cfg.seg_dilation * (2.0 / _coarse_res(cfg, occ_cfg))


def validate_segment_cover(cfg: RFTracerConfig,
                           occ_cfg: occ.OccupancyGridConfig,
                           dist_min: float, dist_max: float):
    """Raise unless the dilated coarse cell of a segment midpoint covers
    every sample of the segment (the conservativeness precondition of the
    segmented march)."""
    if cfg.segment_size <= 0:
        return
    if cfg.num_steps % cfg.segment_size:
        raise ValueError(f'segment_size {cfg.segment_size} must divide '
                         f'num_steps {cfg.num_steps}')
    seg_half = (float(dist_max) - float(dist_min)) * (
        cfg.segment_size / 2 + 1) / cfg.num_steps
    cover = segment_cover_radius(cfg, occ_cfg)
    if seg_half > cover:
        raise ValueError(
            f'segment half-length {seg_half:.4f} exceeds coarse cover '
            f'{cover:.4f}; raise seg_dilation or lower coarse_level')
    if cfg.super_factor > 1:
        if not (cfg.lean_stage1 and cfg.fine_mode == 'deferred'):
            raise ValueError('super_factor requires lean_stage1 + deferred')
        ns = cfg.num_steps // cfg.segment_size
        if ns % cfg.super_factor:
            raise ValueError(f'super_factor {cfg.super_factor} must divide '
                             f'the {ns}-segment ladder')
        need = super_dilation_for(cfg, occ_cfg, dist_min, dist_max)
        if cfg.super_dilation < need:
            raise ValueError(
                f'super_dilation {cfg.super_dilation} < required {need} '
                f'for super_factor {cfg.super_factor}')


def super_dilation_for(cfg: RFTracerConfig, occ_cfg: occ.OccupancyGridConfig,
                       dist_min: float, dist_max: float) -> int:
    """Least dilation under which the dilated coarse cell of a
    super-segment midpoint covers all its ``super_factor * segment_size``
    samples (+1 sample of jitter slack)."""
    f = max(cfg.super_factor, 1)
    half = (float(dist_max) - float(dist_min)) * (
        f * cfg.segment_size / 2 + 1) / cfg.num_steps
    return int(math.ceil(half / (2.0 / _coarse_res(cfg, occ_cfg))))


def _coarse_dilated_occupancy(occ_state: dict,
                              occ_cfg: occ.OccupancyGridConfig, rc: int,
                              dilation: int) -> torch.Tensor:
    """OR-pool the fine occupancy to ``rc`` cells per axis and dilate by
    ``dilation`` coarse cells (a 3D max filter, zero outside)."""
    f = occ_cfg.res // rc
    o = occ_state['occ'].reshape(rc, f, rc, f, rc, f).any(dim=5).any(
        dim=3).any(dim=1)
    if dilation > 0:
        k = 2 * dilation + 1
        o = F.max_pool3d(o.float()[None, None], k, stride=1,
                         padding=dilation)[0, 0] > 0
    return o


def coarse_dilated_occupancy(occ_state: dict,
                             occ_cfg: occ.OccupancyGridConfig,
                             cfg: RFTracerConfig) -> torch.Tensor:
    """The segmented march's coarse culling grid; trainers compute it once
    per prune and keep it as ``occ_state['coarse']``."""
    return _coarse_dilated_occupancy(occ_state, occ_cfg,
                                     _coarse_res(cfg, occ_cfg),
                                     cfg.seg_dilation)


def coarse_packed_grid(occ_state: dict, occ_cfg: occ.OccupancyGridConfig,
                       cfg: RFTracerConfig) -> torch.Tensor:
    """The coarse grid of ``term_tau > 0``, [rc, rc, rc, 2] f32: channel 0
    the dilated coarse occupancy (:func:`coarse_dilated_occupancy`),
    channel 1 the undilated max-pool of the decayed-max density (dilating
    it would lend a surface's opacity to its empty neighbours).  Trainers
    keep it as ``occ_state['coarse2']``, refreshed once per prune."""
    rc = _coarse_res(cfg, occ_cfg)
    o = _coarse_dilated_occupancy(occ_state, occ_cfg, rc, cfg.seg_dilation)
    f = occ_cfg.res // rc
    d = occ_state['density'].reshape(rc, f, rc, f, rc, f).amax(
        dim=(1, 3, 5))
    return torch.stack([o.float(), d.float()], dim=-1)


def _coarse_cells(pts: torch.Tensor, rc: int) -> torch.Tensor:
    """Cell index [..., 3] of [-1, 1] points on an ``rc``-cell grid."""
    return torch.clamp(torch.floor((pts * 0.5 + 0.5) * rc), 0, rc - 1).long()


def _stashed(occ_state, key: str, derive, occ_cfg, cfg: RFTracerConfig):
    """The grid a trainer keeps as ``occ_state[key]``, or ``derive``'s
    result from the occupancy when it keeps none."""
    grid = occ_state.get(key)
    return grid if grid is not None else derive(occ_state, occ_cfg, cfg)


def _segment_liveness(occ_state, occ_cfg, cfg: RFTracerConfig, rays: Rays,
                      t_mid: torch.Tensor, dmin: torch.Tensor,
                      dmax: torch.Tensor) -> torch.Tensor:
    """Coarse (and, with ``term_tau``, transmittance) segment liveness from
    midpoint depths ``t_mid`` [R, ns]; ``dmin``, ``dmax`` [R, 1]."""
    cover = segment_cover_radius(cfg, occ_cfg)
    rc = _coarse_res(cfg, occ_cfg)
    mid = rays.origins[:, None, :] + rays.dirs[:, None, :] * t_mid[..., None]
    inside = torch.all(torch.abs(mid) <= 1.0 + cover, dim=-1)
    ci = _coarse_cells(mid, rc)
    if cfg.term_tau > 0:
        v = _stashed(occ_state, 'coarse2', coarse_packed_grid, occ_cfg, cfg)[
            ci[..., 0], ci[..., 1], ci[..., 2]]                  # [R, ns, 2]
        live = (v[..., 0] > 0) & inside
        # a segment's chord is G sample spacings of span / (S - 1)
        seg_len = (dmax - dmin) * (cfg.segment_size / (cfg.num_steps - 1))
        tau = torch.where(live, v[..., 1] * seg_len, 0.0)
        cum = torch.cumsum(tau, dim=-1) - tau                    # exclusive
        return live & (cum <= cfg.term_tau)
    coarse = _stashed(occ_state, 'coarse', coarse_dilated_occupancy, occ_cfg,
                      cfg)
    return coarse[ci[..., 0], ci[..., 1], ci[..., 2]] & inside


def coarse_segment_live(occ_state, occ_cfg, cfg: RFTracerConfig, rays: Rays,
                        jitter):
    """Stage-1 segment cull: (depth [R, S], deltas [R, S], mask_c [R, ns]).
    Sampling is :func:`occupancy.raymarch_ray`'s (same jitter); a segment
    is live when its midpoint's dilated coarse cell is occupied (and, with
    ``term_tau``, not behind an estimated optical depth of ``term_tau``).
    Also the trainer's adaptive-budget probe."""
    G, S = cfg.segment_size, cfg.num_steps
    ns = S // G
    R = rays.origins.shape[0]
    dev = rays.origins.device
    u = occ.march_uniform(jitter, (R, S), dev)
    t = occ.linspace01(S, dev)[None, :] + u / S
    dmin, dmax = rays.dist_min[:, None], rays.dist_max[:, None]
    depth = t * (dmax - dmin) + dmin
    deltas = torch.diff(depth, dim=-1, prepend=dmin)
    dseg = depth.reshape(R, ns, G)
    t_mid = 0.5 * (dseg[..., 0] + dseg[..., -1])
    return depth, deltas, _segment_liveness(occ_state, occ_cfg, cfg, rays,
                                            t_mid, dmin, dmax)


def _segment_rows(rays: Rays, r_id, depth):
    """(samples [K, G, 3], dirs [K, 3]) of segment rows of rays ``r_id``
    [K] at depths [K, G]."""
    dirs = rays.dirs[r_id]
    return rays.origins[r_id][:, None, :] + dirs[:, None, :] \
        * depth[..., None], dirs


def _seg_dict(samples, dirs, fine, depth, deltas, r_id, valid):
    """A segment-major row set [K, G] as the paged trace takes it."""
    k, g = depth.shape
    return dict(samples=samples, dirs=dirs[:, None, :].expand(samples.shape),
                fine=fine, depth=depth, deltas=deltas,
                ray=r_id[:, None].expand(k, g), valid=valid)


def _trace_ray_segmented(occ_state, occ_cfg, cfg: RFTracerConfig, rays: Rays,
                         jitter) -> dict:
    """Segmented march of ``fine_mode='exact'``: stage-1 coarse cull,
    compaction to ``seg_budget`` segments and the fine occupancy of every
    sample of those.  Segment-major rows [k_seg, G] ascending in (ray,
    depth) over the live prefix; ``fine`` holds the per-sample fine
    liveness (dead segments all False)."""
    G = cfg.segment_size
    ns = cfg.num_steps // G
    R = rays.origins.shape[0]
    depth, deltas, mask_c = coarse_segment_live(occ_state, occ_cfg, cfg,
                                                rays, jitter)
    k_seg = cfg.seg_budget or max(1, 8 * cfg.max_samples // G)
    src_seg, seg_valid, _ = _stride_compact(mask_c.reshape(-1), k_seg)
    r_id = torch.div(src_seg, ns, rounding_mode='floor')
    depth_s = depth.reshape(R * ns, G)[src_seg]
    samples, dirs = _segment_rows(rays, r_id, depth_s)
    fine = occ.query(occ_state, occ_cfg, samples) & seg_valid[:, None]
    return _seg_dict(samples, dirs, fine, depth_s,
                     deltas.reshape(R * ns, G)[src_seg], r_id, seg_valid)


def _stage2_take(seg: dict, cfg: RFTracerConfig) -> dict:
    """Second-stage compaction of ``'exact'``: keep (up to)
    ``eval_seg_budget`` segments with a fine-live sample, stride-dropped
    on overflow, and gather their rows."""
    src2, valid2, _ = _stride_compact(seg['fine'].any(dim=-1),
                                      cfg.eval_seg_budget)
    return dict(samples=seg['samples'][src2], dirs=seg['dirs'][src2],
                fine=seg['fine'][src2] & valid2[:, None],
                depth=seg['depth'][src2], deltas=seg['deltas'][src2],
                ray=seg['ray'][src2], valid=valid2)


def _trace_ray_deferred(occ_state, occ_cfg, cfg: RFTracerConfig, rays: Rays,
                        jitter, fine_qfn) -> dict:
    """Deferred-fine segmented march: stage-1 coarse cull and compaction
    to ``seg_budget`` segments, a strided stage-2 take of
    ``eval_seg_budget`` of them, their samples and the fine occupancy
    ``fine_qfn`` on those only.  ``n_live`` and the stride stay on the
    device."""
    G = cfg.segment_size
    ns = cfg.num_steps // G
    R = rays.origins.shape[0]
    dev = rays.origins.device
    depth, deltas, mask_c = coarse_segment_live(occ_state, occ_cfg, cfg,
                                                rays, jitter)
    k_seg = cfg.seg_budget or max(1, 8 * cfg.max_samples // G)
    src_seg, seg_valid, _ = _stride_compact(mask_c.reshape(-1), k_seg)
    k2 = cfg.eval_seg_budget
    n_live = torch.sum(seg_valid)
    stride = torch.clamp(-(-n_live // k2), min=1)
    sel = torch.arange(k2, device=dev) * stride
    valid2 = sel < n_live
    src2 = src_seg[torch.clamp(sel, max=k_seg - 1)]          # flat seg ids
    r_id = torch.div(src2, ns, rounding_mode='floor')
    depth2 = depth.reshape(R * ns, G)[src2]
    samples2, dirs2 = _segment_rows(rays, r_id, depth2)
    return _seg_dict(samples2, dirs2, fine_qfn(samples2) & valid2[:, None],
                     depth2, deltas.reshape(R * ns, G)[src2], r_id, valid2)


def super_grid(occ_state: dict, occ_cfg: occ.OccupancyGridConfig,
               cfg: RFTracerConfig) -> torch.Tensor:
    """The two-level cull's grid: the coarse occupancy dilated by
    ``super_dilation``; trainers keep it as ``occ_state['super']``."""
    return _coarse_dilated_occupancy(occ_state, occ_cfg,
                                     _coarse_res(cfg, occ_cfg),
                                     cfg.super_dilation)


def _lean_midpoints(first_sample, G: int, S: int) -> torch.Tensor:
    """Analytic midpoint parameter in [0, 1] of spans of ``G`` samples that
    start at sample ``first_sample`` (f32 tensor): their centre sample plus
    the expected jitter."""
    return (first_sample + (G - 1) / 2.0) / (S - 1) + 0.5 / S


def _lean_src2_two_level(occ_state, occ_cfg, cfg: RFTracerConfig,
                         rays: Rays, span, dmin):
    """Two-level lean stage 1: the super-segment cull, compaction of the
    super-segments to ``eval_seg_budget``, then the per-segment tests on
    their ``super_factor`` segments each.  Returns (src2 [k2] flat segment
    ids, valid2 [k2]) in (ray, depth) order: the same survivors as the
    one-level test when no budget truncates (the super test is
    conservative)."""
    G, S = cfg.segment_size, cfg.num_steps
    ns = S // G
    Fs = cfg.super_factor
    ns_s = ns // Fs
    k2 = cfg.eval_seg_budget
    rc = _coarse_res(cfg, occ_cfg)
    dev = span.device

    # super level: [R, ns_s] midpoint test on the super-dilated grid
    ar_s = torch.arange(ns_s, dtype=torch.float32, device=dev)
    t_s = _lean_midpoints(ar_s * (Fs * G), Fs * G, S)[None, :] * span + dmin
    mid_s = rays.origins[:, None, :] + rays.dirs[:, None, :] * t_s[..., None]
    cover_s = cfg.super_dilation * (2.0 / rc)
    inside_s = torch.all(torch.abs(mid_s) <= 1.0 + cover_s, dim=-1)
    sgrid = _stashed(occ_state, 'super', super_grid, occ_cfg, cfg)
    ci_s = _coarse_cells(mid_s, rc)
    mask_s = sgrid[ci_s[..., 0], ci_s[..., 1], ci_s[..., 2]] & inside_s
    src_s, valid_s, _ = _stride_compact(mask_s.reshape(-1), k2)
    r_s = torch.div(src_s, ns_s, rounding_mode='floor')
    si_s = src_s - r_s * ns_s                                     # [ks]

    # segment level on the ks * F rows of the surviving super-segments
    si = si_s[:, None] * Fs + torch.arange(Fs, device=dev)[None, :]
    seg_ids = r_s[:, None] * ns + si                              # [ks, F]
    span_s = span[:, 0][r_s][:, None]
    dmin_s = dmin[:, 0][r_s][:, None]
    t_mid = _lean_midpoints(si.float() * G, G, S) * span_s + dmin_s
    mid = rays.origins[r_s][:, None, :] + rays.dirs[r_s][:, None, :] \
        * t_mid[..., None]                                        # [ks, F, 3]
    inside = torch.all(torch.abs(mid) <= 1.0 + segment_cover_radius(
        cfg, occ_cfg), dim=-1)
    ci = _coarse_cells(mid, rc)
    if cfg.term_tau > 0:
        v = _stashed(occ_state, 'coarse2', coarse_packed_grid, occ_cfg, cfg)[
            ci[..., 0], ci[..., 1], ci[..., 2]]                  # [ks, F, 2]
        live = (v[..., 0] > 0) & inside & valid_s[:, None]
        tau = torch.where(live, v[..., 1] * (span_s * (G / (S - 1))), 0.0)
        # exclusive per-ray prefix over the (ray, depth)-ordered rows;
        # super-dead segments add nothing (their density cache is below
        # the prune threshold, the one-level path's assumption too)
        rs_flat = r_s[:, None].expand(-1, Fs).reshape(-1)
        ray_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                               rs_flat[1:] != rs_flat[:-1]])
        cum = _segmented_excl_f64(tau.reshape(-1), ray_start)
        live = live & (cum.reshape(-1, Fs) <= cfg.term_tau)
    else:
        coarse = _stashed(occ_state, 'coarse', coarse_dilated_occupancy,
                          occ_cfg, cfg)
        live = (coarse[ci[..., 0], ci[..., 1], ci[..., 2]] & inside
                & valid_s[:, None])
    sel, valid2, _ = _stride_compact(live.reshape(-1), k2)
    return seg_ids.reshape(-1)[sel], valid2


def _trace_ray_deferred_lean(occ_state, occ_cfg, cfg: RFTracerConfig,
                             rays: Rays, jitter, fine_qfn) -> dict:
    """Lean deferred march: stage 1 on [R, ns] analytic midpoints (no
    [R, num_steps] ladders), compacted straight to ``eval_seg_budget``
    (two-level with ``super_factor > 1``); the k2 survivors' depths are
    ``(j / (S-1) + u_j / S) * span + dmin`` with ``u_j`` the counter hash
    of (step seed, sample id), deltas the uniform ``span / (S-1)``.
    ``jitter`` is the (2,) U(0,1) array of :func:`march_jitter_shape`."""
    G, S = cfg.segment_size, cfg.num_steps
    ns = S // G
    dev = rays.origins.device
    seed = _lean_seed(occ.march_uniform(jitter, (2,), dev))
    dmin, dmax = rays.dist_min[:, None], rays.dist_max[:, None]
    span = dmax - dmin                                            # [R, 1]
    k2 = cfg.eval_seg_budget
    if cfg.super_factor > 1:
        src2, valid2 = _lean_src2_two_level(occ_state, occ_cfg, cfg, rays,
                                            span, dmin)
    else:
        first = torch.arange(ns, dtype=torch.float32, device=dev) * G
        t_mid = _lean_midpoints(first, G, S)[None, :] * span + dmin
        mask_c = _segment_liveness(occ_state, occ_cfg, cfg, rays, t_mid,
                                   dmin, dmax)
        src2, valid2, _ = _stride_compact(mask_c.reshape(-1), k2)
    r_id = torch.div(src2, ns, rounding_mode='floor')
    si = src2 - r_id * ns                                         # in ray
    ar = torch.arange(G, device=dev)
    j = si[:, None] * G + ar[None, :]                             # [k2, G]
    u2 = _hash01(seed, src2[:, None] * G + ar[None, :])
    span_r = span[:, 0][r_id][:, None]
    dmin_r = dmin[:, 0][r_id][:, None]
    depth2 = (j.float() / (S - 1) + u2 / S) * span_r + dmin_r
    delta2 = (span_r / (S - 1)).expand(k2, G)
    samples2, dirs2 = _segment_rows(rays, r_id, depth2)
    return _seg_dict(samples2, dirs2, fine_qfn(samples2) & valid2[:, None],
                     depth2, delta2, r_id, valid2)


def fine_dilated_occupancy(occ_state: dict,
                           occ_cfg: occ.OccupancyGridConfig) -> torch.Tensor:
    """``fine_mode='kernel'``'s grouping grid: the fine occupancy dilated by
    the direct-LOD slab margin (within which a grouped sub-segment lies of
    its midpoint) plus one cell; trainers keep it as
    ``occ_state['fine_dil']``, refreshed once per prune."""
    radius = int(math.ceil(occ_cfg.res * ph.DIRECT_MARGIN)) + 1
    return _coarse_dilated_occupancy(occ_state, occ_cfg, occ_cfg.res, radius)


def _trace_paged(zbar_fn, finish_fn, head_fn, seg2: dict, cfg: RFTracerConfig,
                 num_rays: int, dil_qfn=None) -> dict:
    """Segment-grouped paged trace over stage-2 segments: group the
    fine-live sub-segments by grouping cell, encode all their rows
    block-locally (``zbar_fn``), compact rows to ``max_samples``, finish
    the features (``finish_fn``) and run the head there, integrate.

    With ``dil_qfn`` (fine_mode='kernel') ``seg2['fine']`` is only the
    coarse liveness: grouping keeps the sub-segments whose midpoint passes
    ``dil_qfn``, ``zbar_fn`` returns ``(zbar, occ [N])`` with the encode's
    per-sample fine occupancy, and that gates the row compaction."""
    samples2, fine2, valid2 = seg2['samples'], seg2['fine'], seg2['valid']
    k2, g = samples2.shape[0], samples2.shape[1]
    spb = cfg.group_segs_per_block
    gss = cfg.group_seg_size or g
    n_sub = k2 * (g // gss)
    with record_function('trace/group'):
        sub = samples2.reshape(n_sub, gss, 3)
        centers01 = sub[:, gss // 2, :] * 0.5 + 0.5
        # fully fine-dead sub-segments never reach the head: leave them out
        # of the grouping so they take no kernel blocks
        if dil_qfn is not None:
            fine_sub = dil_qfn(sub[:, gss // 2, :])
        else:
            fine_sub = fine2.reshape(n_sub, gss).any(dim=-1)
        valid_sub = valid2[:, None].expand(-1, g // gss).reshape(-1) \
            & fine_sub
        n_blocks = n_sub // spb + cfg.group_res ** 3
        grouping = ph.group_segments(centers01, valid_sub, spb, n_blocks,
                                     cfg.group_res)
    if dil_qfn is not None:
        with record_function('field/paged_encode'):
            zbar, occ_flat = zbar_fn(samples2.reshape(k2 * g, 3), grouping)
        fine2 = (occ_flat.reshape(k2, g) > 0.5) & valid2[:, None]
    with record_function('trace/compact'):
        src_idx, k_valid, inv_idx = _stride_compact(fine2.reshape(-1),
                                                    cfg.max_samples)
    if dil_qfn is None:
        with record_function('field/paged_encode'):
            zbar = zbar_fn(samples2.reshape(k2 * g, 3), grouping)
    with record_function('field/finish'):
        zbar_c = ph.permute_rows(zbar, src_idx, inv_idx)
        feats_c = finish_fn(zbar_c, samples2.reshape(-1, 3)[src_idx])
    with record_function('field/head'):
        color, density = head_fn(feats_c,
                                 seg2['dirs'].reshape(-1, 3)[src_idx])
    with record_function('trace/integrate'):
        return volume_integrate_compact(
            color, density[..., 0], seg2['deltas'].reshape(-1)[src_idx],
            seg2['depth'].reshape(-1)[src_idx], k_valid,
            seg2['ray'].reshape(-1)[src_idx], num_rays)


def _trace_ray_paged(occ_state, occ_cfg, cfg: RFTracerConfig, rays: Rays,
                     jitter, encode_split) -> dict:
    """The segmented march of ``cfg.fine_mode`` (lean or not) to stage-2
    segments, then :func:`_trace_paged`."""
    if len(encode_split) != 3:
        raise ValueError('the paged trace takes the 3-way encode_split '
                         '(zbar_fn, finish_fn, head_fn)')
    dil_qfn = None
    with record_function('trace/march'):
        if cfg.fine_mode == 'exact':
            seg2 = _stage2_take(_trace_ray_segmented(
                occ_state, occ_cfg, cfg, rays, jitter), cfg)
        else:
            if cfg.fine_mode == 'kernel':
                # the per-sample fine query comes out of the encode; here
                # only the dilated fine test of the grouping
                dil, rc = occ_state['fine_dil'], occ_cfg.res

                def dil_qfn(pts):
                    ci = _coarse_cells(pts, rc)
                    return dil[ci[..., 0], ci[..., 1], ci[..., 2]]

                def fine_qfn(s):
                    return torch.ones(s.shape[:-1], dtype=torch.bool,
                                      device=s.device)
            else:
                def fine_qfn(s):
                    return occ.query(occ_state, occ_cfg, s)
            march = (_trace_ray_deferred_lean if cfg.lean_stage1
                     else _trace_ray_deferred)
            seg2 = march(occ_state, occ_cfg, cfg, rays, jitter, fine_qfn)
    return _trace_paged(*encode_split, seg2, cfg, rays.origins.shape[0],
                        dil_qfn=dil_qfn)


# ---------------------------------------------------------------------------
# 'voxel' march: transmittance culling of DDA crossings, the fused paged
# stage 2
# ---------------------------------------------------------------------------

def _cell_density(occ_state, occ_cfg, pts: torch.Tensor) -> torch.Tensor:
    """The decayed-max density cached in the cells of ``pts`` [..., 3]."""
    ci = _coarse_cells(pts, occ_cfg.res)
    return occ_state['density'][ci[..., 0], ci[..., 1], ci[..., 2]]


def _term_keep(dens: torch.Tensor, chord: torch.Tensor,
               term_tau: float) -> torch.Tensor:
    """[R, I] crossings in front of an estimated optical depth of
    ``term_tau``: density x chord, exclusive prefix over the crossings."""
    tau = dens * chord
    cum = torch.cumsum(tau, dim=-1) - tau
    return cum <= term_tau


def crossing_term_mask(occ_state, occ_cfg, entries, exits, valid, rays: Rays,
                       u_mid: torch.Tensor, S: int,
                       term_tau: float) -> torch.Tensor:
    """Transmittance culling on DDA crossings [R, I] without the [R, I*S]
    sample tensors: each crossing's cached density at its sample ``S // 2``
    (jitter ``u_mid`` [R, I]) times its chord, accumulated front to back;
    the same kept set as :func:`voxel_term_mask` on the same jitter."""
    chord = (exits - entries) * valid
    depth_mid = entries + (exits - entries) * ((S // 2) + u_mid) / S
    mid = (rays.origins[:, None, :]
           + rays.dirs[:, None, :] * depth_mid[..., None])
    return _term_keep(_cell_density(occ_state, occ_cfg, mid), chord,
                      term_tau)


def voxel_term_mask(occ_state, occ_cfg, m: dict, R: int, I: int, S: int,
                    term_tau: float) -> torch.Tensor:
    """Transmittance culling over the crossings of a dense voxel march
    ``m`` (:func:`occupancy.raymarch_voxel`): [R, I] bool, True while the
    estimated optical depth in front of the crossing (cached density at its
    sample ``S // 2`` x its chord, the sum of its masked deltas) is at most
    ``term_tau``.  Padding crossings add nothing."""
    deltas = m['deltas'].reshape(R, I, S)
    mask = m['mask'].reshape(R, I, S)
    chord = torch.sum(deltas * mask, dim=-1)
    mid = m['samples'].reshape(R, I, S, 3)[:, :, S // 2, :]
    return _term_keep(_cell_density(occ_state, occ_cfg, mid), chord,
                      term_tau)


def _trace_voxel_fused(occ_state, occ_cfg, cfg: RFTracerConfig, rays: Rays,
                       jitter) -> dict:
    """Stage 2 of the paged voxel trace: the DDA crossings (culled with
    ``term_tau``) stride-compacted to ``eval_seg_budget`` first, then
    ``num_steps`` samples inside each survivor only; the same rows as
    sampling every crossing and compacting after, without the [R, I, S]
    tensors.  ``jitter``: [R, I, S] U(0,1) tensor or a generator."""
    R = rays.origins.shape[0]
    dev = rays.origins.device
    I, S = cfg.max_intersections, cfg.num_steps
    c = occ.voxel_crossings(occ_state, occ_cfg, rays, I)
    entries, exits, valid = c['entries'], c['exits'], c['valid']
    u = occ.march_uniform(jitter, (R, I, S), dev)
    if cfg.term_tau > 0:
        valid = valid & crossing_term_mask(
            occ_state, occ_cfg, entries, exits, valid, rays, u[..., S // 2],
            S, cfg.term_tau)
    k2 = cfg.eval_seg_budget
    src2, valid2, _ = _stride_compact(valid.reshape(-1), k2)
    r_id = torch.div(src2, I, rounding_mode='floor')
    ent2 = entries.reshape(-1)[src2]
    ext2 = exits.reshape(-1)[src2]
    frac = (torch.arange(S, device=dev) + u.reshape(R * I, S)[src2]) / S
    depth2 = ent2[:, None] + (ext2 - ent2)[:, None] * frac
    delta2 = ((ext2 - ent2) / S)[:, None].expand(k2, S)
    samples2, dirs2 = _segment_rows(rays, r_id, depth2)
    return _seg_dict(samples2, dirs2, valid2[:, None].expand(k2, S), depth2,
                     delta2, r_id, valid2)


def _trace_compact_flat(field_fn, rows: dict, flat_mask: torch.Tensor,
                        ray_of, max_samples: int, num_rays: int,
                        rays: Rays) -> dict:
    """Evaluate the field on up to ``max_samples`` live rows (``flat_mask``
    over the flattened ``rows['samples']``, ``rows['depth']``,
    ``rows['deltas']``) and integrate them compactly; ``ray_of(src)`` gives
    the ray of flat rows, non-decreasing over the live ones."""
    with record_function('trace/compact'):
        src, valid, _, live, kept = _stride_compact_counts(flat_mask,
                                                           max_samples)
        if perf.tracing() and torch.is_grad_enabled():
            perf.count('trace/live_samples', live)
            perf.count('trace/kept_samples', kept)
            perf.count('trace/slots', max_samples)
        ray = ray_of(src)
        coords, dirs = rows['samples'].reshape(-1, 3)[src], rays.dirs[ray]
    color, density, extras = _eval_field(field_fn, coords, dirs)
    with record_function('trace/integrate'):
        return volume_integrate_compact(
            color, density[..., 0], rows['deltas'].reshape(-1)[src],
            rows['depth'].reshape(-1)[src], valid, ray, num_rays, extras)


def trace(field_fn, occ_state: dict, occ_cfg: occ.OccupancyGridConfig,
          cfg: RFTracerConfig, rays: Rays, jitter, encode_split=None) -> dict:
    """March, evaluate and integrate.

    Args:
        field_fn(coords [N,3], dirs [N,3]) -> (rgb [N,3], density [N,1])
            or (rgb, density, {name: [N, k]}) with extra channels.
        jitter: U(0,1) tensor of :func:`march_jitter_shape` ([R,
            num_steps], [R, max_intersections, num_steps] for the voxel
            march, or (2,) for the lean march) or a ``torch.Generator``.
        encode_split: (zbar_fn, finish_fn, head_fn) for the paged trace
            (``segment_size > 0`` or the voxel march, ``eval_seg_budget >
            0``): ``zbar_fn(
            coords [K*G, 3], grouping)`` returns the block-local latents,
            ``finish_fn(zbar_c, coords_c)`` the features on the compacted
            rows and ``head_fn(feats, dirs)`` (rgb, density).  With
            ``fine_mode='kernel'`` ``zbar_fn`` returns ``(zbar, occ [K*G])``,
            the encode's fine occupancy row, and ``occ_state`` holds
            ``'fine_dil'`` (:func:`fine_dilated_occupancy`).
    Returns: rgb [R,3] (background composited), alpha [R,1], depth [R,1],
        hit [R] bool, and one [R, k] buffer per extra channel of the field
        (not on the paged trace).
    """
    R = rays.origins.shape[0]
    voxel = cfg.raymarch_type == 'voxel'
    if (voxel and encode_split is not None and cfg.eval_seg_budget > 0
            and cfg.max_samples > 0):
        # each crossing's num_steps samples lie in one occupancy cell, so
        # the crossing axis is the paged trace's segment axis
        if len(encode_split) != 3:
            raise ValueError('the paged trace takes the 3-way encode_split '
                             '(zbar_fn, finish_fn, head_fn)')
        with record_function('trace/march'):
            seg2 = _trace_voxel_fused(occ_state, occ_cfg, cfg, rays, jitter)
        return _composite(_trace_paged(*encode_split, seg2, cfg, R), cfg)
    if not voxel and cfg.segment_size > 0 and cfg.max_samples > 0:
        if encode_split is not None and cfg.eval_seg_budget > 0:
            return _composite(_trace_ray_paged(
                occ_state, occ_cfg, cfg, rays, jitter, encode_split), cfg)
        with record_function('trace/march'):
            seg = _trace_ray_segmented(occ_state, occ_cfg, cfg, rays, jitter)
        # segment-major rows: row n of the flat list is sample n % G of
        # stage-1 segment n // G
        ray_of = seg['ray'][:, 0]
        out = _trace_compact_flat(
            field_fn, seg, seg['fine'].reshape(-1),
            lambda src: ray_of[torch.div(src, cfg.segment_size,
                                         rounding_mode='floor')],
            cfg.max_samples, R, rays)
        return _composite(out, cfg)
    with record_function('trace/march'):
        if voxel:
            I, S = cfg.max_intersections, cfg.num_steps
            m = occ.raymarch_voxel(occ_state, occ_cfg, rays, S, jitter, I)
            if cfg.term_tau > 0:
                keep = voxel_term_mask(occ_state, occ_cfg, m, R, I, S,
                                       cfg.term_tau)
                m['mask'] = (m['mask'].reshape(R, I, S)
                             & keep[..., None]).reshape(R, I * S)
        else:
            m = occ.raymarch_ray(occ_state, occ_cfg, rays, cfg.num_steps,
                                 jitter)
    samples, mask = m['samples'], m['mask']
    S = mask.shape[1]
    if cfg.max_samples and cfg.max_samples < R * S:
        # evaluate only up to max_samples occupied rows, integrate compactly
        out = _trace_compact_flat(
            field_fn, m, mask.reshape(-1),
            lambda src: torch.div(src, S, rounding_mode='floor'),
            cfg.max_samples, R, rays)
    else:
        dirs = torch.broadcast_to(rays.dirs[:, None, :], samples.shape)
        color, density, extras = _eval_field(field_fn, samples, dirs)
        with record_function('trace/integrate'):
            if perf.tracing() and torch.is_grad_enabled():
                live = mask.sum()
                perf.count('trace/live_samples', live)
                perf.count('trace/kept_samples', live)
                perf.count('trace/slots', mask.numel())
            color = torch.where(mask[..., None], color, 0.0)
            density = torch.where(mask, density[..., 0], 0.0)
            rgb, alpha, depth = volume_integrate(color, density, m['deltas'],
                                                 m['depth'], mask)
            out = {'rgb': rgb, 'alpha': alpha, 'depth': depth}
            if extras:
                w = integration_weights(density, m['deltas'], mask)
                for name, v in extras.items():
                    out[name] = torch.sum(
                        w[..., None] * torch.where(mask[..., None], v, 0.0),
                        dim=-2)
    return _composite(out, cfg)


def _composite(out: dict, cfg: RFTracerConfig) -> dict:
    """Hit mask and background compositing of integrated ray buffers."""
    alpha = out['alpha']
    out['hit'] = alpha[..., 0] > 0.0
    if cfg.bg_color == 'white':
        out['rgb'] = (1.0 - alpha) + out['rgb']
    else:
        out['rgb'] = alpha * out['rgb']
    return out
