"""Radiance-field tracer: 'ray' march + masked volume integration.

Port of the dense, compact and paged-deferred ``'ray'`` branches of
``shacira_tpu/tracers/rf_tracer.py``.  Every ray carries a fixed sample axis
with a boolean mask (masked samples add no optical thickness); with
``max_samples`` the field is evaluated only on up to K occupied samples
(budgeted stride compaction) and integrated in compact form, the per-ray
sums running through the scatter kernel (``ops/scatter.segment_sum``).

The paged branch (``segment_size > 0``, ``fine_mode='deferred'`` or
``'kernel'``, ``eval_seg_budget > 0`` and a 3-way ``encode_split``):
segments of ``segment_size`` samples are culled at their midpoint against a
dilated coarse occupancy grid, compacted twice (``seg_budget``, then
``eval_seg_budget``), fine-queried, grouped by grouping cell
(``ops/paged_hash.group_segments``), encoded block-locally on all their
rows, compacted to ``max_samples`` rows and finished (direct decode, head)
there.  With ``fine_mode='kernel'`` the per-sample fine query rides the
encode (kernel B2's occupancy row): grouping keeps the sub-segments whose
midpoint lies in a dilated fine cell (``occ_state['fine_dil']``), and the
row compaction runs after the encode, on the occupancy row.  Budgets and
strides stay device tensors: no host sync.

Integration (exclusive transmittance):
    tau_i = density_i * delta_i * mask_i
    T_i   = exp(-sum_{j<i} tau_j)
    w_i   = T_i * (1 - exp(-tau_i))
    rgb = sum w_i c_i ; alpha = sum w_i ; depth = sum w_i t_i
White background: rgb + (1 - alpha); black: alpha * rgb.

The segmented ``'exact'`` march waits for ROADMAP Queue A item 7e, lean
stage 1, the super-segment cull and transmittance culling for item 9a and
the voxel march for item 11; fields
return (rgb, density) only (the JAX tracer's extra per-sample channels have
no caller on the ported path).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from shacira_tpu_torch.accel import occupancy as occ
from shacira_tpu_torch.core.rays import Rays
from shacira_tpu_torch.ops import paged_hash as ph
from shacira_tpu_torch.ops.scatter import segment_sum


@dataclass(frozen=True)
class RFTracerConfig:
    raymarch_type: str = 'ray'     # only 'ray' is ported
    num_steps: int = 64
    bg_color: str = 'white'
    max_intersections: int = 64
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
    fine_mode: str = 'exact'       # 'deferred' or 'kernel' (paged)
    term_tau: float = 0.0          # transmittance culling: not ported
    lean_stage1: bool = False      # not ported
    super_factor: int = 0          # two-level cull: not ported

    def __post_init__(self):
        if self.raymarch_type != 'ray':
            raise NotImplementedError(
                f'raymarch_type={self.raymarch_type!r}: the voxel march is '
                'ROADMAP Queue A item 11')
        if self.lean_stage1 or self.super_factor > 1 or self.term_tau > 0:
            raise NotImplementedError(
                'lean_stage1, super_factor and term_tau are not ported yet '
                '(ROADMAP Queue A item 9a)')
        if self.segment_size > 0 and self.fine_mode not in ('deferred',
                                                             'kernel'):
            raise NotImplementedError(
                f"fine_mode={self.fine_mode!r}: the segmented 'exact' march "
                'is ROADMAP Queue A item 7e; the port runs '
                "fine_mode='deferred' and 'kernel'")


def march_jitter_shape(cfg: RFTracerConfig, num_rays: int):
    """Shape of the U(0,1) march jitter :func:`trace` consumes."""
    return (num_rays, cfg.num_steps)


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
    return src[:budget], valid, slots


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


def volume_integrate_compact(color, density, deltas, depth, valid, ray_id,
                             num_rays: int) -> dict:
    """Compact-form masked volume integration.

    Rows are sorted by (ray, depth) over the valid prefix (the invariant of
    :func:`_stride_compact`); invalid tail rows add nothing.  Equal to
    :func:`volume_integrate` on a dense scatter-back of the rows.

    Args: color [K,3], density [K], deltas [K], depth [K], valid [K] bool,
        ray_id [K] int, num_rays R.
    Returns: dict rgb [R,3], alpha [R,1], depth [R,1], before background
        compositing.
    """
    tau = density * deltas * valid.to(density.dtype)
    ray_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                      device=ray_id.device),
                           ray_id[1:] != ray_id[:-1]])
    transmittance = torch.exp(-_segmented_cumsum_excl(tau, ray_start))
    w = transmittance * (1.0 - torch.exp(-tau))     # 0 exactly when invalid
    payload = torch.cat([w[:, None] * color, w[:, None], (w * depth)[:, None]],
                        dim=-1).float()
    sums = segment_sum(ray_id, payload, num_rays)
    return {'rgb': sums[:, :3], 'alpha': sums[:, 3:4], 'depth': sums[:, 4:5]}


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


def _segment_liveness(occ_state, occ_cfg, cfg: RFTracerConfig, rays: Rays,
                      t_mid: torch.Tensor) -> torch.Tensor:
    """Coarse segment liveness from midpoint depths ``t_mid`` [R, ns]."""
    cover = segment_cover_radius(cfg, occ_cfg)
    rc = _coarse_res(cfg, occ_cfg)
    mid = rays.origins[:, None, :] + rays.dirs[:, None, :] * t_mid[..., None]
    inside = torch.all(torch.abs(mid) <= 1.0 + cover, dim=-1)
    ci = torch.clamp(torch.floor((mid * 0.5 + 0.5) * rc), 0, rc - 1).long()
    coarse = occ_state.get('coarse')
    if coarse is None:
        coarse = _coarse_dilated_occupancy(occ_state, occ_cfg, rc,
                                           cfg.seg_dilation)
    return coarse[ci[..., 0], ci[..., 1], ci[..., 2]] & inside


def coarse_segment_live(occ_state, occ_cfg, cfg: RFTracerConfig, rays: Rays,
                        jitter):
    """Stage-1 segment cull: (depth [R, S], deltas [R, S], mask_c [R, ns]).
    Sampling is :func:`occupancy.raymarch_ray`'s (same jitter); a segment
    is live when its midpoint's dilated coarse cell is occupied."""
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
                                            t_mid)


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
    delta2 = deltas.reshape(R * ns, G)[src2]
    dirs2 = rays.dirs[r_id]
    samples2 = rays.origins[r_id][:, None, :] + dirs2[:, None, :] \
        * depth2[..., None]
    fine2 = fine_qfn(samples2) & valid2[:, None]
    return dict(samples=samples2,
                dirs=dirs2[:, None, :].expand(samples2.shape),
                fine=fine2, depth=depth2, deltas=delta2,
                ray=r_id[:, None].expand(k2, G), valid=valid2)


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


def trace(field_fn, occ_state: dict, occ_cfg: occ.OccupancyGridConfig,
          cfg: RFTracerConfig, rays: Rays, jitter, encode_split=None) -> dict:
    """March, evaluate and integrate.

    Args:
        field_fn(coords [N,3], dirs [N,3]) -> (rgb [N,3], density [N,1]).
        jitter: [R, num_steps] U(0,1) tensor or a ``torch.Generator``.
        encode_split: (zbar_fn, finish_fn, head_fn) for the paged trace
            (``segment_size > 0``, ``eval_seg_budget > 0``): ``zbar_fn(
            coords [K*G, 3], grouping)`` returns the block-local latents,
            ``finish_fn(zbar_c, coords_c)`` the features on the compacted
            rows and ``head_fn(feats, dirs)`` (rgb, density).  With
            ``fine_mode='kernel'`` ``zbar_fn`` returns ``(zbar, occ [K*G])``,
            the encode's fine occupancy row, and ``occ_state`` holds
            ``'fine_dil'`` (:func:`fine_dilated_occupancy`).
    Returns: rgb [R,3] (background composited), alpha [R,1], depth [R,1],
        hit [R] bool.
    """
    R = rays.origins.shape[0]
    if cfg.segment_size > 0 and cfg.max_samples > 0:
        if encode_split is None or cfg.eval_seg_budget <= 0:
            raise NotImplementedError(
                "the segmented 'exact' march (no paged encode split) is "
                'ROADMAP Queue A item 7e')
        if len(encode_split) != 3:
            raise ValueError('the paged trace takes the 3-way encode_split '
                             '(zbar_fn, finish_fn, head_fn)')
        dil_qfn = None
        if cfg.fine_mode == 'kernel':
            # the per-sample fine query comes out of the encode; here only
            # the dilated fine test of the grouping
            dil, rc = occ_state['fine_dil'], occ_cfg.res

            def dil_qfn(pts):
                ci = torch.clamp(torch.floor((pts * 0.5 + 0.5) * rc), 0,
                                 rc - 1).long()
                return dil[ci[..., 0], ci[..., 1], ci[..., 2]]

            def fine_qfn(s):
                return torch.ones(s.shape[:-1], dtype=torch.bool,
                                  device=s.device)
        else:
            def fine_qfn(s):
                return occ.query(occ_state, occ_cfg, s)
        with record_function('trace/march'):
            seg2 = _trace_ray_deferred(occ_state, occ_cfg, cfg, rays, jitter,
                                       fine_qfn)
        out = _trace_paged(*encode_split, seg2, cfg, R, dil_qfn=dil_qfn)
        return _composite(out, cfg)
    with record_function('trace/march'):
        m = occ.raymarch_ray(occ_state, occ_cfg, rays, cfg.num_steps, jitter)
    samples, mask = m['samples'], m['mask']
    S = mask.shape[1]
    if cfg.max_samples and cfg.max_samples < R * S:
        # evaluate only up to max_samples occupied rows, integrate compactly
        with record_function('trace/compact'):
            src, valid, _ = _stride_compact(mask.reshape(-1), cfg.max_samples)
            ray = torch.div(src, S, rounding_mode='floor')  # ray-major rows
            coords, dirs = samples.reshape(-1, 3)[src], rays.dirs[ray]
        color, density = field_fn(coords, dirs)
        with record_function('trace/integrate'):
            out = volume_integrate_compact(
                color, density[..., 0], m['deltas'].reshape(-1)[src],
                m['depth'].reshape(-1)[src], valid, ray, R)
    else:
        dirs = torch.broadcast_to(rays.dirs[:, None, :], samples.shape)
        color, density = field_fn(samples, dirs)
        color = torch.where(mask[..., None], color, 0.0)
        density = torch.where(mask, density[..., 0], 0.0)
        rgb, alpha, depth = volume_integrate(color, density, m['deltas'],
                                             m['depth'], mask)
        out = {'rgb': rgb, 'alpha': alpha, 'depth': depth}
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
