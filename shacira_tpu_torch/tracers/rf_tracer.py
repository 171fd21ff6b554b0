"""Radiance-field tracer: 'ray' march + masked volume integration.

Port of the dense and compact ``'ray'`` branches of
``shacira_tpu/tracers/rf_tracer.py``.  Every ray carries a fixed sample axis
with a boolean mask (masked samples add no optical thickness); with
``max_samples`` the field is evaluated only on up to K occupied samples
(budgeted stride compaction) and integrated in compact form, the per-ray
sums running through the scatter kernel (``ops/scatter.segment_sum``).

Integration (exclusive transmittance):
    tau_i = density_i * delta_i * mask_i
    T_i   = exp(-sum_{j<i} tau_j)
    w_i   = T_i * (1 - exp(-tau_i))
    rgb = sum w_i c_i ; alpha = sum w_i ; depth = sum w_i t_i
White background: rgb + (1 - alpha); black: alpha * rgb.

The segmented march, the paged trace and the voxel march wait for ROADMAP
Queue A items 7e, 9 and 11; fields return (rgb, density) only (the JAX
tracer's extra per-sample channels have no caller on the ported path).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from shacira_tpu_torch.accel import occupancy as occ
from shacira_tpu_torch.core.rays import Rays
from shacira_tpu_torch.ops.scatter import segment_sum


@dataclass(frozen=True)
class RFTracerConfig:
    raymarch_type: str = 'ray'     # only 'ray' is ported
    num_steps: int = 64
    bg_color: str = 'white'
    max_intersections: int = 64
    max_samples: int = 0           # >0: compact to K occupied samples
    segment_size: int = 0          # segmented march: not ported

    def __post_init__(self):
        if self.raymarch_type != 'ray':
            raise NotImplementedError(
                f'raymarch_type={self.raymarch_type!r}: the voxel march is '
                'ROADMAP Queue A item 11')
        if self.segment_size > 0:
            raise NotImplementedError(
                "segment_size > 0: the segmented 'exact' march is ROADMAP "
                'Queue A item 7e')


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


def trace(field_fn, occ_state: dict, occ_cfg: occ.OccupancyGridConfig,
          cfg: RFTracerConfig, rays: Rays, jitter) -> dict:
    """March, evaluate and integrate.

    Args:
        field_fn(coords [N,3], dirs [N,3]) -> (rgb [N,3], density [N,1]).
        jitter: [R, num_steps] U(0,1) tensor or a ``torch.Generator``.
    Returns: rgb [R,3] (background composited), alpha [R,1], depth [R,1],
        hit [R] bool.
    """
    R = rays.origins.shape[0]
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
    alpha = out['alpha']
    out['hit'] = alpha[..., 0] > 0.0
    if cfg.bg_color == 'white':
        out['rgb'] = (1.0 - alpha) + out['rgb']
    else:
        out['rgb'] = alpha * out['rgb']
    return out
