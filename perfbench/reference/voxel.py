"""Plain PyTorch reference of one SHACIRA NeRF training step on the
``'voxel'`` march (the V8 configuration on RTMV data), from the
configuration's settings, the scene's depth point cloud and the step's
draws alone.

The occupancy grid starts as the cells of the ``res^3`` grid over
``[-1, 1]^3`` that hold a point of the cloud, grown by one cell in every
direction (a 3 x 3 x 3 neighbourhood).  The march walks each ray through
the grid from its entry into the box, clipped to its distance bounds, to
its exit (:func:`crossings`), and keeps the first ``max_intersections``
occupied cells it crosses, in depth order: each crossing's entry and exit
depth.  Inside each kept crossing it takes ``num_steps`` jittered samples,
``entry + (exit - entry) * (j + u_j) / num_steps``, each of length
``(exit - entry) / num_steps``.  The rest of the step is
:class:`NerfReference`'s: the latent table quantized (SGA) and decoded,
the hash grid blended at every sample, the bf16 MLP head, volume
rendering over each ray's samples (transmittance by a float64 cumulative
sum), L1 to the pixels plus the rate of the latents, autograd's gradients
and Adam; the prune is :meth:`NerfReference.prune`.

The walk is the JAX package's, in float32: from each depth it looks the
cell up 1e-6 further along the ray and moves to where the ray leaves that
cell.  Which cells it records is fixed by that float32 arithmetic: where
a direction component is small, the point 1e-6 past a face can round back
onto the face, and the walk records the cell it is leaving again, a
crossing 1e-6 long, before it moves on; a ray that enters the box at a
grazing angle can find its first cell outside the grid.  A walk in exact
arithmetic (Amanatides and Woo's) keeps other cells on ~7.5 % of the V8
cell's rays once every cell is occupied.

Departures from the JAX package's step, each noted where it is made:

* its walk stops advancing on a ray with a direction component in (-1e-9,
  0] (it divides by +1e-9 there while it takes the face behind the ray);
  this walk divides by -1e-9 and does not stop.  The benchmark's entry
  checks that no ray the comparison reads has such a component, so the
  departure never shows there;
* only the samples inside kept crossings go through the field (the
  program evaluates every slot and masks the rest out: the same sums).

Planted faults (``fault``), which the comparison has to reject: the last
kept crossing of each ray dropped (``'drop_last'``), every cell occupied
in place of the point cloud's (``'all_occupied'``), the latents decoded
from their first column alone (``'latent_dim_1'``).

Every function takes a ``dtype``: float32 is the reference, a lower type
(bfloat16) is the control that the comparison has to reject.  Building a
reference turns TF32 off for float32 matrix products.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from perfbench.reference import common as C
from perfbench.reference.nerf import NerfReference

EPS = 1e-6
TINY = 1e-9
FAULTS = ('drop_last', 'all_occupied', 'latent_dim_1')


def seeded_occupancy(points, res: int, device) -> torch.Tensor:
    """[res]^3 bool: the cells holding a point of ``points`` [N, 3] (in
    [-1, 1]^3, clamped), and every cell next to one (faces, edges and
    corners)."""
    p = torch.as_tensor(np.asarray(points), dtype=torch.float32,
                        device=device)
    idx = torch.floor(torch.clamp((p * 0.5 + 0.5) * res, 0,
                                  res - 1e-5)).long()
    held = torch.zeros((res + 2,) * 3, dtype=torch.bool, device=device)
    held[idx[:, 0] + 1, idx[:, 1] + 1, idx[:, 2] + 1] = True
    occ = torch.zeros((res, res, res), dtype=torch.bool, device=device)
    for a in range(3):
        for b in range(3):
            for c in range(3):
                occ |= held[a:a + res, b:b + res, c:c + res]
    return occ


def directions(d: torch.Tensor) -> torch.Tensor:
    """The directions the walk divides by: a component under 1e-9 in size
    is 1e-9 of its own sign (zero counts as negative).  The JAX package
    takes +1e-9 for every component under 1e-9, so on one in (-1e-9, 0]
    its walk takes the plane behind the ray and stops advancing."""
    return torch.where(d.abs() < TINY,
                       torch.where(d > 0, TINY, -TINY).to(d.dtype), d)


def box_interval(o: torch.Tensor, d: torch.Tensor, dist_min, dist_max):
    """(tmin, tmax) [R] float32: where the rays are inside [-1, 1]^3,
    within their distance bounds (numbers, or one a ray; empty where tmax
    <= tmin)."""
    sd = directions(d)
    t0, t1 = (-1.0 - o) / sd, (1.0 - o) / sd
    lo, hi = (torch.as_tensor(v, dtype=torch.float32, device=o.device)
              for v in (dist_min, dist_max))
    return (torch.maximum(torch.minimum(t0, t1).amax(-1), lo),
            torch.minimum(torch.maximum(t0, t1).amin(-1), hi))


def crossings(occ: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
              dist_min, dist_max, max_intersections: int,
              drop_last: bool = False) -> dict:
    """The first ``max_intersections`` occupied cells each ray crosses, in
    depth order: ``entries``, ``exits`` [R, I] float32 (0 past a ray's
    count) and ``valid`` [R, I] bool.

    The walk starts at the ray's entry into the box, clipped to its
    distance bounds.  At depth t it looks up the cell holding the point
    ``o + d (t + EPS)`` (float32, the product and the sum rounded once, as
    a fused multiply-add rounds them); where that cell is in the grid,
    occupied and t is short of the ray's end, it records a crossing from t
    to the depth where the ray leaves the cell through the nearest of its
    faces ahead (at least t + EPS), clipped to the ray's end; then it moves
    to that depth.  A ray crosses at most 3 res + 2 cells."""
    res = occ.shape[0]
    R, dev = o.shape[0], o.device
    I = max_intersections
    cw = 2.0 / res
    o, d = o.float(), d.float()
    sd = directions(d)
    ahead = (d > 0).long()
    tmin, tmax = box_interval(o, d, dist_min, dist_max)
    some = tmax > tmin
    t = tmin
    entries = torch.zeros((R, I + 1), device=dev)
    exits = torch.zeros_like(entries)
    count = torch.zeros(R, dtype=torch.long, device=dev)
    rows = torch.arange(R, device=dev)
    flat = occ.reshape(-1)
    for _ in range(3 * res + 2):
        if not bool((some & (t < tmax)).any()):
            break
        te = t + EPS
        # one rounding: the float32 product is exact in float64, and the
        # float64 sum rounds to float32 as one rounding would (but for a
        # tie of the two roundings, one in 2^29)
        p = (o.double() + d.double() * te.double()[:, None]).float()
        x = torch.floor((p * 0.5 + 0.5) * res)
        cell = x.clamp(0, res - 1).long()
        leave = ((cell + ahead).float() * cw - 1.0 - o) / sd
        t_out = torch.maximum(leave.amin(-1), te)
        hit = (some & (t < tmax) & ((x >= 0) & (x < res)).all(-1)
               & flat[(cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]])
        slot = torch.where(hit, count.clamp(max=I), torch.full_like(count, I))
        entries[rows, slot] = torch.where(hit, t, entries[rows, slot])
        exits[rows, slot] = torch.where(hit, torch.minimum(t_out, tmax),
                                        exits[rows, slot])
        count = count + hit.long()
        t = t_out
    count = count.clamp(max=I)
    if drop_last:
        count = (count - 1).clamp(min=0)
    valid = torch.arange(I, device=dev)[None, :] < count[:, None]
    return {'entries': torch.where(valid, entries[:, :I], 0.0),
            'exits': torch.where(valid, exits[:, :I], 0.0), 'valid': valid}


class VoxelReference(NerfReference):
    """:class:`NerfReference`'s step and prune over the ``'voxel'`` march
    (draws' ``march_u`` [R, max_intersections, num_steps])."""

    def __init__(self, settings: dict, dist_min: float, dist_max: float,
                 num_views: int, fault: Optional[str] = None):
        super().__init__(settings, dist_min, dist_max, num_views)
        if fault is not None and fault not in FAULTS:
            raise ValueError(f'unknown planted fault {fault!r}')
        self.fault = fault
        self.I = int(settings['max_intersections'])
        self.S = int(settings['num_steps'])
        # float32 products in float32: the card would take TF32 otherwise
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def occupancy(self, points, device) -> torch.Tensor:
        """The occupancy grid a training run starts from."""
        if self.fault == 'all_occupied':
            return torch.ones((self.res,) * 3, dtype=torch.bool,
                              device=device)
        return seeded_occupancy(points, self.res, device)

    def march(self, occ: torch.Tensor, rays_o, rays_d, u):
        """Samples [R, I*S, 3], depth and deltas [R, I*S] and the mask of
        the samples inside kept crossings, for the jitter ``u`` [R, I*S]
        (crossing-major)."""
        R, I, S = u.shape[0], self.I, self.S
        c = crossings(occ, rays_o, rays_d, *self.dist, I,
                      drop_last=self.fault == 'drop_last')
        ent, ext = c['entries'][..., None], c['exits'][..., None]
        frac = (torch.arange(S, device=u.device) + u.reshape(R, I, S)) / S
        depth = (ent + (ext - ent) * frac).reshape(R, I * S)
        deltas = ((ext - ent) / S).expand(R, I, S).reshape(R, I * S)
        mask = c['valid'][..., None].expand(R, I, S).reshape(R, I * S)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * depth[..., None]
        return pts, depth, deltas, mask

    def grid_params(self, params: dict) -> dict:
        """The parameters the step decodes: under the ``'latent_dim_1'``
        fault, the grid's first latent column alone."""
        if self.fault != 'latent_dim_1':
            return params
        g = params['grid']
        dec = g['latent_dec']
        layer = dict(dec['layers'][0], scale=dec['layers'][0]['scale'][:1])
        return dict(params, grid=dict(
            g, codebook=g['codebook'][:, :1],
            latent_dec=dict(dec, div=dec['div'][:1], layers=[layer]),
            prob_model=C.tree_map(lambda t: t[..., :1], g['prob_model'])))

    def loss(self, params: dict, occ, rays_o, rays_d, gt, draws: dict,
             hp: dict, dtype=torch.float32):
        """:meth:`NerfReference.loss` with the march jitter taken as [R,
        I*S] and the latent draws cut to the grid decoded."""
        params = self.grid_params(params)
        ld = params['grid']['codebook'].shape[1]
        draws = {k: (v if v is None or k == 'march_u' else v[:, :ld])
                 for k, v in draws.items()}
        draws['march_u'] = draws['march_u'].reshape(rays_o.shape[0], -1)
        return super().loss(params, occ, rays_o, rays_d, gt, draws, hp,
                            dtype)

    def prune(self, params: dict, density_old: torch.Tensor,
              occ_old: torch.Tensor, u: torch.Tensor, dtype=torch.float32,
              block: int = 1 << 18):
        """:meth:`NerfReference.prune` of the grid the step decodes."""
        return super().prune(self.grid_params(params), density_old, occ_old,
                             u, dtype, block)
