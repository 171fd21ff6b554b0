"""Plain PyTorch reference of one VQAD (Variable Bitrate Neural Fields,
Takikawa et al., SIGGRAPH 2022) NeRF training step, from the
configuration's settings alone.

The step: jittered ``'ray'`` samples along each ray over an all-occupied
grid (those outside the unit cube masked); at each LOD the sample's cell
and its 8 corner rows, the trilinear weights and the gathered corner
logits; the softmax over the D logits, the straight-through one-hot of
its argmax ``y_soft + (hard - y_soft).detach()`` times the LOD's D x F
dictionary; the trilinear blend, summed (or concatenated) over the LODs;
the bf16 MLP head; dense volume rendering over each ray's samples
(transmittance by a float64 cumulative sum); L1 to the pixels; autograd's
gradients and Adam over the trainer's groups.

Departures from the published description, each noted where it is made:

* the octree is dense over the active LODs, so a corner is any point of
  the lattice ``[0, 2^l]^3``; a corner's code is its raster key
  ``(x n + y) n + z`` (``n = 2^l + 1``), the order the tables are laid
  out in (kaolin's dual octree orders corners by morton code: a
  permutation of the rows that changes no value);
* the argmax is Wisp's ``y_soft.max(-1)[1]``, taken as the first maximum
  (``torch.argmax``), which it equals wherever the maximum is single;
* the step runs in blocks of rays, each block's share of the L1 mean
  differentiated on its own and the gradients summed, so that it fits on
  the card beside nothing else (the loss is a sum over rays, so the
  gradient is the same up to rounding).

Every function takes a ``dtype``: float32 is the reference, a lower type
(bfloat16) is the control that the comparison has to reject.  Building a
reference turns TF32 off for float32 matrix products
(``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference import common as C

# corner j of a cell sits at offset ((j >> 2) & 1, (j >> 1) & 1, j & 1)
OFFSETS = tuple(((j >> 2) & 1, (j >> 1) & 1, j & 1) for j in range(8))


class VqadReference:
    def __init__(self, settings: dict, dist_min: float, dist_max: float,
                 block_rays: int = 512):
        s = settings
        self.s = s
        self.lods = tuple(range(s['base_lod'], s['base_lod'] + s['num_lods']))
        self.dist = (float(dist_min), float(dist_max))
        self.head_dtype = (torch.float32 if s['disable_amp']
                           else torch.bfloat16)
        self.block_rays = block_rays
        self._codes: Dict[tuple, torch.Tensor] = {}
        # float32 products in float32: the card would take TF32 otherwise
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- octree ------------------------------------------------------------
    def corner_codes(self, lod: int, device) -> torch.Tensor:
        """The sorted unique corner codes of the dense octree at ``lod``:
        every lattice point is a corner of an occupied cell, so they are
        ``0 .. (2^l + 1)^3 - 1``."""
        key = (lod, str(device))
        if key not in self._codes:
            self._codes[key] = torch.arange((2 ** lod + 1) ** 3,
                                            device=device)
        return self._codes[key]

    def corners(self, lod: int, pts: torch.Tensor):
        """Table rows [N, 8] (int64) of the corners of each point's cell at
        ``lod`` and their trilinear weights [N, 8] (float32)."""
        res = 2 ** lod
        x = (pts * 0.5 + 0.5) * res
        cell = torch.clamp(torch.floor(x), 0, res - 1)
        frac = torch.clamp(x - cell, 0.0, 1.0)
        bits = torch.tensor(OFFSETS, device=pts.device)             # [8, 3]
        w = torch.where(bits.bool()[None], frac[:, None, :],
                        1.0 - frac[:, None, :]).prod(-1)
        c = cell.long()[:, None, :] + bits[None]                    # [N, 8, 3]
        n = res + 1
        code = (c[..., 0] * n + c[..., 1]) * n + c[..., 2]
        codes = self.corner_codes(lod, pts.device)
        row = torch.searchsorted(codes, code.reshape(-1)).reshape(code.shape)
        if not bool((codes[row.clamp(max=codes.numel() - 1)] == code).all()):
            raise AssertionError('a corner outside the dense octree')
        return row, w

    # -- field -------------------------------------------------------------
    def features(self, grid: dict, pts: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
        """The grid's features [N, F] (``sum``) or [N, L F] (``cat``)."""
        out = []
        for i, lod in enumerate(self.lods):
            row, w = self.corners(lod, pts)
            logits = grid['logits'][i].to(dtype)[row]               # [N, 8, D]
            y_soft = torch.softmax(logits, dim=-1)
            hard = torch.nn.functional.one_hot(
                torch.argmax(y_soft, dim=-1), logits.shape[-1]).to(dtype)
            keys = y_soft + (hard - y_soft).detach()
            cf = keys @ grid['dictionary'][i].to(dtype)             # [N, 8, F]
            out.append((cf * w.to(dtype)[..., None]).sum(1))
        stacked = torch.stack(out, dim=1)                       # [N, L, F]
        if self.s['multiscale_type'] == 'sum':
            return stacked.sum(1)
        return stacked.reshape(stacked.shape[0], -1)

    def head(self, params: dict, feats: torch.Tensor, dirs: torch.Tensor):
        """(rgb [N, 3], density [N]) of the density and colour MLPs."""
        hd = self.head_dtype
        dens = C.mlp(params['decoder_density']['layers'], feats, hd)
        view = C.positional(-dirs, self.s['view_multires']).to(hd)
        rgb = torch.sigmoid(C.mlp(params['decoder_color']['layers'],
                                  torch.cat([dens, view], -1), hd))
        return rgb.float(), torch.relu(dens[:, 0]).float()

    # -- march and render --------------------------------------------------
    def march(self, rays_o, rays_d, u):
        """Samples [R, S, 3], depth and deltas [R, S], and the mask of the
        samples inside the unit cube (every cell occupied)."""
        R, S = u.shape
        dmin = torch.full((R, 1), self.dist[0], device=u.device)
        dmax = torch.full((R, 1), self.dist[1], device=u.device)
        base = torch.arange(S, dtype=torch.float32, device=u.device) * (
            1.0 / (S - 1))
        depth = (base[None] + u / S) * (dmax - dmin) + dmin
        pts = rays_o[:, None, :] + rays_d[:, None, :] * depth[..., None]
        mask = ((pts >= -1.0) & (pts <= 1.0)).all(-1)
        deltas = torch.diff(depth, dim=-1, prepend=dmin)
        return pts, depth, deltas, mask

    def render(self, params: dict, rays_o, rays_d, u, dtype=torch.float32):
        """Composited colours [R, 3] of a block of rays."""
        R, S = u.shape
        pts, _, deltas, mask = self.march(rays_o, rays_d, u)
        feats = self.features(params['grid'], pts.reshape(-1, 3), dtype)
        dirs = rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3)
        color, density = self.head(params, feats, dirs)
        color = torch.where(mask[..., None], color.reshape(R, S, 3).to(dtype),
                            0.0)
        tau = torch.where(mask, density.reshape(R, S).to(dtype), 0.0) \
            * deltas.to(dtype)
        # exclusive transmittance sum along each ray, in float64 for the
        # reference (float32 for a lower-precision control)
        acc_t = torch.float64 if dtype == torch.float32 else torch.float32
        excl = (torch.cumsum(tau.to(acc_t), -1) - tau.to(acc_t)).to(dtype)
        w = torch.exp(-excl) * (1.0 - torch.exp(-tau))
        rgb = (w[..., None] * color).sum(1)
        alpha = w.sum(1, keepdim=True)
        if self.s['bg_color'] == 'white':
            return (1.0 - alpha) + rgb
        return alpha * rgb

    # -- step --------------------------------------------------------------
    def step(self, state: dict, rays_o, rays_d, gt, draws: dict,
             dtype=torch.float32, half: bool = False,
             frozen: Optional[tuple] = None) -> dict:
        """One training step from ``state`` ({'params', 'mu', 'nu',
        'count'}): the loss, the gradients Adam takes and the new state.
        Planted faults: ``half`` leaves out the second half of the rays
        (the mean over the rest); ``frozen``, a leaf's path, is left as it
        was."""
        s = self.s
        u = draws['march_u']
        if half:
            n = rays_o.shape[0] // 2
            rays_o, rays_d, gt, u = rays_o[:n], rays_d[:n], gt[:n], u[:n]
        params = C.tree_map(lambda t: t.detach().clone(), state['params'])
        leaves = C.trained(params)
        for t in leaves.values():
            t.requires_grad_(True)
        paths = list(leaves)
        R = rays_o.shape[0]
        grads: Dict[tuple, torch.Tensor] = {}
        loss = 0.0
        for a in range(0, R, self.block_rays):
            b = slice(a, a + self.block_rays)
            rgb = self.render(params, rays_o[b], rays_d[b], u[b], dtype)
            # this block's share of the L1 mean over every ray and channel
            part = s['rgb_loss'] * torch.abs(rgb.float() - gt[b]).sum() \
                / (R * 3)
            g = torch.autograd.grad(part, [leaves[p] for p in paths],
                                    allow_unused=True)
            for p, gi in zip(paths, g):
                if gi is not None:
                    grads[p] = grads[p] + gi if p in grads else gi
            loss += float(part.detach())
        params = C.tree_map(lambda t: t.detach(), params)
        opt_grads = C.optimizer_grads(params, grads,
                                      {'grid': s['weight_decay']})
        lrs = {'decoder': s['lr'], 'grid': s['grid_lr'], 'rest': s['lr']}
        new = C.adam(params, state, opt_grads, lrs)
        if frozen is not None:
            old = dict(C.leaves(state['params']))[frozen]
            dict(C.leaves(new['params']))[frozen].copy_(old)
        return {'loss': loss, 'opt_grads': opt_grads, 'state': new}
