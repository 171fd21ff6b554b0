"""Plain PyTorch reference of one SHACIRA NeRF training step and prune.

The step, from the configuration's settings alone: jittered samples along
each ray over the occupancy grid, the occupied ones thinned evenly to the
sample budget, the latent table quantized (SGA) and decoded, the hash
grid blended at every sample, the bf16 MLP head, volume rendering over
each ray's samples (transmittance by a float64 cumulative sum), L1 to the
pixels plus the rate of the latents, autograd's gradients and Adam.  The
prune: the rounded field's density at one jittered point per occupancy
cell, max with the decayed running density, thresholded.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import common as C


class NerfReference:
    def __init__(self, settings: dict, dist_min: float, dist_max: float,
                 num_views: int):
        s = settings
        self.s = s
        self.grid = C.Grid(C.geometric_resolutions(
            s['min_grid_res'], s['max_grid_res'], s['num_lods']),
            s['codebook_bitwidth'], 3)
        self.dist = (float(dist_min), float(dist_max))
        self.num_views = num_views
        self.head_dtype = (torch.float32 if s['disable_amp']
                           else torch.bfloat16)
        self.res = 2 ** int(s['blas_level'])
        self.use_sga = bool(s['use_sga'] and s['ldecode_enabled'])
        self.entropy = bool(s['ldecode_enabled'] and (
            s['entropy_reg'] > 0 or s['entropy_reg_end'] > 0))

    # -- schedules ---------------------------------------------------------
    def hyper(self, it: int) -> dict:
        """Schedule values of iteration ``it`` (1-based; one epoch is one
        pass over the views)."""
        s = self.s
        e = it // self.num_views + 1
        return {
            'ent': C.decay(s['entropy_reg_sched'], e, s['epochs'],
                           s['entropy_reg'], s['entropy_reg_end'],
                           s['decay_period'], s['temperature']),
            'temperature': C.decay('exp', e, s['epochs'], 1.0,
                                   s['temperature'], s['decay_period'],
                                   s['temperature']),
            'lr_ldec': C.decay('linear', e, s['ldec_lr_warmup'],
                               0.1 * s['ldec_lr'], s['ldec_lr']),
            'use_sga': self.use_sga and e / s['epochs'] <= s['decay_period'],
        }

    # -- field -------------------------------------------------------------
    def head(self, params: dict, feats: torch.Tensor, dirs: torch.Tensor):
        """(rgb [N, 3], density [N]) of the density and colour MLPs."""
        hd = self.head_dtype
        dens = C.mlp(params['decoder_density']['layers'], feats, hd)
        view = C.positional(-dirs, self.s['view_multires']).to(hd)
        rgb = torch.sigmoid(C.mlp(params['decoder_color']['layers'],
                                  torch.cat([dens, view], -1), hd))
        return rgb.float(), torch.relu(dens[:, 0]).float()

    # -- march -------------------------------------------------------------
    def march(self, occ: torch.Tensor, rays_o, rays_d, u):
        """Samples [R, S, 3], depth and deltas [R, S], occupied mask."""
        R, S = u.shape
        dmin = torch.full((R, 1), self.dist[0], device=u.device)
        dmax = torch.full((R, 1), self.dist[1], device=u.device)
        base = torch.arange(S, dtype=torch.float32, device=u.device) * (
            1.0 / (S - 1))
        depth = (base[None] + u / S) * (dmax - dmin) + dmin
        pts = rays_o[:, None, :] + rays_d[:, None, :] * depth[..., None]
        cell = torch.floor(torch.clamp((pts * 0.5 + 0.5) * self.res, 0,
                                       self.res - 1e-5)).long()
        inside = ((pts >= -1.0) & (pts <= 1.0)).all(-1)
        mask = occ[cell[..., 0], cell[..., 1], cell[..., 2]] & inside
        deltas = torch.diff(depth, dim=-1, prepend=dmin)
        return pts, depth, deltas, mask

    def kept(self, mask: torch.Tensor) -> torch.Tensor:
        """Flat positions of the occupied samples kept under the budget:
        every ``ceil(live / budget)``-th one, in ray and depth order."""
        live = torch.nonzero(mask.reshape(-1))[:, 0]
        budget = int(self.s['max_samples'])
        if budget <= 0 or budget >= mask.numel():
            return live
        stride = max(1, -(-live.numel() // budget))
        return live[::stride][:budget]

    # -- step --------------------------------------------------------------
    def loss(self, params: dict, occ, rays_o, rays_d, gt, draws: dict,
             hp: dict, dtype=torch.float32):
        """(loss, rgb loss) of one step's batch."""
        s = self.s
        R, S = draws['march_u'].shape
        pts, depth, deltas, mask = self.march(occ, rays_o, rays_d,
                                              draws['march_u'])
        keep = self.kept(mask)
        ray = torch.div(keep, S, rounding_mode='floor')
        table = C.decode_table(params['grid'], use_sga=hp['use_sga'],
                               temperature=hp['temperature'],
                               sga_u=draws.get('sga_u'), dtype=dtype)
        feats = C.encode(self.grid, table, pts.reshape(-1, 3)[keep], dtype)
        color, density = self.head(params, feats, rays_d[ray])
        color, density = color.to(dtype), density.to(dtype)
        tau = density * deltas.reshape(-1)[keep].to(dtype)
        # exclusive transmittance sum within each ray, in float64 for the
        # reference (float32 for a lower-precision control)
        acc_t = torch.float64 if dtype == torch.float32 else torch.float32
        dense = torch.zeros(R * S, dtype=acc_t, device=tau.device)
        dense = dense.index_copy(0, keep, tau.to(acc_t))
        excl = (torch.cumsum(dense.reshape(R, S), 1).reshape(-1)[keep]
                - tau.to(acc_t)).to(dtype)
        w = torch.exp(-excl) * (1.0 - torch.exp(-tau))
        vals = torch.cat([w[:, None] * color, w[:, None]], -1)
        sums = torch.zeros((R * S, 4), dtype=dtype, device=tau.device)
        sums = sums.index_copy(0, keep, vals).reshape(R, S, 4).sum(1)
        alpha = sums[:, 3:4]
        rgb = (1.0 - alpha) + sums[:, :3] if s['bg_color'] == 'white' \
            else alpha * sums[:, :3]
        rgb_loss = torch.mean(torch.abs(rgb.float() - gt))
        loss = s['rgb_loss'] * rgb_loss
        if self.entropy:
            loss = loss + hp['ent'] * C.bits_per_latent(
                params['grid'], s['num_prob_layers'], draws['noise'],
                dtype).float()
        return loss, rgb_loss

    def step(self, state: dict, occ, rays_o, rays_d, gt, draws: dict,
             it: int, dtype=torch.float32, half: bool = False) -> dict:
        """One training step from ``state`` ({'params', 'mu', 'nu',
        'count'}): the loss, the gradients Adam takes and the new state.
        ``half`` leaves out the second half of the rays (a planted fault:
        the mean over the rest)."""
        s = self.s
        hp = self.hyper(it)
        if half:
            n = rays_o.shape[0] // 2
            rays_o, rays_d, gt = rays_o[:n], rays_d[:n], gt[:n]
            draws = dict(draws, march_u=draws['march_u'][:n])
        params = C.tree_map(lambda t: t.detach().clone(), state['params'])
        leaves = C.trained(params)
        for t in leaves.values():
            t.requires_grad_(True)
        loss, rgb_loss = self.loss(params, occ, rays_o, rays_d, gt, draws,
                                   hp, dtype)
        paths = list(leaves)
        g = torch.autograd.grad(loss, [leaves[p] for p in paths],
                                allow_unused=True)
        grads = {p: gi for p, gi in zip(paths, g) if gi is not None}
        params = C.tree_map(lambda t: t.detach(), params)
        wd = {'grid': s['weight_decay'],
              'latent_dec': s['weight_decay_decoder'],
              'prob_models': s['weight_decay_decoder']}
        opt_grads = C.optimizer_grads(params, grads, wd)
        scale = params['grid']['latent_dec']['layers'][0]['scale']
        lr_grid = s['grid_lr']
        if s['scale_grid_lr'] == 'div':
            lr_grid = lr_grid / torch.linalg.norm(scale)
        elif s['scale_grid_lr'] == 'mul':
            lr_grid = lr_grid * torch.linalg.norm(scale)
        lrs = {'decoder': s['lr'], 'grid': lr_grid,
               'latent_dec': hp['lr_ldec'], 'prob_models': 1e-4,
               'rest': s['lr']}
        new = C.adam(params, state, opt_grads, lrs)
        return {'loss': float(loss.detach()),
                'rgb_loss': float(rgb_loss.detach()),
                'opt_grads': opt_grads, 'state': new}

    # -- prune -------------------------------------------------------------
    @torch.no_grad()
    def prune(self, params: dict, density_old: torch.Tensor,
              occ_old: torch.Tensor, u: torch.Tensor, dtype=torch.float32,
              block: int = 1 << 18):
        """(occupancy, density) after one prune with cell jitter ``u``
        [res^3, 3] (cells in x-major raster order)."""
        s, res = self.s, self.res
        ar = torch.arange(res, device=u.device)
        cells = torch.stack(torch.meshgrid(ar, ar, ar, indexing='ij'),
                            -1).reshape(-1, 3)
        pts = ((cells + u) / res) * 2.0 - 1.0
        table = C.decode_table(params['grid'], use_sga=False,
                               temperature=1.0, sga_u=None, dtype=dtype)
        dens = []
        for a in range(0, pts.shape[0], block):
            p = pts[a:a + block]
            feats = C.encode(self.grid, table, p, dtype)
            d = C.mlp(params['decoder_density']['layers'], feats,
                      self.head_dtype)
            dens.append(torch.relu(d[:, 0]).float())
        density = torch.cat(dens).reshape(res, res, res)
        d = torch.maximum(density_old * s['prune_density_decay'], density)
        occ = d > s['prune_min_density']
        if not bool(occ.any()):
            occ = occ_old
        return occ, d


def live_samples(occ: torch.Tensor, rays_o, rays_d, num_steps: int,
                 dist_min: float, dist_max: float) -> int:
    """Occupied samples of a batch of rays at mid-cell jitter (0.5): the
    work the march hands the field before the budget."""
    R = rays_o.shape[0]
    res = occ.shape[0]
    u = torch.full((R, num_steps), 0.5, device=rays_o.device)
    base = torch.arange(num_steps, dtype=torch.float32,
                        device=rays_o.device) * (1.0 / (num_steps - 1))
    depth = (base[None] + u / num_steps) * (dist_max - dist_min) + dist_min
    total = 0
    for a in range(0, R, 512):
        pts = rays_o[a:a + 512, None, :] + rays_d[a:a + 512, None, :] \
            * depth[a:a + 512, :, None]
        cell = torch.floor(torch.clamp((pts * 0.5 + 0.5) * res, 0,
                                       res - 1e-5)).long()
        inside = ((pts >= -1.0) & (pts <= 1.0)).all(-1)
        total += int((occ[cell[..., 0], cell[..., 1], cell[..., 2]]
                      & inside).sum())
    return total


def ray_batches(seed: int, steps: int, num_views: int, num_pixels: int,
                num_rays: int):
    """(view, pixel indices) of each of the first ``steps`` steps: one
    view and ``num_rays`` uniform pixels a step from the trainer's
    ``RandomState(seed)`` ray stream, as the JAX trainer draws them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        v = rng.randint(num_views)
        out.append((v, rng.randint(0, num_pixels, size=num_rays)))
    return out

