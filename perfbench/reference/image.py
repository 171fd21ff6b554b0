"""Plain PyTorch reference of one SHACIRA image training step.

From the configuration's settings alone: the latent table's ``div``
recalibrated on ``norm_every`` steps, quantized (SGA) and decoded, the 2D
hash grid blended at every pixel of the lattice in row-major order, the
MLP colour head, mean squared error plus the rate of the latents,
autograd's gradients and Adam with the configuration's L2 decay.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import common as C


def lattice(h: int, w: int) -> np.ndarray:
    """[h * w, 2] pixel coordinates (row, column) in [-1, 1), row-major."""
    r = (np.arange(h, dtype=np.float32) / h - 0.5) * 2.0
    c = (np.arange(w, dtype=np.float32) / w - 0.5) * 2.0
    gy, gx = np.meshgrid(r, c, indexing='ij')
    return np.stack([gy.reshape(-1), gx.reshape(-1)], axis=-1)


def recalibrated_div(codebook: torch.Tensor, norm: str) -> torch.Tensor:
    """Per-channel scale of the latents: the largest magnitude ('max') or
    the population standard deviation ('std')."""
    if norm == 'max':
        return torch.maximum(codebook.min(0).values.abs(),
                             codebook.max(0).values.abs())
    if norm == 'std':
        return codebook.std(0, correction=0)
    raise ValueError(norm)


class ImageReference:
    def __init__(self, settings: dict):
        s = settings
        self.s = s
        self.grid = C.Grid(C.geometric_resolutions(
            s['min_grid_res'], s['max_grid_res'], s['num_lods']),
            s['codebook_bitwidth'], 2)
        self.use_sga = bool(s['use_sga'] and s['ldecode_enabled'])
        self.entropy = bool(s['ldecode_enabled'] and (
            s['entropy_reg'] > 0 or s['entropy_reg_end'] > 0))

    def hyper(self, e: int) -> dict:
        """Schedule values of epoch ``e`` (one step an epoch), in float32
        as the trainer hands them to its step."""
        s = self.s
        f32 = lambda v: float(np.float32(v))
        return {
            'ent': f32(C.decay(s['entropy_reg_sched'], e, s['epochs'],
                               s['entropy_reg'], s['entropy_reg_end'],
                               s['decay_period'], s['temperature'])),
            'temperature': f32(C.decay('exp', e, s['epochs'], 1.0,
                                       s['temperature'], s['decay_period'],
                                       s['temperature'])),
            'lr_ldec': f32(s['ldec_lr']),
            'use_sga': self.use_sga and e / s['epochs'] <= s['decay_period'],
            'recalib': s['norm'] != 'none' and e % s['norm_every'] == 0,
        }

    def loss(self, params: dict, coords, gt, draws: dict, hp: dict,
             dtype=torch.float32):
        table = C.decode_table(params['grid'], use_sga=hp['use_sga'],
                               temperature=hp['temperature'],
                               sga_u=draws.get('sga_u'), dtype=dtype)
        feats = C.encode(self.grid, table, coords, dtype)
        pred = C.mlp(params['decoder_color']['layers'], feats, dtype)
        rgb_loss = torch.mean((pred.float() - gt) ** 2)
        loss = self.s['rgb_loss'] * rgb_loss
        if self.entropy:
            loss = loss + hp['ent'] * C.bits_per_latent(
                params['grid'], self.s['num_prob_layers'], draws['noise'],
                dtype).float()
        return loss, rgb_loss

    def step(self, state: dict, coords, gt, draws: dict, it: int,
             dtype=torch.float32, half: bool = False) -> dict:
        """One step (epoch ``it``) from ``state``; ``half`` drops the
        second half of the pixels (a planted fault)."""
        s = self.s
        hp = self.hyper(it)
        if half:
            n = coords.shape[0] // 2
            coords, gt = coords[:n], gt[:n]
        params = C.tree_map(lambda t: t.detach().clone(), state['params'])
        if hp['recalib']:
            params['grid']['latent_dec']['div'] = recalibrated_div(
                params['grid']['codebook'], s['norm'])
        leaves = C.trained(params)
        for t in leaves.values():
            t.requires_grad_(True)
        loss, rgb_loss = self.loss(params, coords, gt, draws, hp, dtype)
        paths = list(leaves)
        g = torch.autograd.grad(loss, [leaves[p] for p in paths],
                                allow_unused=True)
        grads = {p: gi for p, gi in zip(paths, g) if gi is not None}
        params = C.tree_map(lambda t: t.detach(), params)
        wd = {'grid': s['weight_decay'],
              'latent_dec': s['weight_decay_decoder'],
              'prob_models': s['weight_decay_decoder']}
        opt_grads = C.optimizer_grads(params, grads, wd)
        lr_grid = s['grid_lr']
        scale = params['grid']['latent_dec']['layers'][0]['scale']
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
