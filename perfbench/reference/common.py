"""Plain PyTorch pieces of SHACIRA's training step, shared by the NeRF and
image references.

Written from the method's definition (and, where the semantics are
fixed by the JAX package the port follows, as frozen copies of its plain
formulas): the multi-resolution hash grid, SGA quantization and the
affine latent decoder, the Balle-style bit estimator, MLP heads, the
decay schedules and Adam over SHACIRA's five parameter groups.  Nothing
here imports the program under test: the reference takes the same
settings, weights and inputs and works everything else out again.

Every function takes a ``dtype``: float32 is the reference, a lower type
(bfloat16) is the control that the comparison has to reject.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF
SGA_EPS = 1e-6
SGA_U_MIN = float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def leaves(tree, prefix=()) -> Iterator[Tuple[tuple, torch.Tensor]]:
    """(path, leaf) of a dict/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def label(path: tuple) -> str:
    """SHACIRA's optimizer group of a parameter path; the latent decoder's
    ``div`` (set by recalibration) and ``dft`` are not trained."""
    joined = '/'.join(path)
    if 'latent_dec' in joined:
        return 'frozen' if path[-1] in ('div', 'dft') else 'latent_dec'
    if 'prob_model' in joined:
        return 'prob_models'
    if 'decoder' in joined:
        return 'decoder'
    if 'grid' in joined:
        return 'grid'
    return 'rest'


def trained(params) -> Dict[tuple, torch.Tensor]:
    return {p: t for p, t in leaves(params) if label(p) != 'frozen'}


# ---------------------------------------------------------------------------
# schedules (epochs count from 1)
# ---------------------------------------------------------------------------

def decay(name: str, step: float, total: float, start: float, end: float,
          decay_period: float = None, temperature: float = None) -> float:
    s, n = float(step), float(total)
    if name == 'fix':
        return start
    if name == 'linear':
        return start + (end - start) * min(s / n, 1.0)
    if name == 'exp':
        return max(end, start * temperature ** (s / (n * decay_period)))
    if name == 'cosine':
        return end + 0.5 * (start - end) * (1.0 + math.cos(math.pi * s / n))
    raise ValueError(name)


# ---------------------------------------------------------------------------
# hash grid
# ---------------------------------------------------------------------------

def geometric_resolutions(lo: int, hi: int, n: int) -> Tuple[int, ...]:
    """Instant-NGP's progression ``floor(lo * b**l) + 1``."""
    if n == 1:
        return (int(1 + np.floor(lo)),)
    b = np.exp((np.log(hi) - np.log(lo)) / (n - 1))
    return tuple(int(1 + np.floor(lo * (b ** l))) for l in range(n))


def _wrap32(x: int) -> int:
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


@dataclass(frozen=True)
class Grid:
    resolutions: Tuple[int, ...]
    bitwidth: int
    dim: int

    @property
    def size(self) -> int:
        return 2 ** self.bitwidth

    def direct(self, res: int) -> bool:
        """A LOD indexes its table directly when every partial power of
        its resolution (C int32 arithmetic) stays below the table size."""
        acc = 1
        for _ in range(self.dim):
            acc = _wrap32(acc * res)
            if acc >= self.size:
                return False
        return True

    @property
    def lod_sizes(self) -> Tuple[int, ...]:
        return tuple(min(self.size, r ** self.dim) for r in self.resolutions)

    @property
    def offsets(self) -> Tuple[int, ...]:
        return tuple(int(x) for x in np.cumsum((0,) + self.lod_sizes)[:-1])

    @property
    def rows(self) -> int:
        return sum(self.lod_sizes)


def corners(grid: Grid, lod: int, coords: torch.Tensor):
    """Global table rows [N, 2^dim] and multilinear weights [N, 2^dim]
    (float32) of the LOD's cell corners around ``coords`` in [-1, 1]."""
    res = grid.resolutions[lod]
    x = torch.clamp(res * (coords.float() * 0.5 + 0.5), 0.0, res - 1 - 1e-5)
    pos = torch.clamp(torch.floor(x), max=max(res - 2, 0))
    frac = torch.clamp(x - pos, 0.0, 1.0)
    pos = pos.long()
    n_c = 2 ** grid.dim
    bits = torch.tensor([[(j >> (grid.dim - 1 - d)) & 1
                          for d in range(grid.dim)] for j in range(n_c)],
                        device=coords.device)                    # [C, dim]
    cpos = pos[:, None, :] + bits[None]                          # [N, C, dim]
    w = torch.where(bits[None].bool(), frac[:, None, :],
                    1.0 - frac[:, None, :]).prod(-1)
    if grid.direct(res):
        stride = torch.tensor([res ** d for d in range(grid.dim)],
                              device=coords.device)
        idx = (cpos * stride).sum(-1)
    else:
        acc = (cpos[..., 0] * PRIMES[0]) & U32
        for d in range(1, grid.dim):
            acc = acc ^ ((cpos[..., d] * PRIMES[d]) & U32)
        idx = acc & (grid.size - 1)
    return idx + grid.offsets[lod], w


def encode(grid: Grid, table: torch.Tensor, coords: torch.Tensor,
           dtype=torch.float32) -> torch.Tensor:
    """Per-LOD blend of the table rows at the corners, LODs concatenated:
    [N, L * F]."""
    table = table.to(dtype)
    out = []
    for lod in range(len(grid.resolutions)):
        idx, w = corners(grid, lod, coords)
        out.append((table[idx] * w.to(dtype)[..., None]).sum(1))
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# latents: SGA / rounding, the affine decoder, the bit estimator
# ---------------------------------------------------------------------------

def sga(x: torch.Tensor, temperature: float, u: torch.Tensor) -> torch.Tensor:
    """Stochastic Gumbel annealing between floor and ceil (two categories,
    differentiable sampling): floor(x) + sigmoid((dl / T + logistic(u)) /
    T)."""
    xf = torch.floor(x)
    dl = (torch.tanh(torch.clamp(x - xf, -1 + SGA_EPS, 1 - SGA_EPS))
          - torch.tanh(torch.clamp(xf + 1.0 - x, -1 + SGA_EPS,
                                   1 - SGA_EPS)))
    g = torch.log(u) - torch.log1p(-u)
    return xf + torch.sigmoid((dl / temperature + g) / temperature)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    return x + (torch.round(x) - x).detach()


def decode_table(grid_params: dict, *, use_sga: bool, temperature: float,
                 sga_u, dtype=torch.float32) -> torch.Tensor:
    """The latent table quantized (SGA or rounding), divided by ``div``
    and decoded by the single affine layer: [T, F]."""
    cb = grid_params['codebook'].to(dtype)
    dec = grid_params['latent_dec']
    q = sga(cb, temperature, sga_u.to(dtype)) if use_sga else round_ste(cb)
    z = q / dec['div'].to(dtype)
    layer = dec['layers'][0]
    out = z @ layer['scale'].to(dtype)
    if 'shift' in layer:
        out = out + layer['shift'].to(dtype)
    return out


def _softplus(x):
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0)


def cdf(pm: dict, num_layers: int, x: torch.Tensor) -> torch.Tensor:
    """The bit estimator's CDF: ``num_layers - 1`` gated layers (of f1..f3)
    and the final sigmoid layer f4."""
    for i in range(1, 4):
        if num_layers > i:
            f = pm[f'f{i}']
            x = x * _softplus(f['h']) + f['b']
            x = x + torch.tanh(x) * torch.tanh(f['a'])
    f = pm['f4']
    return torch.sigmoid(x * _softplus(f['h']) + f['b'])


def bits_per_latent(grid_params: dict, num_layers: int, noise: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Rate: bits of ``codebook + noise`` under the model's CDF, clamped
    to [0, 50] each, over the table's rows."""
    pm = tree_map(lambda t: t.to(dtype), grid_params['prob_model'])
    w = grid_params['codebook'].to(dtype) + noise.to(dtype)
    p = cdf(pm, num_layers, w + 0.5) - cdf(pm, num_layers, w - 0.5)
    bits = torch.clamp(-torch.log(p + 1e-10) / math.log(2.0), 0.0, 50.0)
    return bits.sum() / w.shape[0]


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

def mlp(layers: list, x: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w + b`` per layer (weights stored [in, out]), relu between."""
    h = x.to(dtype)
    for i, layer in enumerate(layers):
        h = h @ layer['w'].to(dtype) + layer['b'].to(dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def positional(x: torch.Tensor, num_freq: int) -> torch.Tensor:
    """[x, sin(x 2^k), cos(x 2^k)] for k < num_freq, frequency-major."""
    bands = 2.0 ** torch.linspace(0.0, float(num_freq - 1), num_freq,
                                  device=x.device)
    xb = x[..., None, :] * bands[:, None]
    return torch.cat([x, torch.sin(xb).flatten(-2), torch.cos(xb).flatten(-2)],
                     dim=-1)


# ---------------------------------------------------------------------------
# Adam over SHACIRA's groups
# ---------------------------------------------------------------------------

B1, B2, EPS = 0.9, 0.999, 1e-8


def optimizer_grads(params: dict, grads: Dict[tuple, torch.Tensor],
                    wd: Dict[str, float]) -> Dict[tuple, torch.Tensor]:
    """The gradient each trained leaf's Adam update takes: its loss
    gradient (zero where the loss does not use the leaf) plus L2 decay."""
    out = {}
    for path, p in trained(params).items():
        g = grads.get(path)
        g = torch.zeros_like(p) if g is None else g.float()
        d = wd.get(label(path), 0.0)
        out[path] = g + d * p if d else g
    return out


@torch.no_grad()
def adam(params: dict, moments: dict, opt_grads: Dict[tuple, torch.Tensor],
         lrs: Dict[str, object]) -> dict:
    """One bias-corrected Adam step: returns new params and moments
    (``moments``: {'mu', 'nu'} trees and 'count')."""
    count = moments['count'] + 1
    c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
    new_p = tree_map(lambda t: t.detach().clone(), params)
    mu = tree_map(lambda t: t.clone(), moments['mu'])
    nu = tree_map(lambda t: t.clone(), moments['nu'])
    new_leaves = dict(leaves(new_p))
    mus, nus = dict(leaves(mu)), dict(leaves(nu))
    for path, g in opt_grads.items():
        m, v, p = mus[path], nus[path], new_leaves[path]
        m.mul_(B1).add_((1 - B1) * g)
        v.mul_(B2).add_((1 - B2) * torch.square(g))
        p.sub_(lrs[label(path)] * (m / c1) / (torch.sqrt(v / c2) + EPS))
    return {'params': new_p, 'mu': mu, 'nu': nu, 'count': count}


def zero_moments(params: dict) -> dict:
    z = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), params)
    return {'mu': z, 'nu': tree_map(torch.zeros_like, z), 'count': 0}
