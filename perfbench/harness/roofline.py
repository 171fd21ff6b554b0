"""The chip's peaks and the work a step needs, counted from the
configuration's widths and the step's inputs (never from what the program
happened to launch).

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def scatter_bound_s(n_rows: int, f: int, table_rows: int) -> float:
    """Least time of a row scatter-add (kernel B1): each input row's index
    (int32) and ``f`` float32 values read once, the ``table_rows`` x ``f``
    float32 table written once; one add a value.  Whichever of bytes and
    operations binds."""
    byts = n_rows * 4 + n_rows * f * 4 + table_rows * f * 4
    return max(byts / HBM_BYTES_PER_S, n_rows * f / F32_FLOPS)


def mlp_macs(dims) -> int:
    return sum(a * b for a, b in dims)


def grid_flops(lods: int, corners: int, f: int, ld: int, dim: int) -> int:
    """Forward and backward FLOPs of one point's multi-LOD blend: the
    corner weights (``dim`` products each), the blend of ``f`` decoded
    columns, and the backward's latent-width scatter values
    (``g @ scale^T`` and one product per corner and latent column)."""
    weights = corners * dim
    fwd = 2 * corners * f
    bwd = 2 * f * ld + 2 * corners * ld
    return lods * (weights + fwd + bwd)


def table_flops(rows: int, f: int, ld: int, prob_layers: int) -> int:
    """FLOPs of the table work a step does on every latent row: SGA
    (about 20), the affine decode, the rate's two CDF evaluations of
    ``prob_layers`` layers (about 8 each, with a log), each tripled for
    the backward, and Adam (about 12 a parameter)."""
    per = 3 * (20 + 2 * f * ld + 2 * (8 * prob_layers + 4)) + 12 * ld
    return rows * per


def nerf_step_flops(s: dict, table_rows: int, samples: int) -> int:
    """FLOPs of one NeRF step on ``samples`` field samples: the hash
    blend, the density and colour MLPs (forward and twice again for the
    backward), the volume integration (about 20 a sample) and the table
    work."""
    f, lods = s['feature_dim'], s['num_lods']
    ld = s['latent_dim'] or f
    h, n = s['hidden_dim'], s['num_layers']
    view = 3 + 6 * s['view_multires']
    dens = [(f * lods, h)] + [(h, h)] * (n - 1) + [(h, 16)]
    color = [(16 + view, h)] + [(h, h)] * n + [(h, 3)]
    per = (grid_flops(lods, 8, f, ld, 3)
           + 3 * 2 * (mlp_macs(dens) + mlp_macs(color)) + 20)
    return samples * per + table_flops(table_rows, f, ld,
                                       s['num_prob_layers'])


def image_step_flops(s: dict, table_rows: int, pixels: int) -> int:
    """FLOPs of one image step on ``pixels`` pixels: the 2D hash blend,
    the colour MLP (forward and backward) and the table work."""
    f, lods = s['feature_dim'], s['num_lods']
    ld = s['latent_dim'] or f
    h, n = s['hidden_dim'], s['num_layers']
    color = [(f * lods, h)] + [(h, h)] * (n - 1) + [(h, 3)]
    per = grid_flops(lods, 4, f, ld, 2) + 3 * 2 * mlp_macs(color)
    return pixels * per + table_flops(table_rows, f, ld,
                                      s['num_prob_layers'])
