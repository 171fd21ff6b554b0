"""The ``'voxel'`` march's side of the harness: the work a step of the V8
configuration needs, counted from the configuration's widths and the
step's shapes (never from what the program happened to launch).

The march is dense: every ray has ``max_intersections`` crossing slots of
``num_steps`` samples each, and every slot goes through the field and the
backward, live or not (no sample budget).
"""
from __future__ import annotations

from perfbench.harness import roofline
from perfbench.reference import common as C

# one ray's origin, direction and two distance bounds, float32
RAY_BYTES = 8 * 4
# a crossing slot's entry and exit (float32) and its valid flag (bool)
SLOT_BYTES = 4 + 4 + 1


def table_rows(s: dict) -> int:
    return C.Grid(C.geometric_resolutions(s['min_grid_res'],
                                          s['max_grid_res'], s['num_lods']),
                  s['codebook_bitwidth'], 3).rows


def crossing_slots(s: dict) -> int:
    """Crossing slots a step: ``max_intersections`` a ray."""
    return int(s['num_rays_sampled_per_img']) * int(s['max_intersections'])


def samples(s: dict) -> int:
    """Field samples a step: ``num_steps`` a crossing slot."""
    return crossing_slots(s) * int(s['num_steps'])


def dda_bound_s(s: dict) -> float:
    """Least time of the DDA (kernel V1): the rays read once, the
    occupancy grid (a byte a cell) read once and every crossing slot
    written once, at the HBM peak."""
    cells = (2 ** int(s['blas_level'])) ** 3
    byts = (int(s['num_rays_sampled_per_img']) * RAY_BYTES + cells
            + crossing_slots(s) * SLOT_BYTES)
    return byts / roofline.HBM_BYTES_PER_S


def b1_bound_s(s: dict) -> float:
    """Least time of kernel B1 in the encode's backward, as
    ``roofline.scatter_bound_s`` counts it for every cell: every sample's
    8 corner rows a LOD (index and latent-width gradient) read once and
    the latent table written once.  The dense integration sums no rows."""
    ld = s['latent_dim'] or s['feature_dim']
    return roofline.scatter_bound_s(samples(s) * s['num_lods'] * 8, ld,
                                    table_rows(s))


def step_flops(s: dict) -> int:
    """FLOPs of one step: ``roofline.nerf_step_flops`` on every slot."""
    return roofline.nerf_step_flops(s, table_rows(s), samples(s))
