"""The benchmark's own counting: table sizes, kernel bounds and FLOPs on
known shapes."""
from __future__ import annotations

import json
import os

import pytest
import torch

import tiny
from perfbench.harness import roofline
from perfbench.reference import common as C
from perfbench.reference.nerf import live_samples


def _settings(name):
    with open(os.path.join(tiny.REPO, 'perfbench', 'configs',
                           name + '.json')) as f:
        return json.load(f)['settings']


def _grid(s, dim):
    return C.Grid(C.geometric_resolutions(s['min_grid_res'],
                                          s['max_grid_res'], s['num_lods']),
                  s['codebook_bitwidth'], dim)


def test_table_rows_of_the_configurations():
    assert _grid(_settings('lego'), 3).rows == 7_879_908
    assert _grid(_settings('kodak'), 2).rows == 40_282


@pytest.mark.parametrize('rows, f, table, ms', [
    (37_748_736, 1, 40_282, 0.0902),           # B1(c): kodak's backward
    (201_326_592, 1, 7_879_908, 0.4902),       # B1(a): 1M lego samples
    (1_048_576, 5, 4096, 0.0075),              # B1(b): per-ray sums
])
def test_scatter_bounds(rows, f, table, ms):
    assert roofline.scatter_bound_s(rows, f, table) * 1e3 == \
        pytest.approx(ms, abs=5e-5)


def test_kodak_step_flops():
    s = _settings('kodak')
    pixels = 512 * 768
    # 24 LODs: 4 corner weights of 2 products, a 1-column blend over 4
    # corners, the backward's g @ scale^T and 4 corner products
    grid = 24 * (4 * 2 + 2 * 4 * 1 + 2 * 1 * 1 + 2 * 4 * 1)
    head = 3 * 2 * (24 * 16 + 16 * 3)
    table = 40_282 * (3 * (20 + 2 + 2 * (8 * 2 + 4)) + 12)
    assert roofline.image_step_flops(s, 40_282, pixels) == \
        pixels * (grid + head) + table


def test_nerf_step_flops_grow_with_samples():
    s = _settings('lego')
    a = roofline.nerf_step_flops(s, 7_879_908, 0)
    b = roofline.nerf_step_flops(s, 7_879_908, 1000)
    head = 3 * 2 * (96 * 128 + 128 * 16 + 43 * 128 + 128 * 128 + 128 * 3)
    assert b - a == 1000 * (head + 20 + 24 * (8 * 3 + 2 * 8 * 4 + 2 * 4
                                              + 2 * 8))


def test_live_samples_count_the_occupied_box():
    occ = torch.zeros((8, 8, 8), dtype=torch.bool)
    o = torch.tensor([[0.0, 0.0, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    assert live_samples(occ, o, d, 600, 0.0, 6.0) == 0
    occ[:] = True
    # samples at depths (i + .5) / 599 * 6 inside z in [-1, 1]: depth 2..4
    n = live_samples(occ, o, d, 600, 0.0, 6.0)
    assert abs(n - 200) <= 1
