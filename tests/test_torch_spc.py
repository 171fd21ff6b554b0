"""Port parity: shacira_tpu_torch.ops.spc (morton codes, the octree, its
queries, the dual octree) against shacira_tpu.ops.spc.

Integers (codes, cells, query indices, corners, trinkets) must be equal;
the trilinear weights and the total variation agree within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shacira_tpu.ops import spc as jspc
from shacira_tpu_torch.ops import spc


def _cells(seed, n, level):
    return np.random.RandomState(seed).randint(0, 2 ** level, (n, 3))


def test_morton_codes_and_decode_match_jax():
    pts = _cells(0, 2000, 10)
    codes = spc.morton3d(torch.as_tensor(pts))
    want = jspc.morton3d_np(pts.astype(np.uint64))
    np.testing.assert_array_equal(codes.numpy(), want.astype(np.int64))
    jcodes = np.asarray(jspc.morton3d(jnp.asarray(pts.astype(np.int32))))
    np.testing.assert_array_equal(codes.numpy(), jcodes.astype(np.int64))
    np.testing.assert_array_equal(spc.morton_decode(codes).numpy(),
                                  jspc.morton_decode_np(want))
    np.testing.assert_array_equal(spc.morton_decode(codes).numpy(), pts)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_quantize_points_matches_jax(dtype):
    rng = np.random.RandomState(1)
    pts = rng.uniform(-1.2, 1.2, (3000, 3)).astype(dtype)
    pts[:4] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0], [0.5, -0.5, 0.25]]
    for level in (3, 7):
        np.testing.assert_array_equal(
            spc.quantize_points(torch.as_tensor(pts), level).numpy(),
            jspc.quantize_points(pts, level))


def _assert_same_octree(got, want):
    assert got.max_level == want.max_level
    assert len(got.level_codes) == len(want.level_codes)
    for g, w in zip(got.level_codes, want.level_codes):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize('level', [0, 1, 3])
def test_dense_octree_matches_jax(level):
    got, want = spc.Octree.make_dense(level), jspc.Octree.make_dense(level)
    _assert_same_octree(got, want)
    assert got.num_cells(level) == want.num_cells(level) == 8 ** level
    np.testing.assert_array_equal(got.points(level).numpy(),
                                  want.points(level))


@pytest.mark.parametrize('dilate', [0, 1, 2])
def test_octree_from_pointcloud_matches_jax(dilate):
    rng = np.random.RandomState(2)
    pts = (rng.randn(400, 3) * 0.3).clip(-1, 1).astype(np.float32)
    got = spc.Octree.from_pointcloud(pts, 5, dilate=dilate)
    want = jspc.Octree.from_pointcloud(pts, 5, dilate=dilate)
    _assert_same_octree(got, want)
    np.testing.assert_array_equal(got.occupancy_mask(5).numpy(),
                                  want.occupancy_mask(5))
    np.testing.assert_array_equal(got.points(4).numpy(), want.points(4))


def test_query_cells_matches_jax_including_misses():
    cells = _cells(3, 60, 4)
    tree = spc.Octree.from_quantized_points(torch.as_tensor(cells), 4)
    jtree = jspc.Octree.from_quantized_points(cells, 4)
    queries = np.concatenate([cells[:20], _cells(4, 200, 4),
                              [[0, 0, 0], [15, 15, 15]]]).astype(np.int32)
    got = spc.query_cells(tree.level_codes[4], torch.as_tensor(queries))
    want = np.asarray(jspc.query_cells(jnp.asarray(jtree.level_codes[4]),
                                       jnp.asarray(queries)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == -1).sum() > 0 and (got[:20] >= 0).all()
    # a query past the largest code clips before the compare: -1, no error
    big = spc.query_cells(tree.level_codes[4][:1],
                          torch.as_tensor([[15, 15, 15]]))
    assert int(big[0]) == -1


@pytest.mark.parametrize('case', ['dense', 'sparse', 'pair'])
def test_build_dual_corners_and_trinkets_equal_jax(case):
    if case == 'dense':
        tree, jtree, level = (spc.Octree.make_dense(3),
                              jspc.Octree.make_dense(3), 3)
    elif case == 'sparse':
        cells = _cells(5, 150, 5)
        tree = spc.Octree.from_quantized_points(torch.as_tensor(cells), 5)
        jtree, level = jspc.Octree.from_quantized_points(cells, 5), 5
    else:
        cells = np.asarray([[0, 0, 0], [1, 0, 0]])
        tree = spc.Octree.from_quantized_points(torch.as_tensor(cells), 1)
        jtree, level = jspc.Octree.from_quantized_points(cells, 1), 1
    for lod in range(level + 1):
        corners, trinkets = spc.build_dual(tree, lod)
        jcorners, jtrinkets = jspc.build_dual(jtree, lod)
        assert trinkets.dtype == torch.int32
        np.testing.assert_array_equal(corners.numpy(), jcorners)
        np.testing.assert_array_equal(trinkets.numpy(), jtrinkets)
    if case == 'pair':
        assert corners.shape[0] == 12        # 16 corners, 4 shared


def test_trilinear_coeffs_and_total_variation_match_jax():
    rng = np.random.RandomState(6)
    level = 3
    coords = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    cells = np.clip(np.floor((coords * 0.5 + 0.5) * 2 ** level), 0,
                    2 ** level - 1).astype(np.int32)
    got = spc.trilinear_coeffs(torch.as_tensor(coords),
                               torch.as_tensor(cells), level)
    want = np.asarray(jspc.trilinear_coeffs(jnp.asarray(coords),
                                            jnp.asarray(cells), level))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)
    tree = spc.Octree.make_dense(level)
    corners, trinkets = spc.build_dual(tree, level)
    feats = rng.randn(corners.shape[0], 3).astype(np.float32)
    tv = spc.total_variation(torch.as_tensor(feats), trinkets)
    jtv = jspc.total_variation(jnp.asarray(feats), jnp.asarray(
        trinkets.numpy()))
    np.testing.assert_allclose(float(tv), float(jtv), rtol=1e-6, atol=1e-6)
