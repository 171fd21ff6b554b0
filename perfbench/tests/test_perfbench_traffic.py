"""The traffic generator: the device renderer against its NumPy version,
the rays against the program's Blender loader, the photo against the
repository's generator, and inputs fixed by the seed."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny
from perfbench.harness import bench, scene, traffic

OBJECT = bench.kind(tiny.REPO, 'multiview_object')
PHOTO = bench.kind(tiny.REPO, 'photo')


def test_device_renderer_matches_numpy():
    res, views = 24, 3
    fx = scene.focal(res, 0.6911112070083618)
    poses = scene.rig(views, seed=5, radius=3.2, elevation=(0.35, 0.8))
    got = scene.render_views(OBJECT.sdf, torch.as_tensor(poses), res, res,
                             fx).numpy()
    for v in range(views):
        want = scene.render_view_np(OBJECT.sdf_np, poses[v], res, res, fx)
        diff = np.abs(got[v] - want)
        # float32 against NumPy's float64 sphere tracing: a pixel on a
        # silhouette may flip between hit and miss
        assert float((diff.max(-1) > 1e-2).mean()) < 0.02
        assert float(np.median(diff)) < 1e-4
        assert got[v][..., 3].sum() > 0          # the object is in view


def test_rays_match_the_blender_loader():
    from shacira_tpu_torch.datasets.nerf_synthetic import pinhole_rays
    res = 16
    fx = scene.focal(res, 0.6911112070083618)
    poses = scene.rig(2, seed=1, radius=3.2, elevation=(0.35, 0.8))
    norm = poses.copy()
    norm[:, :3, 3] /= 3.2
    o, d = scene.pixel_rays(torch.as_tensor(norm), res, res, fx)
    for v in range(2):
        wo, wd = pinhole_rays(norm[v], res, res, fx, fx)
        np.testing.assert_allclose(o[v].numpy(), wo, atol=1e-6)
        np.testing.assert_allclose(d[v].numpy(), wd, atol=1e-6)


def test_photo_is_the_repository_generator():
    import importlib.util
    import os
    path = os.path.join(tiny.REPO, 'tools', 'make_synthetic_data.py')
    spec = importlib.util.spec_from_file_location('msd', path)
    msd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(msd)
    np.testing.assert_array_equal(PHOTO.synth_photo(32, 48, 3),
                                  msd.synth_photo(32, 48, seed=3))


@pytest.mark.parametrize('seed', [0, 2 ** 31 + 7, 2 ** 33 + 1])
def test_inputs_follow_the_seed(seed):
    a = traffic.make(tiny.REPO, tiny.TINY_OBJECT, seed, 'cpu')
    b = traffic.make(tiny.REPO, tiny.TINY_OBJECT, seed, 'cpu')
    np.testing.assert_array_equal(a.rgb, b.rgb)
    np.testing.assert_array_equal(a.rays_d, b.rays_d)
    assert a.rgb.shape == (4, 256, 3) and a.rgb.dtype == np.float32
    p = traffic.make(tiny.REPO, tiny.TINY_PHOTO, seed, 'cpu')
    np.testing.assert_array_equal(p, traffic.make(tiny.REPO, tiny.TINY_PHOTO,
                                                  seed, 'cpu'))
    assert p.shape == (16, 24, 3)
    # 8-bit values, as a loaded PNG gives them
    np.testing.assert_allclose(p * 255, np.round(p * 255), atol=1e-3)
