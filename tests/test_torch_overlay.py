"""Port parity of the debug layers: primitive packs, the overlay rasterizer,
the HTML debugger and the turntable's overlay layers, mirroring
tests/test_primitives.py on both packages.  Both sides are numpy, so packs,
projections and images are equal exactly."""
import json

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.core import primitives as jprim  # noqa: E402
from shacira_tpu.render import offline as joff  # noqa: E402
from shacira_tpu.render import overlay as jov  # noqa: E402
from shacira_tpu_torch.core import colors  # noqa: E402
from shacira_tpu_torch.core import primitives as tprim  # noqa: E402
from shacira_tpu_torch.core.transforms import ObjectTransform  # noqa: E402
from shacira_tpu_torch.render import offline as toff  # noqa: E402
from shacira_tpu_torch.render import overlay as tov  # noqa: E402


def _same_pack(a, b):
    for x, y in ((a.lines, b.lines), (a.points, b.points)):
        assert (x is None) == (y is None)
        if x is not None:
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)


def test_pack_add_append_eq():
    p = tprim.PrimitivesPack()
    p.add_lines(np.zeros(3), np.ones(3), colors.red)
    p.add_lines(np.zeros((2, 3)), np.ones((2, 3)), np.ones((2, 4)))
    s, e, c = p.lines
    assert s.shape == (3, 3) and c.shape == (3, 4)
    assert c[0, 3] == 1.0          # RGB promoted to RGBA
    q = tprim.PrimitivesPack()
    q.add_points([0.5, 0.5, 0.5], colors.green)
    q.append(p)
    assert q.lines[0].shape == (3, 3) and q.points[0].shape == (1, 3)
    assert q != p
    r, p2 = tprim.PrimitivesPack(), tprim.PrimitivesPack()
    r.add_lines(np.zeros(3), np.ones(3), colors.red)
    p2.add_lines(np.zeros(3), np.ones(3), colors.red)
    assert r == p2


def test_pack_constructors_match_jax():
    occ = np.random.RandomState(0).rand(8, 8, 8) < 0.2
    for got, want in (
            (tprim.aabb_lines(np.zeros((3, 3)), 0.5),
             jprim.aabb_lines(np.zeros((3, 3)), 0.5)),
            (tprim.world_grid(4, 1.0, 'xz'), jprim.world_grid(4, 1.0, 'xz')),
            (tprim.axes_gizmo(2.0, (0.1, 0.2, 0.3)),
             jprim.axes_gizmo(2.0, (0.1, 0.2, 0.3))),
            (tprim.occupancy_wireframe(occ, max_cells=10),
             jprim.occupancy_wireframe(occ, max_cells=10)),
            (tprim.occupancy_wireframe(torch.as_tensor(occ)),
             jprim.occupancy_wireframe(occ))):
        _same_pack(got, want)
    s, e, _ = tprim.world_grid(squares_per_axis=4, plane='xz').lines
    assert s.shape == (10, 3) and np.all(s[:, 1] == 0)
    assert tprim.occupancy_wireframe(np.zeros((2, 2, 2), bool)).lines is None
    assert tprim.occupancy_wireframe(np.ones((8, 8, 8), bool),
                                     max_cells=10).lines[0].shape == (120, 3)


def test_projection_matches_raygen_and_jax():
    cfg = toff.CameraConfig(width=64, height=48, fov=40.0)
    origin, target = (0.5, 1.0, 3.0), (0.0, 0.0, 0.0)
    ro, rd = toff.lookat_rays(origin, target, cfg)
    cam = tov.PinholeCamera.from_lookat(origin, target, cfg)
    jcam = jov.PinholeCamera.from_lookat(
        origin, target, joff.CameraConfig(width=64, height=48, fov=40.0))
    idx = np.array([0, 500, 48 * 64 - 1])
    pts = ro[idx] + 2.0 * rd[idx]
    col, row, depth, front = cam.project(pts)
    np.testing.assert_allclose(col, idx % 64, atol=1e-2)
    np.testing.assert_allclose(row, idx // 64, atol=1e-2)
    assert np.all(front) and np.all(depth > 0)
    for a, b in zip(cam.project(pts), jcam.project(pts)):
        np.testing.assert_array_equal(a, b)


def _scene_layers(prim):
    pack = prim.PrimitivesPack()
    pack.add_lines([-0.5, 0.0, 0.0], [0.5, 0.0, 0.0], (1.0, 0.0, 0.0))
    pack.add_lines([0.0, 0.0, 5.0], [0.0, 0.3, -1.0], (0.0, 1.0, 0.0, 0.5))
    pack.add_points([[0.2, 0.2, 0.0], [-0.3, 0.1, 0.4]], (0.0, 0.0, 1.0))
    pack.point_size = 3.0
    occ = np.zeros((4, 4, 4), bool)
    occ[1, 2, 1] = occ[2, 2, 2] = True
    return {'l': pack, 'occ': prim.occupancy_wireframe(occ),
            'axes': prim.axes_gizmo(0.5)}


@pytest.mark.parametrize('with_depth', [False, True])
def test_draw_layers_equals_jax(with_depth):
    cfg = dict(width=32, height=24, fov=45.0)
    cam = tov.PinholeCamera.from_lookat((0.4, 0.3, 3), (0, 0, 0),
                                        toff.CameraConfig(**cfg))
    jcam = jov.PinholeCamera.from_lookat((0.4, 0.3, 3), (0, 0, 0),
                                         joff.CameraConfig(**cfg))
    rng = np.random.RandomState(5)
    img = rng.rand(24, 32, 3).astype(np.float32)
    depth = (rng.rand(24, 32).astype(np.float32) * 4.0 if with_depth
             else None)
    got = tov.draw_layers(img, cam, _scene_layers(tprim), depth=depth)
    want = jov.draw_layers(img, jcam, _scene_layers(jprim), depth=depth)
    assert got is not img and np.any(got != img)
    np.testing.assert_array_equal(got, want)


def test_depth_test_clipping_and_transform():
    cfg = toff.CameraConfig(width=32, height=32, fov=45.0)
    cam = tov.PinholeCamera.from_lookat((0, 0, 3), (0, 0, 0), cfg)
    img = np.zeros((32, 32, 3), np.float32)
    pack = tprim.PrimitivesPack()
    pack.add_lines([-0.5, 0.0, 0.0], [0.5, 0.0, 0.0], colors.red)
    assert np.any(tov.draw_layers(img, cam, {'l': pack})[:, :, 0] > 0.5)
    occluded = np.full((32, 32), 1.0, np.float32)
    assert not np.any(tov.draw_layers(img, cam, {'l': pack},
                                      depth=occluded)[:, :, 0] > 0)
    behind = tprim.PrimitivesPack()
    behind.add_lines([0.0, 0.0, 5.0], [0.0, 0.0, 8.0], colors.red)
    assert not np.any(tov.draw_layers(img, cam, {'l': behind}) > 0)
    moved = tprim.PrimitivesPack(
        transform=ObjectTransform().translate((100, 0, 0)))
    moved.add_lines([-0.5, 0, 0], [0.5, 0, 0], colors.red)
    assert not np.any(tov.draw_layers(img, cam, {'l': moved}) > 0)
    splat = np.zeros((17, 17, 3), np.float32)
    tov.rasterize_points(splat, tov.PinholeCamera.from_lookat(
        (0, 0, 2), (0, 0, 0), toff.CameraConfig(width=17, height=17,
                                                fov=45.0)),
        [[0.0, 0.0, 0.0]], [[0, 0, 1, 1]], point_size=3.0)
    assert splat[8, 8, 2] == 1.0 and splat[:, :, 2].sum() == 9.0


def _sphere_trace(xp, clamp0):
    """Analytic sphere: rgb and a depth buffer (the hit distance);
    ``clamp0`` clamps at 0 in the array module ``xp``."""
    def trace(rays, _):
        o, d = rays.origins, rays.dirs
        b = xp.sum(o * d, -1)
        c = xp.sum(o * o, -1) - 0.5 ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - xp.sqrt(clamp0(disc))
        rgb = xp.where(hit[:, None], 0.4, 1.0) * xp.ones_like(o)
        depth = xp.where(hit, t, 0.0)[:, None]
        return {'rgb': rgb, 'depth': depth}
    return trace


def test_turntable_layers_equal_jax():
    kw = dict(width=20, height=16, fov=40.0, dist_max=6.0)
    jtrace = _sphere_trace(jnp, lambda x: jnp.clip(x, 0, None))
    ttrace = _sphere_trace(torch, lambda x: torch.clamp(x, min=0))
    got = list(toff.turntable(ttrace, toff.CameraConfig(**kw), num_angles=3,
                              radius=3.0, layers=_scene_layers(tprim),
                              device='cpu'))
    want = list(joff.turntable(jtrace, joff.CameraConfig(**kw), num_angles=3,
                               radius=3.0, layers=_scene_layers(jprim)))
    plain = list(toff.turntable(ttrace, toff.CameraConfig(**kw),
                                num_angles=3, radius=3.0, device='cpu'))
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        assert np.any(g != p)


def test_ps_debugger_html_matches_jax(tmp_path):
    from shacira_tpu.utils.debugger import PsDebugger as JDbg
    from shacira_tpu_torch.utils.debugger import PsDebugger
    obj = tmp_path / 'tri.obj'
    obj.write_text('v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n')
    pts = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    payloads = []
    for dbg, wrap in ((PsDebugger(), torch.as_tensor), (JDbg(), np.asarray)):
        dbg.register_point_cloud('pc', wrap(pts))
        dbg.add_scalar_quantity('pc', 'd', np.arange(10.0))
        dbg.add_vector_quantity('pc', 'n', np.ones((10, 3)))
        dbg.register_curve_network('rays', np.zeros((4, 2, 3)))
        dbg.add_surface_mesh('mesh', str(obj))
        payloads.append(dbg.payload())
    assert payloads[0] == payloads[1]
    path = PsDebugger()
    path.register_point_cloud('pc', pts)
    html = open(path.show(str(tmp_path / 'dbg.html'))).read()
    assert html.startswith('<!doctype html>') and '"pc"' in html
    assert payloads[0]['pc']['color_name'] == 'd'
    assert 'faces' in payloads[0]['mesh']
    json.dumps(payloads[0])
