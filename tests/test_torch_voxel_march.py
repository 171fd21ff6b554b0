"""Port parity for the 'voxel' march's occupancy functions against
shacira_tpu.accel.occupancy: the DDA crossings (``voxel_crossings``, whose
card path is kernel V1), the samples inside them (``raymarch_voxel``) and
the occupancy seeded from a point cloud (``occupancy_from_points``).

Tolerances: ``valid`` and the seeded occupancy exactly; entries and exits
within 1e-6 (the plain loop repeats the scan body's arithmetic, with the
one product-sum that the JAX package's XLA fuses computed as a single-
rounding FMA, so in practice they agree bit for bit); samples, depths and
deltas 1e-6 relative (XLA fuses ``entry + width * frac`` and ``o + d *
depth`` into FMAs, the port rounds twice).  Kernel V1 against the plain
version is in tests/test_torch_voxel_kernel.py (no JAX import, so that it
runs on the card's machine).
"""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays as tmake_rays  # noqa: E402


def _rays(kind: str, n: int, seed: int):
    """(origins, dirs) [n, 3] f32 of a ray family: 'random' (cameras
    outside the box aimed into it), 'axis' (directions along the axes and
    with exactly zero components, the 1e-9 guard), 'miss' (aimed away from
    the box) or 'inside' (origins inside the box)."""
    rng = np.random.RandomState(seed)
    if kind == 'inside':
        o = rng.uniform(-0.8, 0.8, (n, 3))
        d = rng.normal(size=(n, 3))
    else:
        o = rng.normal(size=(n, 3))
        o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        d = rng.uniform(-0.9, 0.9, (n, 3)) - o
    if kind == 'axis':
        axis = rng.randint(0, 3, n)
        keep = rng.rand(n, 3) < 0.3
        keep[np.arange(n), axis] = True
        d = np.where(keep, d, 0.0)
        d[: n // 4] = 0.0
        d[np.arange(n // 4), axis[: n // 4]] = np.sign(
            -o[np.arange(n // 4), axis[: n // 4]]) + (
            o[np.arange(n // 4), axis[: n // 4]] == 0)
    if kind == 'miss':
        d = -d
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _grid(level: int, density: float, seed: int) -> np.ndarray:
    res = 2 ** level
    return np.random.RandomState(seed).rand(res, res, res) < density


def _both(o, d, occ_np, level, dist=(0.0, 6.0)):
    jcfg, tcfg = jocc.OccupancyGridConfig(level), tocc.OccupancyGridConfig(
        level)
    jstate = {'occ': jnp.asarray(occ_np)}
    tstate = {'occ': torch.as_tensor(occ_np)}
    jrays = jmake_rays(jnp.asarray(o), jnp.asarray(d), *dist)
    trays = tmake_rays(torch.as_tensor(o), torch.as_tensor(d), *dist)
    return jcfg, tcfg, jstate, tstate, jrays, trays


def _check_crossings(got, want):
    np.testing.assert_array_equal(got['valid'].numpy(),
                                  np.asarray(want['valid']))
    for k in ('entries', 'exits'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize('kind,level,density,I', [
    ('random', 4, 0.3, 16), ('random', 5, 0.15, 32), ('axis', 4, 0.3, 16),
    ('miss', 4, 1.0, 8), ('inside', 5, 0.2, 24), ('random', 7, 0.05, 64),
    # the I-th crossing early in a walk
    ('random', 5, 0.5, 1), ('random', 5, 0.5, 3),
    # chip_smoke.dda_edge_rays: origins on cell faces, edges and corners,
    # corner-crossing diagonals, stalling directions, empty box intervals
    ('face', 5, 0.3, 16), ('edge', 5, 0.3, 3), ('corner', 7, 0.05, 64),
    ('diagonal', 5, 0.3, 16), ('stall', 4, 0.5, 16), ('empty', 4, 1.0, 8)])
def test_voxel_crossings_match_jax(kind, level, density, I):
    if kind in chip_smoke.DDA_EDGE_KINDS:
        o, d, *dist = chip_smoke.dda_edge_rays(kind, 96, 2 ** level,
                                               seed=level)
    else:
        (o, d), dist = _rays(kind, 96, seed=level), (0.0, 6.0)
    occ_np = _grid(level, density, seed=level + 1)
    jcfg, tcfg, jstate, tstate, jrays, trays = _both(o, d, occ_np, level,
                                                     tuple(dist))
    want = jax.jit(lambda r: jocc.voxel_crossings(jstate, jcfg, r, I))(jrays)
    got = tocc.voxel_crossings(tstate, tcfg, trays, I)
    _check_crossings(got, want)
    n = got['valid'].sum(dim=1)
    if kind in ('miss', 'empty'):
        assert int(n.max()) == 0
        assert float(got['entries'].abs().max()) == 0.0
    else:
        assert int(n.sum()) > 0
        # depth-ordered, inside each ray's bounds, zero past the count
        e, x, v = got['entries'], got['exits'], got['valid']
        assert bool(torch.all((e[:, 1:] >= e[:, :-1]) | ~v[:, 1:]))
        assert bool(torch.all((x >= e) | ~v))
        assert float(torch.where(v, 0.0, e).abs().max()) == 0.0


def test_voxel_crossings_overflow_keeps_the_first_crossings():
    """Every cell occupied: a ray close to the x axis crosses 16 cells of a
    res-16 grid, more than I = 4; the first four are kept, in depth order,
    from the box entry on, each a cell wide (the port's counterpart of
    tests/test_nerf.py::test_raymarch_voxel_overflow_keeps_first_crossings,
    with the crossings compared to JAX's)."""
    occ_np = np.ones((16, 16, 16), bool)
    o = np.asarray([[-2.0, 0.01, 0.02], [0.3, -2.0, -0.4]], np.float32)
    d = np.asarray([[1.0, 1e-4, 2e-4], [0.1, 1.0, 0.05]], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jcfg, tcfg, jstate, tstate, jrays, trays = _both(o, d, occ_np, 4,
                                                     (0.0, 4.0))
    I = 4
    got = tocc.voxel_crossings(tstate, tcfg, trays, I)
    _check_crossings(got, jocc.voxel_crossings(jstate, jcfg, jrays, I))
    assert bool(got['valid'].all())
    starts = got['entries'][0].numpy()
    assert abs(starts[0] - 1.0) < 1e-5
    # the crossings tile the ray, one cell (0.125) each
    np.testing.assert_array_equal(got['exits'][0, :-1].numpy(), starts[1:])
    np.testing.assert_allclose(np.diff(starts), 0.125, rtol=1e-3)


def test_zero_direction_components_stall_as_in_the_reference():
    """A direction component in (-1e-9, 0] divides as +1e-9 but picks the
    cell's lower face, so the exit lies behind the ray and the walk moves
    by ``eps`` a step (shacira_tpu/accel/occupancy.py:212-223): an
    axis-aligned ray records its first cell again and again.  The port
    reproduces the reference's crossings."""
    occ_np = np.ones((16, 16, 16), bool)
    o = np.asarray([[-2.0, 0.01, 0.02]], np.float32)
    d = np.asarray([[1.0, 0.0, 0.0]], np.float32)
    jcfg, tcfg, jstate, tstate, jrays, trays = _both(o, d, occ_np, 4,
                                                     (0.0, 4.0))
    got = tocc.voxel_crossings(tstate, tcfg, trays, 4)
    _check_crossings(got, jocc.voxel_crossings(jstate, jcfg, jrays, 4))
    assert float(got['exits'][0, -1] - got['entries'][0, 0]) < 1e-5


def test_raymarch_voxel_matches_jax_with_injected_jitter():
    o, d = _rays('random', 64, seed=11)
    occ_np = _grid(5, 0.2, seed=12)
    I, S = 16, 8
    jcfg, tcfg, jstate, tstate, jrays, trays = _both(o, d, occ_np, 5)
    u = np.random.RandomState(13).rand(64, I, S).astype(np.float32)
    want = jax.jit(lambda r, uu: jocc.raymarch_voxel(
        jstate, jcfg, r, S, uu, I))(jrays, jnp.asarray(u))
    got = tocc.raymarch_voxel(tstate, tcfg, trays, S, torch.as_tensor(u), I)
    np.testing.assert_array_equal(got['mask'].numpy(),
                                  np.asarray(want['mask']))
    for k in ('samples', 'depth', 'deltas'):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert got['mask'].float().mean() > 0.05
    with pytest.raises(ValueError):
        tocc.raymarch_voxel(tstate, tcfg, trays, S, torch.as_tensor(u[:, :4]),
                            I)


@pytest.mark.parametrize('dilate', [0, 1, 2])
def test_occupancy_from_points_matches_jax(dilate):
    rng = np.random.RandomState(dilate)
    pts = np.concatenate([rng.uniform(-0.9, 0.9, (300, 3)),
                          [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0],
                           [0.999, -0.999, 0.0]]]).astype(np.float32)
    cfg = jocc.OccupancyGridConfig(5)
    want = jocc.occupancy_from_points(cfg, pts, dilate=dilate)
    got = tocc.occupancy_from_points(tocc.OccupancyGridConfig(5), pts, 'cpu',
                                     dilate=dilate)
    np.testing.assert_array_equal(got['occ'].numpy(), np.asarray(want['occ']))
    assert got['occ'].dtype == torch.bool
    assert float(got['density'].abs().max()) == 0.0
    frac = float(got['occ'].float().mean())
    assert 0.0 < frac < (0.05 if dilate == 0 else 0.8)
