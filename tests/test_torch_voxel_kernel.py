"""Kernel V1 (``csrc/voxel_dda.cu``, the 'voxel' march's DDA walk) and its
plain version ``accel/occupancy.voxel_crossings_plain``, without the JAX
package (so that the tests marked ``cuda`` run on the card's machine,
which has no JAX): the single-rounding product-sum both compute, the
walk's stopping rule, and the kernel against the plain version on the
card, ``valid`` and the depths equal, on ray sets that reach every path of
its walk (``chip_smoke.dda_edge_rays``: rays on cell faces, edges and
corners, stalling rays, empty box intervals).
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import chip_smoke  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays  # noqa: E402
from shacira_tpu_torch.utils import perf  # noqa: E402


def _rays(n: int, seed: int, axis_aligned: bool = False):
    """(origins, dirs) [n, 3] f32: cameras on a sphere of radius 2.5 aimed
    into the box; with ``axis_aligned`` the directions keep one to three
    of their components (the others exactly zero: the 1e-9 guard)."""
    rng = np.random.RandomState(seed)
    o = rng.normal(size=(n, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.9, 0.9, (n, 3)) - o
    if axis_aligned:
        keep = rng.rand(n, 3) < 0.4
        keep[np.arange(n), rng.randint(0, 3, n)] = True
        d = np.where(keep, d, 0.0)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _grid(level: int, density: float, seed: int) -> np.ndarray:
    res = 2 ** level
    return np.random.RandomState(seed).rand(res, res, res) < density


def _round_f32(x: Fraction) -> np.float32:
    """The f32 nearest the exact ``x``, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """``fma_f32`` is the exact ``a * b + c`` rounded once to f32, on random
    triples and on one that rounding first to f64 and then to f32 gets
    wrong: a * b + c lies just below a tie, which the f64 sum lands on."""
    rng = np.random.RandomState(0)
    a, b, c = (rng.uniform(-4, 4, 300).astype(np.float32) * np.float32(
        2.0) ** rng.randint(-30, 5, 300).astype(np.float32) for _ in range(3))
    a = np.append(a, np.float32(2.0 ** -24 * (1 + 2.0 ** -23)))
    b = np.append(b, np.float32(1 - 2.0 ** -23))
    c = np.append(c, np.float32(1 + 2.0 ** -23))
    got = tocc.fma_f32(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    want = np.asarray([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    twice = np.float32(np.float64(a[-1]) * np.float64(b[-1]) + c[-1])
    assert got[-1] == np.float32(1 + 2.0 ** -23) != twice


def test_walk_stops_where_nothing_more_can_be_recorded():
    """The kernel stops a ray's walk at its first step with ``t >= tmax``:
    ``t`` never decreases, so no later step is ahead of ``tmax`` or
    occupied; the plain version's crossings equal those of the steps
    ahead of ``tmax`` alone."""
    o, d = _rays(256, seed=1, axis_aligned=True)
    cfg = tocc.OccupancyGridConfig(5)
    state = {'occ': torch.as_tensor(_grid(5, 0.3, seed=2))}
    rays = make_rays(torch.as_tensor(o), torch.as_tensor(d), 0.0, 6.0)
    t_ent, t_exi, occ_l, ahead = tocc.dda_steps(state, cfg, rays)
    assert bool(torch.all(t_ent[:, 1:] >= t_ent[:, :-1]))
    assert bool(torch.all(ahead[:, 1:] <= ahead[:, :-1]))     # once False
    assert not bool(torch.any(occ_l & ~ahead))
    assert bool(torch.all((t_exi >= t_ent) | ~ahead))
    walked = ahead.sum(dim=1)
    n_steps = 3 * cfg.res + 2
    assert bool(((walked > 0) & (walked < n_steps)).any())   # stops early
    before = perf.counted('launches/voxel_crossings')
    out = tocc.voxel_crossings(state, cfg, rays, 16)          # CPU: plain
    assert perf.counted('launches/voxel_crossings') == before
    np.testing.assert_array_equal(out['valid'].sum(dim=1).numpy(),
                                  np.minimum(occ_l.sum(dim=1).numpy(), 16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: kernel V1 runs only on the card')
    return torch.device('cuda')


def _card_rays(kind: str, n: int, level: int):
    """(origins, dirs, dist_min, dist_max) numpy: 'mixed' is n - n // 5
    rays aimed into the box and n // 5 with exactly zero direction
    components, at distance bounds [0, 6]; other kinds are
    ``chip_smoke.dda_edge_rays`` families."""
    if kind != 'mixed':
        return chip_smoke.dda_edge_rays(kind, n, 2 ** level, seed=level)
    o, d = _rays(n - n // 5, seed=level)
    o2, d2 = _rays(n // 5, seed=level + 7, axis_aligned=True)
    return (np.concatenate([o, o2]), np.concatenate([d, d2]),
            np.zeros(n, np.float32), np.full(n, 6.0, np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize('level,density,I,kind,n', [
    pytest.param(4, 1.0, 8, 'mixed', 2560, id='4-1.0-8'),
    pytest.param(5, 0.2, 32, 'mixed', 2560, id='5-0.2-32'),
    pytest.param(7, 0.05, 64, 'mixed', 2560, id='7-0.05-64'),
    pytest.param(7, 1.0, 64, 'mixed', 2560, id='7-1.0-64'),
    # ray counts off the block: a lone ray, a warp and one, 4096 + 1
    pytest.param(7, 0.05, 64, 'mixed', 1, id='one-ray'),
    pytest.param(5, 0.3, 16, 'mixed', 33, id='33-rays'),
    pytest.param(7, 0.05, 64, 'mixed', 4097, id='4097-rays'),
    # the I-th crossing inside a look-ahead batch; I past the staged slots
    pytest.param(5, 0.5, 1, 'mixed', 2560, id='I-1'),
    pytest.param(5, 0.5, 3, 'mixed', 2560, id='I-3'),
    pytest.param(7, 1.0, 100, 'mixed', 1024, id='I-100'),
    # rays that start on a face, an edge or a corner, cross corners, stall
    # on direction components in (-1e-9, 0], or miss the box
    *(pytest.param(7, 0.3, 16, kind, 999, id=kind)
      for kind in chip_smoke.DDA_EDGE_KINDS)])
def test_dda_kernel_matches_plain_on_card(cuda_device, level, density, I,
                                          kind, n):
    """Kernel V1 against the plain loop: ``valid`` and the depths equal bit
    for bit, on ray sets and slot counts that reach every path of its walk
    (look-ahead batches cut by the stop, steps on cell faces, edges and
    corners, stalls, staged and direct slots, a partial last block)."""
    o, d, dmin, dmax = _card_rays(kind, n, level)
    cfg = tocc.OccupancyGridConfig(level)
    occ_t = torch.as_tensor(_grid(level, density, seed=3), device=cuda_device)
    rays = make_rays(*(torch.as_tensor(v, device=cuda_device)
                       for v in (o, d, dmin, dmax)))
    before = perf.counted('launches/voxel_crossings')
    got = tocc.voxel_crossings({'occ': occ_t}, cfg, rays, I)
    want = tocc.voxel_crossings_plain({'occ': occ_t}, cfg, rays, I)
    torch.cuda.synchronize()
    assert perf.counted('launches/voxel_crossings') == before + 1
    assert torch.equal(got['valid'], want['valid'])
    assert torch.equal(got['entries'], want['entries'])
    assert torch.equal(got['exits'], want['exits'])
    assert (int(got['valid'].sum()) > 0) == (kind != 'empty')


@pytest.mark.cuda
def test_dda_wrapper_checks_its_inputs_on_card(cuda_device):
    cfg = tocc.OccupancyGridConfig(4)
    o, d = _rays(8, seed=0)
    rays = make_rays(torch.as_tensor(o, device=cuda_device),
                     torch.as_tensor(d, device=cuda_device))
    with pytest.raises(ValueError):        # occupancy of the wrong size
        tocc.voxel_crossings({'occ': torch.ones((8, 8, 8), dtype=torch.bool,
                                                device=cuda_device)},
                             cfg, rays, 4)
    with pytest.raises(ValueError):        # occupancy on the CPU
        tocc.voxel_crossings({'occ': torch.ones((16,) * 3,
                                                dtype=torch.bool)},
                             cfg, rays, 4)
