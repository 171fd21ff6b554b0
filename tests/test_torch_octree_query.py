"""The octree grids' corner query (``ops/spc.py``: ``octree_corners``): on
the CPU its plain twin against the eager query it replaced in the octree
grid and against the octree's own geometry (occupancy, the dual octree's
corners, the weights' trilinear identity), on dense and sparse octrees,
with points on cell faces, edges and corners, at +-1 and outside the cube;
how the launch packs its LODs and what it refuses; the grid's route
through it.  On the card, kernel Q1 against the plain twin bit for bit,
one launch a forward, and Q1 inside ``field/octree_query`` in a profile.

No JAX import: the ``cuda`` tests run on the card's machine with
``python -m pytest --noconftest -m cuda tests/test_torch_octree_query.py``.
"""
import ctypes
import types

import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.models.grids import octree_grid as og  # noqa: E402
from shacira_tpu_torch.ops import spc  # noqa: E402
from shacira_tpu_torch.utils import perf  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: kernel Q1 has no CPU mode')
    return torch.device('cuda')


def _edge_points(lod: int, n: int, gen, device='cpu') -> torch.Tensor:
    """Points of [-1, 1]^3 with each axis on the lattice of ``lod``'s cell
    faces (k / 2^(lod - 1) - 1) with probability one half, so a point lies
    in a cell, on a face, an edge or a corner; then the cube's 8 corners,
    the centre and points just inside and outside the faces."""
    res = 2 ** lod
    lattice = torch.randint(0, res + 1, (n, 3), generator=gen).float() \
        * (2.0 / res) - 1
    free = torch.rand((n, 3), generator=gen) * 2 - 1
    pick = torch.rand((n, 3), generator=gen) < 0.5
    pts = torch.where(pick, lattice, free)
    signs = torch.tensor([[(j >> 2) & 1, (j >> 1) & 1, j & 1]
                          for j in range(8)], dtype=torch.float32) * 2 - 1
    extra = torch.cat([signs, torch.zeros((1, 3)), signs * 1.25,
                       signs * (1 - 2.0 ** -20), signs * 0.5])
    return torch.cat([pts, extra]).to(device)


def _structure(kind: str, cfg, device='cpu', seed=0):
    """A dense octree, or a sparse one of a small sphere's points (most
    cells empty, so many points miss)."""
    if kind == 'dense':
        return og.OctreeStructure.make_dense(cfg, device=device)
    gen = torch.Generator().manual_seed(seed)
    d = torch.randn((400, 3), generator=gen)
    pts = 0.4 * d / d.norm(dim=-1, keepdim=True) + 0.2
    return og.OctreeStructure.from_pointcloud(cfg, pts, dilate=1,
                                              device=device)


def _eager(tables, coords, lods):
    """The octree grid's query before it had a kernel: a LOD at a time,
    the cell, ``spc.query_cells``, the trinkets' gather and
    ``spc.trilinear_coeffs``."""
    out = []
    for codes, trinkets, lod in zip(tables['codes'], tables['trinkets'],
                                    lods):
        cells = torch.floor((coords * 0.5 + 0.5) * (2 ** lod)).to(
            torch.int32)
        cells = torch.clamp(cells, 0, 2 ** lod - 1)
        pidx = spc.query_cells(codes, cells)
        out.append((trinkets[torch.clamp(pidx, min=0)],
                    spc.trilinear_coeffs(coords, cells, lod), pidx >= 0))
    return out


def _assert_equal(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(('corner_idx', 'w', 'valid'), g, w):
            assert a.dtype == b.dtype and a.shape == b.shape, (k, name)
            assert torch.equal(a, b), (k, name)


@pytest.mark.parametrize('kind', ['dense', 'sparse'])
def test_the_plain_twin_is_the_eager_query(kind):
    cfg = og.OctreeGridConfig(feature_dim=2, base_lod=2, num_lods=3)
    st = _structure(kind, cfg)
    gen = torch.Generator().manual_seed(1)
    coords = _edge_points(cfg.active_lods[-1], 3000, gen)
    got = spc.octree_corners(coords, st.tables(), cfg.active_lods)
    _assert_equal(got, _eager(st.tables(), coords, cfg.active_lods))
    if kind == 'sparse':
        assert not all(bool(v.all()) for _, _, v in got)
        assert all(bool(v.any()) for _, _, v in got)


@pytest.mark.parametrize('kind', ['dense', 'sparse'])
def test_the_query_follows_the_octrees_geometry(kind):
    """Each point's valid flag is its cell's occupancy; a hit's corner j
    is its cell plus corner j's offset among the dual octree's corners; a
    miss takes trinket row 0; the weights sum to 1 and give the point back
    as the weighted sum of its corners."""
    cfg = og.OctreeGridConfig(feature_dim=2, base_lod=3, num_lods=2)
    st = _structure(kind, cfg)
    gen = torch.Generator().manual_seed(2)
    coords = _edge_points(cfg.active_lods[-1], 2000, gen)
    offs = torch.tensor(spc.CORNER_OFFSETS)
    parts = spc.octree_corners(coords, st.tables(), cfg.active_lods)
    for (ci, w, v), lod, trinkets in zip(parts, cfg.active_lods,
                                         st.tables()['trinkets']):
        res = 2 ** lod
        cells = spc.quantize_points(coords, lod)
        occ = st.octree.occupancy_mask(lod)
        assert torch.equal(v, occ[cells[:, 0], cells[:, 1], cells[:, 2]])
        corners, _ = spc.build_dual(st.octree, lod)
        assert torch.equal(corners[ci[v].long()],
                           cells[v][:, None, :] + offs[None])
        assert torch.equal(ci[~v], trinkets[0].expand(int((~v).sum()), 8))
        assert torch.allclose(w.sum(-1), torch.ones(len(w)), atol=1e-6)
        inside = (coords.abs() <= 1).all(-1)
        x = (coords * 0.5 + 0.5) * res
        back = (w[..., None] * (cells[:, None, :] + offs[None])).sum(1)
        assert torch.allclose(back[inside], x[inside], atol=1e-4)


def test_an_empty_batch_gives_empty_outputs():
    cfg = og.OctreeGridConfig(feature_dim=2, base_lod=1, num_lods=2)
    st = _structure('dense', cfg)
    parts = spc.octree_corners(torch.zeros((0, 3)), st.tables(),
                               cfg.active_lods)
    assert [tuple(x.shape) for p in parts for x in p] == [
        (0, 8), (0, 8), (0,)] * 2


@pytest.mark.parametrize('grid', ['octree', 'codebook'])
def test_the_grid_queries_through_octree_corners(monkeypatch, grid):
    """NGLOD's and VQAD's forwards call ``octree_corners`` once, over
    every LOD."""
    calls = []
    query = spc.octree_corners

    def counting(coords, tables, lods):
        calls.append(tuple(lods))
        return query(coords, tables, lods)

    monkeypatch.setattr(spc, 'octree_corners', counting)
    gen = torch.Generator().manual_seed(0)
    coords = torch.rand((40, 3), generator=gen) * 2 - 1
    if grid == 'octree':
        cfg = og.OctreeGridConfig(feature_dim=3, base_lod=1, num_lods=3,
                                  feature_std=0.5)
        st = og.OctreeStructure.make_dense(cfg)
        params = og.octree_grid_init(gen, cfg, st, 'cpu')
        out = og.interpolate(params, cfg, st, coords)
    else:
        cfg = og.CodebookOctreeGridConfig(feature_dim=3, base_lod=1,
                                          num_lods=3, feature_std=0.5,
                                          codebook_bitwidth=3)
        st = og.OctreeStructure.make_dense(cfg)
        params = og.codebook_grid_init(gen, cfg, st, 'cpu')
        out = og.codebook_interpolate(params, cfg, st, coords)
    assert out.shape == (40, 3)
    assert calls == [(1, 2, 3)]


# ---------------------------------------------------------------------------
# The launch, with a stand-in library on the CPU
# ---------------------------------------------------------------------------

class _Lib:
    """A library whose ``octree_query_forward`` records its arguments and
    returns 0."""

    def __init__(self):
        self.calls = []
        lib = self

        class _Fn:
            argtypes = restype = None

            def __call__(self, *args):
                lib.calls.append(args)
                return 0

        self.octree_query_forward = _Fn()


@pytest.fixture
def stream(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0x5eed))


def _tables(kind='sparse'):
    cfg = og.OctreeGridConfig(feature_dim=2, base_lod=2, num_lods=3)
    st = _structure(kind, cfg)
    return cfg, st.tables()


def test_the_launch_packs_every_lod(stream):
    cfg, tables = _tables()
    coords = torch.rand((33, 3)) * 2 - 1
    lib = _Lib()
    outs = spc._launch_query(coords, tables, cfg.active_lods, lib=lib)
    (args,) = lib.calls
    ptr, n, arr, count, s = args
    assert (ptr, n, count, s) == (coords.data_ptr(), 33, 3, 0x5eed)
    assert ctypes.sizeof(spc._QueryLod) == 56
    for k, lod in enumerate(cfg.active_lods):
        ci, w, v = outs[k]
        assert (ci.dtype, w.dtype, v.dtype) == (torch.int32, torch.float32,
                                                torch.bool)
        assert (ci.shape, w.shape, v.shape) == ((33, 8), (33, 8), (33,))
        e = arr[k]
        assert (e.codes, e.trinkets) == (tables['codes'][k].data_ptr(),
                                         tables['trinkets'][k].data_ptr())
        assert (e.corner_idx, e.w, e.valid) == (
            ci.data_ptr(), w.data_ptr(), v.data_ptr())
        assert (e.m, e.lod) == (tables['codes'][k].shape[0], lod)


def _refused(what):
    cfg, tables = _tables()
    coords = torch.zeros((5, 3))
    lods = list(cfg.active_lods)
    if what == 'too_many_lods':
        n = spc.MAX_QUERY_LODS + 1
        tables = {'codes': tables['codes'][:1] * n,
                  'trinkets': tables['trinkets'][:1] * n}
        lods = lods[:1] * n
    elif what == 'lod_11':
        lods[-1] = 11
    elif what == 'f64_coords':
        coords = coords.double()
    elif what == 'coords_with_grad':
        coords.requires_grad_()
    elif what == 'missing_table':
        tables = dict(tables, trinkets=tables['trinkets'][:-1])
    elif what == 'int32_codes':
        tables = dict(tables, codes=(tables['codes'][0].int(),
                                     *tables['codes'][1:]))
    elif what == 'no_codes':
        tables = dict(tables,
                      codes=(tables['codes'][0][:0], *tables['codes'][1:]),
                      trinkets=(tables['trinkets'][0][:0],
                                *tables['trinkets'][1:]))
    return coords, tables, lods


@pytest.mark.parametrize('what', ['too_many_lods', 'lod_11', 'f64_coords',
                                  'coords_with_grad', 'missing_table',
                                  'int32_codes', 'no_codes'])
def test_what_the_card_refuses(stream, what):
    coords, tables, lods = _refused(what)
    lib = _Lib()
    with pytest.raises(ValueError, match='^octree_corners: '):
        spc._launch_query(coords, tables, lods, lib=lib)
    assert lib.calls == []


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_case(case, dev):
    """(coords, tables, lods) of one case on the card."""
    gen = torch.Generator().manual_seed(3)
    if case == 'dense_5_8':
        # the codebook cell's octree at a reduced batch, in (ray, depth)
        # order: 512 rays of 512 steps through the cube, and edge points
        cfg = og.OctreeGridConfig(feature_dim=5, base_lod=5, num_lods=4)
        o = torch.rand((512, 1, 3), generator=gen) * 2 - 1
        d = torch.randn((512, 1, 3), generator=gen)
        d = d / d.norm(dim=-1, keepdim=True)
        t = torch.linspace(-1.8, 1.8, 512)[None, :, None]
        coords = torch.cat([(o * 0.3 + d * t).reshape(-1, 3),
                            _edge_points(8, 20000, gen)])
    elif case == 'sparse':
        cfg = og.OctreeGridConfig(feature_dim=5, base_lod=4, num_lods=4)
        coords = torch.cat([torch.rand((200000, 3), generator=gen) * 2 - 1,
                            _edge_points(7, 20000, gen)])
    else:                                   # 'edges', every LOD 0 to 10
        cfg = og.OctreeGridConfig(feature_dim=5, base_lod=0, num_lods=11)
        coords = torch.cat([_edge_points(lod, 2000, gen)
                            for lod in range(11)])
    if case == 'edges':
        # a point cloud's octree: dense at the coarse LODs, sparse below
        octree = spc.Octree.from_pointcloud(
            torch.rand((5000, 3), generator=gen) * 2 - 1, 10, device=dev)
        st = og.OctreeStructure(octree, cfg.active_lods)
    else:
        st = _structure('sparse' if case == 'sparse' else 'dense', cfg,
                        device=dev)
    return coords.to(dev), st.tables(), cfg.active_lods


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['dense_5_8', 'sparse', 'edges'])
def test_q1_equals_the_plain_twin(cuda_device, case):
    coords, tables, lods = _card_case(case, cuda_device)
    got = spc._launch_query(coords, tables, lods)
    want = spc.octree_corners_plain(coords, tables, lods)
    torch.cuda.synchronize()
    _assert_equal(got, want)
    if case != 'dense_5_8':
        assert not all(bool(v.all()) for _, _, v in want)


@pytest.mark.cuda
def test_one_launch_a_forward(cuda_device):
    """``octree_corners`` and a VQAD training forward each launch Q1 once
    over every LOD."""
    cfg = og.CodebookOctreeGridConfig(feature_dim=5, base_lod=2,
                                      num_lods=3, feature_std=0.5,
                                      codebook_bitwidth=4)
    st = og.OctreeStructure.make_dense(cfg, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = og.codebook_grid_init(gen, cfg, st, cuda_device)
    coords = torch.rand((5000, 3), generator=gen, device=cuda_device) * 2 - 1
    perf.reset_counts()
    spc.octree_corners(coords, st.tables(), cfg.active_lods)
    assert perf.counted('launches/octree_query') == 1
    perf.reset_counts()
    og.codebook_interpolate(params, cfg, st, coords)
    torch.cuda.synchronize()
    assert perf.counted('launches/octree_query') == 1
    perf.reset_counts()


@pytest.mark.cuda
def test_the_query_range_holds_its_kernel(cuda_device):
    """In a profile, Q1's device time falls inside
    ``field/octree_query``, the range ``octree_query_ms`` reads."""
    from perfbench.harness import profile
    cfg = og.OctreeGridConfig(feature_dim=5, base_lod=5, num_lods=4)
    st = og.OctreeStructure.make_dense(cfg, device=cuda_device)
    coords = torch.rand((200000, 3), device=cuda_device) * 2 - 1
    og._corners(cfg, st, coords)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        og._corners(cfg, st, coords)
        torch.cuda.synchronize()
    t = profile.reduce(prof.events(), 1, 1.0)
    q1 = t.kernel_ms('octree_query_kernel')
    assert q1
    assert t.range_ms('field/octree_query') >= q1
