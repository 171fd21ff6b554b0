"""The port's V8 configuration (the ``'voxel'`` march on RTMV data) against
the plain reference of the benchmark, ``perfbench/reference/voxel.py``,
on seeded random weights at a small size on the CPU: the training step
through the normal path (``configs/nerf_V8.yaml`` frozen in
``perfbench/configs/v8.json`` at 3 LODs, a 2^8 table, latent_dim 2, a 16^3
occupancy grid seeded from the scene's point cloud, 32 rays x 8 crossings
x 4 steps, hidden 16, built by ``apps/train_nerf.build_trainer`` on a
scene of the benchmark's ``rtmv_scene`` kind), then the prune; the
reference's DDA against the port's ``voxel_crossings_plain``; the planted
faults; the new span, counter and metric readers.  No JAX, so that the
test marked ``cuda`` (kernel V1 inside the span ``trace/dda`` of a
profile) runs on the card's machine.

Tolerances, each over the largest magnitude of what it compares: both
sides compute in float32 with a float32 head, the same operations in
another order (the program integrates every slot of a ray in float32,
the reference its live samples with a float64 transmittance), so the loss
agrees to 1e-6, the first gradients to 1e-5, Adam's updates to 1e-4 (an
update divides by the root of the second moment, which for an element
whose gradient is near Adam's epsilon passes a gradient's rounding on ten
times) and the prune's density grid, the same field at the same points,
to 1e-6.  The DDA's crossings are equal bit for bit: the reference
walks in float32 with the JAX package's arithmetic, which decides which
cells a walk records (``reference/voxel.py``).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import chip_smoke  # noqa: E402
from perfbench.harness import bench, profile, program, weights  # noqa: E402
from perfbench.reference import common as C  # noqa: E402
from perfbench.reference import voxel as V  # noqa: E402
from shacira_tpu_torch import config as cfg_mod  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.apps import train_nerf  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays  # noqa: E402
from shacira_tpu_torch.datasets.rtmv import load_rtmv  # noqa: E402
from shacira_tpu_torch.utils import perf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_lods=3, min_grid_res=4, max_grid_res=16,
             codebook_bitwidth=8, latent_dim=2, blas_level=4,
             num_rays_sampled_per_img=32, max_intersections=8, num_steps=4,
             hidden_dim=16, disable_amp=True)
SCENE = dict(views=12, res=32, render_batch=6)
LOSS_TOL, GRAD_TOL, UPDATE_TOL, PRUNE_TOL = 1e-6, 1e-5, 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings() -> dict:
    with open(os.path.join(ROOT, 'perfbench', 'configs', 'v8.json')) as f:
        return dict(json.load(f)['settings'], **SMALL)


def _mix() -> dict:
    with open(os.path.join(ROOT, 'perfbench', 'traffic', 'rtmv.json')) as f:
        return dict(json.load(f), **SCENE)


@pytest.fixture(scope='module')
def scene():
    return bench.kind(ROOT, 'rtmv_scene').make(_mix(), 2 ** 31 + 7, 'cpu')


def _trainer(s: dict, data, seed: int = 3):
    args = program.parse(cfg_mod.build_nerf_parser(), s, seed, 'cpu')
    tr = train_nerf.build_trainer(args, data)
    tr.set_params(weights.make(s, 'nerf', 2 * seed + 1, 'cpu'))
    return tr


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference over the largest magnitude of ``b``."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _worst(a: dict, b: dict) -> float:
    return max(_gap(a[p], b[p]) for p in b)


def _steps(tr, s, fault=None) -> list:
    """The port's and the reference's loss, first gradients and each
    step's update over steps 1-3 from the weights, then the prune's
    density grid: [(name, port, reference)]."""
    d = tr.dataset
    ref = V.VoxelReference(s, d.dist_min, d.dist_max, d.num_views, fault)
    occ = ref.occupancy(d.pointcloud, 'cpu')
    p0 = program.clone(tr.params)
    state = dict(C.zero_moments(p0), params=p0)
    out = []
    for it in (1, 2, 3):
        view = tr.np_rng.randint(d.num_views)
        idx = tr.np_rng.randint(0, d.rgb.shape[1], size=tr.num_rays)
        rays = [torch.as_tensor(a[view, idx])
                for a in (d.rays_o, d.rays_d, d.rgb)]
        hp = ref.hyper(it)
        draws = tr.draw_step(use_sga=hp['use_sga'])
        before = program.clone(tr.params)
        loss = float(tr.step(*rays, draws, ent_lambda=hp['ent'],
                             temperature=hp['temperature'],
                             lr_ldec=hp['lr_ldec'],
                             use_sga=hp['use_sga'])['loss'])
        r = ref.step(state, occ, *rays, {'march_u': draws.march_u,
                                         'sga_u': draws.sga_u,
                                         'noise': draws.noise}, it)
        out.append((f'loss {it}', loss, r['loss']))
        if it == 1:
            # Adam's first moment after one step is (1 - b1) g
            mu = dict(C.leaves(tr.opt_state['mu']))
            out.append(('grad 1', {p: mu[p] / (1 - C.B1)
                                   for p in r['opt_grads']},
                        r['opt_grads']))
        new, old = dict(C.leaves(tr.params)), dict(C.leaves(before))
        ref_new, ref_old = (dict(C.leaves(r['state']['params'])),
                            dict(C.leaves(state['params'])))
        out.append((f'update {it}',
                    {p: (new[p] - old[p]).detach() for p in ref_new},
                    {p: ref_new[p] - ref_old[p] for p in ref_new}))
        state = r['state']
    u = torch.rand((tr.model_cfg.occ_cfg.num_cells, 3),
                   generator=torch.Generator().manual_seed(5))
    params = program.clone(tr.params)
    density0, occ0 = (tr.occ_state[k].clone() for k in ('density', 'occ'))
    tr.prune(u)
    _, density = ref.prune(params, density0, occ0, u)
    out.append(('prune', tr.occ_state['density'], density))
    return out


def _misses(rows) -> list:
    bad = []
    for name, port, ref in rows:
        if name.startswith('loss'):
            gap, tol = abs(port - ref) / abs(ref), LOSS_TOL
        elif name == 'prune':
            gap, tol = _gap(port, ref), PRUNE_TOL
        else:
            gap = _worst(port, ref)
            tol = GRAD_TOL if name.startswith('grad') else UPDATE_TOL
        if not gap <= tol:
            bad.append((name, gap))
    return bad


def test_the_step_and_the_prune_equal_the_reference(scene):
    s = _settings()
    tr = _trainer(s, scene)
    ref = V.VoxelReference(s, scene.dist_min, scene.dist_max,
                           scene.num_views)
    # the occupancy the port seeds from the point cloud is the reference's
    assert torch.equal(tr.occ_state['occ'],
                       ref.occupancy(scene.pointcloud, 'cpu'))
    assert 0 < float(tr.occ_state['occ'].float().mean()) < 0.5
    # float32 products in float32 on a card too
    assert not torch.backends.cuda.matmul.allow_tf32
    rows = _steps(tr, s)
    assert [r[0] for r in rows] == ['loss 1', 'grad 1', 'update 1',
                                    'loss 2', 'update 2', 'loss 3',
                                    'update 3', 'prune']
    assert _misses(rows) == []
    # the steps moved the table and the prune found density
    assert float(rows[2][1][('grid', 'codebook')].abs().max()) > 0
    assert float(rows[-1][2].max()) > 0


@pytest.mark.parametrize('fault', V.FAULTS)
def test_each_planted_fault_fails_the_comparison(scene, fault):
    s = _settings()
    assert len(_misses(_steps(_trainer(s, scene), s, fault))) >= 1


@pytest.mark.parametrize('kind', ['random', 'face', 'edge', 'corner'])
def test_the_reference_dda_equals_the_ports(kind):
    """The reference's walk against the port's plain DDA
    (``voxel_crossings_plain``, which kernel V1 equals bit for bit) on a
    16^3 grid half occupied, 8 crossings a ray: cameras around the box, and
    ``chip_smoke.dda_edge_rays``' origins on cell faces, edges and
    corners."""
    res, I, n = 16, 8, 256
    rng = np.random.RandomState(4)
    if kind == 'random':
        o = rng.normal(size=(n, 3))
        o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
        d = rng.uniform(-0.9, 0.9, (n, 3)) - o
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o, d, dmin, dmax = (o.astype(np.float32), d.astype(np.float32),
                            0.0, 6.0)
    else:
        o, d, dmin, dmax = chip_smoke.dda_edge_rays(kind, n, res, seed=4)
    occ = torch.as_tensor(rng.rand(res, res, res) < 0.5)
    want = tocc.voxel_crossings_plain(
        {'occ': occ}, tocc.OccupancyGridConfig(level=4),
        make_rays(o, d, dmin, dmax), I)
    got = V.crossings(occ, torch.as_tensor(o), torch.as_tensor(d), dmin,
                      dmax, I)
    assert int(got['valid'].sum()) > n
    for k in ('valid', 'entries', 'exits'):
        assert torch.equal(got[k], want[k]), k


def test_the_mix_reads_as_the_whole_views_at_mip(tmp_path):
    """The kind writes only the pixels the loader reads at the mix's mip,
    as views of res / 2^mip, and loads them at mip 0: the arrays of
    ``load_rtmv`` reading the whole views at the mix's mip."""
    kind = bench.kind(ROOT, 'rtmv_scene')
    mix = dict(_mix(), views=6, res=16)
    got = kind.make(mix, 9, 'cpu')
    kind.write_scene(str(tmp_path), mix, 9, 'cpu', stride=1)
    want = load_rtmv(str(tmp_path), 'train', mip=mix['mip'],
                     bg_color=mix['bg_color'])
    for f in ('rgb', 'rays_o', 'rays_d', 'masks', 'pointcloud'):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.h, got.w, got.dist_min, got.dist_max) == (
        want.h, want.w, want.dist_min, want.dist_max)
    assert got.num_views == int(0.7 * mix['views'])


def test_the_entry_finds_stalling_rays():
    v8 = bench.entry(ROOT, 'v8')
    d = np.asarray([[0.3, -0.5, 0.8], [0.0, -0.6, 0.8], [-5e-10, 0.6, 0.8],
                    [5e-10, 0.6, 0.8], [-2e-9, 0.6, 0.8]], np.float32)
    assert v8.stalling(d) == 2


def test_a_voxel_step_names_its_dda_and_counts_its_crossings(scene):
    """The port's span around the DDA, inside the march, and its counter
    of valid crossings: a training step's, only while a profiler
    records."""
    s = _settings()
    tr = _trainer(s, scene)
    d = tr.dataset
    rays = make_rays(torch.as_tensor(d.rays_o[0, :32]),
                     torch.as_tensor(d.rays_d[0, :32]), d.dist_min,
                     d.dist_max)
    valid = int(tocc.voxel_crossings(tr.occ_state, tr.model_cfg.occ_cfg,
                                     rays, 8)['valid'].sum())
    assert valid > 0
    perf.reset_counts()
    with torch.profiler.profile() as prof:
        tocc.voxel_crossings(tr.occ_state, tr.model_cfg.occ_cfg, rays, 8)
        with torch.no_grad():       # a probe or a render: not counted
            tocc.voxel_crossings(tr.occ_state, tr.model_cfg.occ_cfg, rays,
                                 8)
        ro, rd, gt = (torch.as_tensor(a[0]) for a in tr._presample(1))
        tr.step(ro, rd, gt, tr.draw_step(use_sga=True), ent_lambda=1e-4,
                temperature=1.0, lr_ldec=0.015, use_sga=True)
    counted = perf.counted('trace/crossings')
    assert counted > valid
    dda = [e for e in prof.events() if e.name == 'trace/dda']
    assert len(dda) == 3
    march = [e for e in dda if e.cpu_parent is not None
             and e.cpu_parent.name == 'trace/march']
    assert len(march) == 1
    perf.reset_counts()


def test_the_new_readers_read_their_range_and_counter():
    dda = bench.reader(ROOT, 'dda_ms.v8')
    roof = bench.reader(ROOT, 'dda_roofline.v8')
    use = bench.reader(ROOT, 'crossing_use.v8')
    ranges = {'trace/march': 3.0, 'trace/dda': 0.07}
    t = profile.Trace(steps=2, wall_s=1.0, busy_s=0.5, device_ops=10,
                      ranges_ms=ranges,
                      kernels_s={'voxel_dda_kernel(float const*)': 1.4e-4},
                      gaps_s={}, extra={'dda_bound_ms': 0.0014,
                                        'crossing_slots': 1024})
    assert dda(t) == 0.07
    assert roof(t) == pytest.approx(2.0)
    perf.reset_counts()
    assert use(t) is None
    with torch.profiler.profile():
        perf.count('trace/crossings', torch.tensor(512))
    assert use(t) == pytest.approx(25.0)
    perf.reset_counts()
    del ranges['trace/dda']
    t.kernels_s.clear()
    assert dda(t) is None and roof(t) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: kernel V1 runs only on the card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_the_dda_range_holds_its_kernel(cuda_device):
    """In a profile, V1 belongs to ``trace/dda`` (the range ``dda_ms``
    reads), which lies inside ``trace/march``."""
    rng = np.random.RandomState(0)
    o = rng.normal(size=(4096, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.9, 0.9, (4096, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(*(torch.as_tensor(v.astype(np.float32),
                                       device=cuda_device) for v in (o, d)),
                     0.0, 6.0)
    state = {'occ': torch.as_tensor(rng.rand(128, 128, 128) < 0.3,
                                    device=cuda_device)}
    cfg = tocc.OccupancyGridConfig(7)
    tocc.voxel_crossings(state, cfg, rays, 64)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function('trace/march'):
            tocc.voxel_crossings(state, cfg, rays, 64)
        torch.cuda.synchronize()
    t = profile.reduce(prof.events(), 1, 1.0)
    v1 = t.kernel_ms('voxel_dda')
    assert v1
    assert t.range_ms('trace/dda') >= v1
    assert t.range_ms('trace/march') >= t.range_ms('trace/dda')
