"""Port parity for the SDF pipeline: mesh ops, datasets, NeuralSDF, the
differential operators, the trainer and the demo drive, against
shacira_tpu's SDF modules (the tests of tests/test_sdf.py,
tests/test_extras.py::test_neural_sdf_tex / ::test_differential_gradients_agree
and tests/test_grid_backbones.py::test_octree_from_mesh_and_from_spc, each
on the port and compared with the JAX package).

Tolerances: dataset pools and batches equal bit for bit (the same numpy
draws; the narrowband filter through the port's octree); ``points_to_sdf``
within 1e-6; NeuralSDF's output and parameter gradients within 1e-5 of the
largest value; three trainer chunks (a growth curriculum moving to two loss
LODs in the third) within 1e-4 on each chunk's loss (relative) and on the
parameters (absolute)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.datasets import sdf as jds  # noqa: E402
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.grids import octree_grid as jog  # noqa: E402
from shacira_tpu.models.nefs import sdf as jsdf  # noqa: E402
from shacira_tpu.models.nefs import sdf_tex as jsdf_tex  # noqa: E402
from shacira_tpu.ops import differential as jdiff  # noqa: E402
from shacira_tpu.ops import mesh as jmesh  # noqa: E402
from shacira_tpu.trainers import sdf_trainer as jst  # noqa: E402
from shacira_tpu_torch import optim as toptim  # noqa: E402
from shacira_tpu_torch.core.schedulers import grow_loss_lods  # noqa: E402
from shacira_tpu_torch.datasets import sdf as tds  # noqa: E402
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.grids import octree_grid as tog  # noqa: E402
from shacira_tpu_torch.models.nefs import sdf as tsdf  # noqa: E402
from shacira_tpu_torch.models.nefs import sdf_tex as tsdf_tex  # noqa: E402
from shacira_tpu_torch.ops import differential as tdiff  # noqa: E402
from shacira_tpu_torch.ops import mesh as tmesh  # noqa: E402
from shacira_tpu_torch.ops import spc as tspc  # noqa: E402
from shacira_tpu_torch.ops.sdf import compute_sdf_iou  # noqa: E402
from shacira_tpu_torch.trainers import sdf_trainer as tst  # noqa: E402
from shacira_tpu_torch.utils.convert import params_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers share the machine's cores, and OpenMP regions over small
    tensors stall when their threads outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# unit cube [-0.5, 0.5]^3 as 12 triangles, and the unit octahedron
CUBE_V = np.asarray([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                     for z in (-.5, .5)], np.float32)
CUBE_F = np.asarray([
    [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
    [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
    [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
OCTA_V = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                     [0, 0, 1], [0, 0, -1]], np.float64)
OCTA_F = np.asarray([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                     [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64)


def sphere_sdf(p, r=0.5):
    return (np.linalg.norm(np.asarray(p), axis=-1, keepdims=True)
            - r).astype(np.float32)


def _grid(mod, **kw):
    base = dict(feature_dim=2, num_lods=3, min_grid_res=4, max_grid_res=16,
                latent_dim=0, multiscale_type='cat', resolution_dim=3,
                feature_std=0.1, codebook_bitwidth=6, init_grid='normal')
    base.update(kw)
    return mod.LatentGridConfig.from_geometric(**base)


def _sdf_cfgs(**kw):
    return (jsdf.NeuralSDFConfig(grid=_grid(jlg), hidden_dim=16, **kw),
            tsdf.NeuralSDFConfig(grid=_grid(tlg), hidden_dim=16, **kw))


def _carried(jparams):
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    for _, leaf in toptim.tree_leaves_with_path(tparams):
        leaf.requires_grad_(True)
    return tparams


# --- tests/test_sdf.py on the port ---------------------------------------

def test_compute_sdf_iou():
    pred = np.asarray([-1, -1, 1, 1.])
    gts = np.asarray([-1, 1, -1, 1.])
    assert compute_sdf_iou(pred, gts) == 100.0 / 3.0
    assert compute_sdf_iou(torch.as_tensor(gts), gts) == 100.0


def test_mesh_sdf_on_cube_and_octahedron_match_jax():
    pts = np.asarray([[0.0, 0.0, 0.9], [0.0, 0.0, 0.0], [0.7, 0.0, 0.0]],
                     np.float32)
    sdf = tmesh.points_to_sdf(pts, CUBE_V, CUBE_F)
    np.testing.assert_allclose(sdf[0], 0.4, atol=1e-5)    # outside
    assert sdf[1] < 0                                      # inside
    np.testing.assert_allclose(abs(sdf[1]), 0.5, atol=1e-5)
    np.testing.assert_allclose(sdf[2], 0.2, atol=1e-5)
    rng = np.random.RandomState(0)
    for v, f in ((CUBE_V, CUBE_F), (OCTA_V.astype(np.float32), OCTA_F)):
        p = rng.uniform(-1.2, 1.2, (3000, 3)).astype(np.float32)
        np.testing.assert_allclose(tmesh.points_to_sdf(p, v, f, chunk=512),
                                   jmesh.points_to_sdf(p, v, f), rtol=0,
                                   atol=1e-6)


def test_surface_sampling_on_mesh():
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.asarray([[0, 1, 2]], np.int32)
    pts = tmesh.sample_surface(np.random.RandomState(0), v, f, 100)
    assert pts.shape == (100, 3)
    np.testing.assert_allclose(pts[:, 2], 0, atol=1e-6)
    assert np.all(pts[:, 0] + pts[:, 1] <= 1 + 1e-5)
    np.testing.assert_array_equal(
        pts, jmesh.sample_surface(np.random.RandomState(0), v, f, 100))


def test_load_obj_and_normalize_match_jax(tmp_path):
    path = tmp_path / 'octa.obj'
    lines = [f'v {x} {y} {z}' for x, y, z in OCTA_V * 3 + 1]
    lines += ['f ' + ' '.join(f'{i + 1}/1/1' for i in tri) for tri in OCTA_F]
    lines += ['f 1 3 5 2']                       # a quad, fan-triangulated
    path.write_text('\n'.join(lines) + '\n')
    tv, tf = tmesh.load_obj(str(path))
    jv, jf = jmesh.load_obj(str(path))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.shape == (10, 3)
    for mode in ('sphere', 'cube'):
        np.testing.assert_array_equal(tmesh.normalize_mesh(tv, mode),
                                      jmesh.normalize_mesh(jv, mode))
    np.testing.assert_array_equal(tmesh.face_areas(tv, tf),
                                  jmesh.face_areas(jv, jf))


def _assert_same_pool(got, want, batches=3):
    np.testing.assert_array_equal(got.pool_coords, want.pool_coords)
    np.testing.assert_array_equal(got.pool_sdf, want.pool_sdf)
    np.testing.assert_array_equal(got.coords, want.coords)
    assert len(got) == len(want)
    for _ in range(batches):
        for g, w in zip(got.batch(), want.batch()):
            np.testing.assert_array_equal(g, w)


def test_analytic_and_mesh_pools_equal_jax():
    surf = 0.5 * np.random.RandomState(1).randn(300, 3).astype(np.float32)
    for kw in (dict(), dict(surface_pts=surf),
               dict(modes=('rand', 'trace'), surface_pts=surf)):
        _assert_same_pool(
            tds.from_analytic(sphere_sdf, num_samples=3000, batch_size=256,
                              seed=3, **kw),
            jds.from_analytic(sphere_sdf, num_samples=3000, batch_size=256,
                              seed=3, **kw))
    _assert_same_pool(
        tds.from_mesh((CUBE_V, CUBE_F), num_samples=2000, batch_size=128),
        jds.from_mesh((CUBE_V, CUBE_F), num_samples=2000, batch_size=128))
    with pytest.raises(ValueError):
        tds.from_analytic(sphere_sdf, num_samples=30, modes=('surface',))


def test_octree_narrowband_dataset():
    """The narrowband pool equals JAX's bit for bit (the port's octree and
    its query keep the same points); every sample lies in an occupied
    cell; ``resample`` draws working sets as JAX does."""
    level = 4
    kw = dict(level=level, samples_per_voxel=8, num_samples=512,
              batch_size=128, seed=0)
    ds = tds.from_octree_narrowband((CUBE_V, CUBE_F), **kw)
    want = jds.from_octree_narrowband((CUBE_V, CUBE_F), **kw)
    _assert_same_pool(ds, want, batches=1)
    verts = tmesh.normalize_mesh(CUBE_V)
    surf = tmesh.sample_surface(np.random.RandomState(0), verts, CUBE_F,
                                max(20000, 8 ** level))
    octree = tspc.Octree.from_pointcloud(surf, level)
    occ = octree.occupancy_mask(level).numpy()
    cells = tspc.quantize_points(torch.from_numpy(ds.pool_coords),
                                 level).numpy()
    assert occ[cells[:, 0], cells[:, 1], cells[:, 2]].all()
    assert ds.pool_size > 1000
    assert len(ds.coords) == 512 and ds.pool_size > 512
    before = ds.coords.copy()
    ds.resample()
    want.resample()
    assert not np.array_equal(before, ds.coords)
    np.testing.assert_array_equal(ds.coords, want.coords)
    cb, sb = ds.batch()
    assert cb.shape == (128, 3) and sb.shape == (128, 1)
    assert np.percentile(np.abs(ds.pool_sdf), 90) < 0.2


def test_growth_strategies():
    assert grow_loss_lods(0, 4, 10, 'onebyone') == [0]
    assert grow_loss_lods(25, 4, 10, 'onebyone') == [2]
    assert grow_loss_lods(25, 4, 10, 'increase') == [0, 1, 2]
    assert grow_loss_lods(25, 4, 10, 'shrink') == [2, 3]
    assert grow_loss_lods(25, 4, 10, 'finetocoarse') == [1, 2, 3]
    assert grow_loss_lods(25, 4, 10, 'onlylast') == [3]
    assert grow_loss_lods(999, 4, 10, 'increase') == [0, 1, 2, 3]


# --- the field -----------------------------------------------------------

@pytest.mark.parametrize('kw', [dict(), dict(pos_embedder='positional'),
                                dict(position_input=False)],
                         ids=['position', 'positional', 'grid-only'])
def test_neural_sdf_and_its_gradients_match_jax(kw):
    jcfg, tcfg = _sdf_cfgs(**kw)
    assert tcfg.pos_embed_dim == jcfg.pos_embed_dim
    assert tcfg.mlp_cfg.input_dim == jcfg.mlp_cfg.input_dim
    jparams = jsdf.neural_sdf_init(jax.random.PRNGKey(2), jcfg)
    tparams = _carried(jparams)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (257, 3)).astype(np.float32)
    gts = sphere_sdf(x)
    mask = np.asarray([1.0, 1.0, 0.0], np.float32)

    def jloss(p):
        return jnp.sum((jsdf.neural_sdf(p, jcfg, x, lod_mask=mask) - gts) ** 2)

    want = jsdf.neural_sdf(jparams, jcfg, x)
    got = tsdf.neural_sdf(tparams, tcfg, torch.as_tensor(x))
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5 * scale)
    jgrads = jax.grad(jloss)(jparams)
    tl = torch.sum((tsdf.neural_sdf(tparams, tcfg, torch.as_tensor(x),
                                    lod_mask=torch.as_tensor(mask))
                    - torch.as_tensor(gts)) ** 2)
    leaves = [t for _, t in toptim.tree_leaves_with_path(tparams)]
    tgrads = torch.autograd.grad(tl, leaves)
    for g, w in zip(tgrads, jax.tree_util.tree_leaves(jgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert tsdf.non_grid_size_bits(tparams) == jsdf.non_grid_size_bits(
        jparams)
    fd = tsdf.finitediff_gradient(tparams, tcfg, torch.as_tensor(x[:16]))
    np.testing.assert_allclose(
        fd.detach().numpy(),
        np.asarray(jsdf.finitediff_gradient(jparams, jcfg, x[:16])),
        rtol=0, atol=1e-3 * scale)


def test_neural_sdf_tex():
    kw = dict(hidden_dim=16, num_layers=1)
    jcfg = jsdf_tex.NeuralSDFTexConfig(grid=_grid(jlg), **kw)
    tcfg = tsdf_tex.NeuralSDFTexConfig(grid=_grid(tlg), **kw)
    assert tcfg.mlp_cfg.output_dim == 4
    jparams = jsdf_tex.neural_sdf_tex_init(jax.random.PRNGKey(0), jcfg)
    tparams = _carried(jparams)
    g = torch.Generator().manual_seed(0)
    own = tsdf_tex.neural_sdf_tex_init(g, tcfg, 'cpu')
    sdf, rgb = tsdf_tex.neural_sdf_tex(own, tcfg, torch.zeros((5, 3)))
    assert sdf.shape == (5, 1) and rgb.shape == (5, 3)
    assert float(rgb.min()) >= 0 and float(rgb.max()) <= 1
    x = np.random.RandomState(1).uniform(-1, 1, (64, 3)).astype(np.float32)
    for got, want in zip(
            tsdf_tex.neural_sdf_tex(tparams, tcfg, torch.as_tensor(x)),
            jsdf_tex.neural_sdf_tex(jparams, jcfg, x)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)


def test_differential_gradients_agree():
    def f(x):
        return torch.sum(x ** 2, dim=-1, keepdim=True)

    def jf(x):
        return jnp.sum(x ** 2, axis=-1, keepdims=True)

    pts = (np.random.RandomState(0).randn(5, 3) * 0.3).astype(np.float32)
    x = torch.as_tensor(pts)
    g_auto = tdiff.autodiff_gradient(f, x)
    g_fd = tdiff.finitediff_gradient(f, x)
    g_tet = tdiff.tetrahedron_gradient(f, x)
    np.testing.assert_allclose(g_fd.numpy(), g_auto.numpy(), rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(g_tet.numpy(), g_auto.numpy(), rtol=1e-2,
                               atol=1e-3)
    for got, op in ((g_auto, jdiff.autodiff_gradient),
                    (g_fd, jdiff.finitediff_gradient),
                    (g_tet, jdiff.tetrahedron_gradient)):
        np.testing.assert_allclose(got.numpy(), np.asarray(op(jf, pts)),
                                   rtol=1e-5, atol=1e-5)
    # nothing depends on the coordinates: zeros, as jax.grad gives
    zero = tdiff.autodiff_gradient(lambda c: torch.ones(c.shape[0], 1), x)
    assert zero.shape == (5, 3) and not zero.any()


def test_octree_from_mesh_and_from_spc():
    cfg = tog.OctreeGridConfig(feature_dim=2, base_lod=2, num_lods=2)
    st = tog.OctreeStructure.from_mesh(cfg, (OCTA_V, OCTA_F),
                                       num_samples_on_mesh=2000)
    want = jog.OctreeStructure.from_mesh(
        jog.OctreeGridConfig(feature_dim=2, base_lod=2, num_lods=2),
        (OCTA_V, OCTA_F), num_samples_on_mesh=2000)
    top = cfg.active_lods[-1]
    n_occ = st.octree.num_cells(top)
    assert 0 < n_occ < (2 ** top) ** 3          # sparse: surface only
    assert n_occ == want.octree.num_cells(top)
    for lod in cfg.active_lods:
        np.testing.assert_array_equal(st.codes[lod].numpy(),
                                      np.asarray(want.codes[lod]))
        np.testing.assert_array_equal(st.trinkets[lod].numpy(),
                                      np.asarray(want.trinkets[lod]))
    g = torch.Generator().manual_seed(0)
    params = tog.octree_grid_init(g, cfg, st, 'cpu')
    feats = tog.interpolate(params, cfg, st.tables(),
                            torch.tensor([[0.57, 0.57, 0.0]]))
    assert torch.isfinite(feats).all()
    oc = tspc.Octree.from_pointcloud(np.asarray([[0.0, 0.0, 0.0]]), top)
    st2 = tog.OctreeStructure.from_spc(cfg, oc)
    assert st2.num_corners[top] == 8
    with pytest.raises(ValueError):
        tog.OctreeStructure.from_spc(
            tog.OctreeGridConfig(feature_dim=2, base_lod=4, num_lods=2), oc)


# --- the trainer ---------------------------------------------------------

def _trainers(jgrid, tgrid, tcfg_kw, ds_kw, seed=0, **mkw):
    jds_ = jds.from_analytic(sphere_sdf, **ds_kw)
    tds_ = tds.from_analytic(sphere_sdf, **ds_kw)
    jm = jsdf.NeuralSDFConfig(grid=jgrid, **mkw)
    tm = tsdf.NeuralSDFConfig(grid=tgrid, **mkw)
    jtr = jst.SDFTrainer(jst.SDFTrainerConfig(**tcfg_kw), jm, jds_, seed=seed)
    ttr = tst.SDFTrainer(tst.SDFTrainerConfig(**tcfg_kw), tm, tds_,
                         seed=seed, device='cpu')
    ttr.set_params(params_from_jax(jax.tree.map(np.asarray, jtr.params)))
    return jtr, ttr


def test_trainer_chunks_with_growth_match_jax():
    """Three chunks of 5 steps, 7 steps an epoch, growth every epoch: the
    third chunk trains LODs 0 and 1 (two masks in its loss)."""
    kw = dict(epochs=6, chunk_size=5, grow_every=1,
              growth_strategy='increase', lr=5e-3, grid_lr=0.05,
              weight_decay=1e-3)
    jtr, ttr = _trainers(_grid(jlg), _grid(tlg), kw,
                         dict(num_samples=2000, batch_size=256, seed=0),
                         hidden_dim=16)
    assert len(ttr.dataset) == 7
    jlog, tlog, lods = [], [], []
    current = ttr._current_loss_lods

    def record():
        lods.append(current())
        return lods[-1]

    ttr._current_loss_lods = record
    jtr.train(num_iterations=15, log_fn=jlog.append)
    ttr.train(num_iterations=15, log_fn=tlog.append)
    assert lods == [(0,), (0,), (0, 1)]
    assert [e['iteration'] for e in tlog] == [5, 10, 15]
    np.testing.assert_allclose([e['l2_loss'] for e in tlog],
                               [e['l2_loss'] for e in jlog], rtol=1e-4)
    for (_, got), want in zip(toptim.tree_leaves_with_path(ttr.params),
                              jax.tree_util.tree_leaves(jtr.params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-4)
    assert ttr.opt_state['count'] == int(jtr.opt_state.count) == 15
    # validation draws the next batches of the same generator
    assert ttr.validate(2)['iou'] == pytest.approx(jtr.validate(2)['iou'],
                                                   abs=0.5)


def test_sdf_trainer_with_growth():
    ds = tds.from_analytic(sphere_sdf, num_samples=4000, batch_size=512,
                           seed=0)
    grid = _grid(tlg, feature_dim=2, num_lods=3, max_grid_res=16,
                 feature_std=0.01, codebook_bitwidth=6)
    tr = tst.SDFTrainer(tst.SDFTrainerConfig(epochs=6, chunk_size=10,
                                             grow_every=2,
                                             growth_strategy='increase'),
                        tsdf.NeuralSDFConfig(grid=grid, hidden_dim=16), ds,
                        seed=0, device='cpu')
    tr.train(num_iterations=40)
    assert tr.iteration == 40


def test_sdf_trainer_converges_and_iou():
    """tests/test_sdf.py's convergence run on the port, from the JAX
    trainer's initial parameters (the parity test above holds the steps
    themselves to the JAX trainer's)."""
    rng = np.random.RandomState(0)
    surf = rng.randn(1000, 3).astype(np.float32)
    surf = 0.5 * surf / np.linalg.norm(surf, axis=-1, keepdims=True)
    kw = dict(num_lods=4, max_grid_res=32, feature_std=0.01,
              codebook_bitwidth=8)
    _, trainer = _trainers(_grid(jlg, **kw), _grid(tlg, **kw),
                           dict(epochs=40, chunk_size=50),
                           dict(num_samples=20000, batch_size=2048,
                                surface_pts=surf, seed=0),
                           hidden_dim=32, num_layers=1, position_input=True)
    trainer.train(num_iterations=300)
    m = trainer.validate()
    assert m['iou'] > 90, m


# --- the demo drive ------------------------------------------------------

def test_demo_scene_and_surface_equal_the_jax_tools():
    from shacira_tpu_torch.apps import sdf_demo
    from tools.make_synthetic_data import _scene_sdf
    p = np.random.RandomState(3).uniform(-1, 1, (4000, 3)).astype(np.float32)
    np.testing.assert_array_equal(sdf_demo.scene_sdf(p), _scene_sdf(p)[0])
    cfg = sdf_demo.model_config()
    want = jlg.LatentGridConfig.from_geometric(
        feature_dim=4, num_lods=5, min_grid_res=8, max_grid_res=64,
        latent_dim=0, multiscale_type='cat', resolution_dim=3,
        feature_std=0.01, codebook_bitwidth=12, init_grid='normal')
    assert cfg.grid.resolutions == want.resolutions == (9, 14, 23, 39, 64)
    assert cfg.grid.spec.total_size == want.spec.total_size == 15761
    assert cfg.mlp_cfg.input_dim == 4 * 5 + 3
    assert sdf_demo.trainer_config() == tst.SDFTrainerConfig(
        epochs=100, chunk_size=100, lr=1e-3, grid_lr=2e-2)


def test_sdf_demo_app_runs_on_the_cpu(tmp_path):
    out = tmp_path / 'demo'
    proc = subprocess.run(
        [sys.executable, '-m', 'shacira_tpu_torch.apps.sdf_demo',
         '--device', 'cpu', '--iters', '20', '--out', str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(out / 'sdf_metrics.json') as f:
        m = json.load(f)
    assert set(m) == {'iou', 'iters', 'wall_s', 'config'}
    assert m['iters'] == 20 and 0 <= m['iou'] <= 100
    from PIL import Image
    img = np.asarray(Image.open(out / 'sdf_normals.png'))
    assert img.shape == (256, 256, 3)
