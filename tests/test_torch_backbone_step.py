"""Port parity for the multiview trainer and the NeRF app on the alternative
grid backbones (NGLOD's octree grid, VQAD's codebook octree grid, the
triplanar grid on the 'voxel' march, the uncompressed HashGrid), against
shacira_tpu.trainers.multiview_trainer.

Tolerances as tests/test_torch_step.py: the loss within 1e-5 relative, Adam
first moments 2e-3 relative / 1e-4 of each leaf's largest entry, the
updated params 1e-5 absolute; the pruned density 1e-5 relative and the
occupancy equal; a rendered view 1e-5; the size report's bits equal.  The
JAX step's march jitter and prune jitter are handed to the port."""
import functools
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.grids import octree_grid as jog  # noqa: E402
from shacira_tpu.models.grids import triplanar_grid as jtg  # noqa: E402
from shacira_tpu.models.nefs import nerf as jnerf  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu.utils import checkpoint as jckpt  # noqa: E402
from shacira_tpu_torch.apps import train_nerf  # noqa: E402
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.grids import octree_grid as og  # noqa: E402
from shacira_tpu_torch.models.grids import triplanar_grid as tg  # noqa: E402
from shacira_tpu_torch.models.nefs import nerf as tnerf  # noqa: E402
from shacira_tpu_torch.ops import spc  # noqa: E402
from shacira_tpu_torch import optim as toptim  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from shacira_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)
from tools.make_synthetic_data import write_nerf_scene  # noqa: E402

from tests.test_torch_step import _leaves, _scene, _tleaves  # noqa: E402


@pytest.fixture(scope='module', autouse=True)
def _no_tensorboard():
    """The app's logger without TensorBoard: its writer imports TensorFlow
    where that is installed (~25 s)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_nerf, 'ExperimentLogger', functools.partial(
            train_nerf.ExperimentLogger, use_tensorboard=False))
        yield

OCTREE = dict(feature_dim=2, base_lod=2, num_lods=2, feature_std=0.2,
              feature_bias=0.1)
GRIDS = {
    'octree': (jog.OctreeGridConfig(**OCTREE), og.OctreeGridConfig(**OCTREE)),
    'codebook': (
        jog.CodebookOctreeGridConfig(codebook_bitwidth=3,
                                     **dict(OCTREE, feature_std=0.5)),
        og.CodebookOctreeGridConfig(codebook_bitwidth=3,
                                    **dict(OCTREE, feature_std=0.5))),
    'triplanar': (jtg.TriplanarGridConfig(multiscale_type='cat', **OCTREE),
                  tg.TriplanarGridConfig(multiscale_type='cat', **OCTREE)),
    'hash': tuple(m.LatentGridConfig.from_geometric(
        feature_dim=2, num_lods=3, min_grid_res=4, max_grid_res=24,
        latent_dim=0, multiscale_type='cat', feature_std=0.2,
        codebook_bitwidth=9) for m in (jlg, tlg)),
}
# the triplanar YAML marches 'voxel'; max_samples takes the compaction
TRACES = {'triplanar': dict(raymarch_type='voxel', num_steps=4,
                            max_intersections=12, max_samples=2048)}
NERF = dict(hidden_dim=16, view_embedder='positional', blas_level=3,
            prune_min_density=1.0)
TRAIN = dict(epochs=20, prune_every=-1, lr=5e-3, grid_lr=0.02)
RAYS = 64
KINDS = list(GRIDS)


def _pair(kind, num_views=4):
    jdata, tdata = _scene(num_views=num_views, res=16)
    jg, tgc = GRIDS[kind]
    trace = TRACES.get(kind, dict(num_steps=32))
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN),
        jnerf.NeuralRadianceFieldConfig(grid=jg, **NERF),
        jrt.RFTracerConfig(**trace), jdata, num_rays=RAYS, seed=0)
    ttr = tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**TRAIN),
        tnerf.NeuralRadianceFieldConfig(grid=tgc, **NERF),
        trt.RFTracerConfig(**trace), tdata, num_rays=RAYS, seed=0,
        device='cpu')
    ttr.set_params(params_from_jax(jax.tree.map(np.asarray, jtr.params)),
                   adam_state_from_jax(jtr.opt_state.mu, jtr.opt_state.nu,
                                       jtr.opt_state.count))
    return jtr, ttr, jdata


@pytest.fixture(scope='module', params=KINDS)
def pair(request):
    return (request.param,) + _pair(request.param)


def test_trainer_builds_the_jax_structure_and_labels(pair):
    kind, jtr, ttr, _ = pair
    assert ttr.grid_kind == jtr.grid_kind == ('latent' if kind == 'hash'
                                              else kind)
    if kind in ('octree', 'codebook'):
        for key in ('codes', 'trinkets'):
            for got, want in zip(ttr.structure_tables[key],
                                 jtr.structure_tables[key]):
                np.testing.assert_array_equal(got.numpy(), np.asarray(
                    want).astype(got.numpy().dtype))
    else:
        assert ttr.structure_tables is None is jtr.structure_tables
    # every grid leaf is in the 'grid' group, as the JAX labels have it
    jlabels = dict(zip(
        [tuple(str(getattr(k, 'key', getattr(k, 'idx', k))) for k in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(jtr.params)[0]],
        jax.tree_util.tree_leaves(jtr.labels)))
    assert ttr.labels == jlabels
    assert {v for p, v in ttr.labels.items() if p[0] == 'grid'} == {'grid'}
    assert not ttr.entropy_enabled and not ttr.ldecode_enabled


def test_one_step_matches_the_jax_step(pair):
    kind, jtr, ttr, _ = pair
    jstep = jax.jit(jtr._raw_step(use_sga=False))
    lod_mask = jnp.ones((jtr.model_cfg.grid.num_lods,), jnp.float32)
    shape = jrt.march_jitter_shape(jtr.tracer_cfg, RAYS)
    assert shape == trt.march_jitter_shape(ttr.tracer_cfg, RAYS)
    ro, rd, gt = jtr._presample(1)
    key = jax.random.PRNGKey(11)
    p, o, _, metrics = jstep(
        jtr.params, jtr.opt_state, jtr.noise, jtr.occ_state,
        jtr.structure_tables, jnp.asarray(ro[0]), jnp.asarray(rd[0]),
        jnp.asarray(gt[0]), key, jnp.float32(0.0), jnp.float32(1.0),
        jnp.float32(1e-3), jnp.asarray(True), lod_mask)
    _, _, k_march = jax.random.split(key, 3)
    draws = tmt.StepDraws(march_u=torch.as_tensor(np.array(
        jax.random.uniform(k_march, shape))))
    tmet = ttr.step(torch.as_tensor(ro[0]), torch.as_tensor(rd[0]),
                    torch.as_tensor(gt[0]), draws, ent_lambda=0.0,
                    temperature=1.0, lr_ldec=1e-3, use_sga=False)
    np.testing.assert_allclose(float(tmet['loss']), float(metrics['loss']),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet['psnr']), float(metrics['psnr']),
                               rtol=1e-5)
    for got, want in zip(_tleaves(ttr.opt_state['mu']), _leaves(o.mu)):
        np.testing.assert_allclose(got, want, rtol=2e-3,
                                   atol=1e-4 * np.abs(want).max())
    for got, want in zip(_tleaves(ttr.params), _leaves(p)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    grid_moved = [np.abs(g - w).max() for g, w in zip(
        _tleaves(ttr.params['grid']), _leaves(jtr.params['grid']))]
    assert max(grid_moved) > 0
    # the JAX step donates nothing here: put its result back for the tests
    # below, which start from the same params on both sides
    ttr.set_params(params_from_jax(jax.tree.map(np.asarray, jtr.params)))


def test_prune_matches_jax(pair):
    kind, jtr, ttr, _ = pair
    k = jax.random.PRNGKey(4)
    ocfg = jtr.model_cfg.occ_cfg
    want = jtr._get_prune_fn()(jtr.params, jtr.occ_state, k,
                               jtr.structure_tables)
    u = torch.as_tensor(np.array(jax.random.uniform(k, (ocfg.num_cells, 3))))
    ttr.prune(u)
    got = ttr.occ_state
    np.testing.assert_allclose(got['density'].numpy(),
                               np.asarray(want['density']), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got['occ'].numpy(),
                                  np.asarray(want['occ']))
    frac = float(got['occ'].float().mean())
    assert 0.0 < frac < 1.0, frac


def test_evaluate_renders_the_jax_view(pair):
    kind, jtr, ttr, jdata = pair
    jtr.occ_state = dict(jtr.occ_state, **{
        k: jnp.asarray(ttr.occ_state[k].numpy()) for k in ('occ', 'density')})
    npix = jdata.rgb.shape[1]
    got = ttr.render_view(1, ray_batch=npix)
    g = torch.Generator()
    g.manual_seed(0)
    u = torch.rand(trt.march_jitter_shape(ttr.tracer_cfg, npix),
                   generator=g).numpy()
    jm, jt = jtr.model_cfg, jtr.tracer_cfg
    if kind == 'hash':
        decoded = jlg.decode_codebook(jtr.params['grid'], jm.grid)
        kw = dict(decoded=decoded)
    else:
        kw = dict(structure=jtr.structure_tables, training=False)

    def field_fn(coords, dirs):
        return jnerf.nerf_rgba(jtr.params, jm, coords, dirs, **kw)

    want = jax.jit(lambda u_: jrt.trace(
        field_fn, jtr.occ_state, jm.occ_cfg, jt,
        jmake_rays(jdata.rays_o[1], jdata.rays_d[1], jdata.dist_min,
                   jdata.dist_max), u_)['rgb'])(jnp.asarray(u))
    np.testing.assert_allclose(got.reshape(-1, 3), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    m = ttr.evaluate([1])
    assert np.isfinite(m['psnr']) and np.isfinite(m['ssim'])


@pytest.mark.parametrize('use_codec', [False, True])
def test_size_report_equals_jax(pair, use_codec):
    kind, jtr, ttr, _ = pair
    got = ttr.size_report(use_codec=use_codec)
    want = jtr.size_report(use_codec=use_codec)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    if kind != 'hash':
        assert set(got) == {'grid_size_kb', 'remainder_size_kb',
                            'total_size_kb'}


def test_backbones_refuse_lod_curricula_as_jax():
    jdata, tdata = _scene(num_views=2, res=8)
    for kw in (dict(random_lod=True), dict(grow_every=2)):
        with pytest.raises(ValueError, match='LatentGrid-only'):
            tmt.MultiviewTrainer(
                tmt.MultiviewTrainerConfig(**TRAIN, **kw),
                tnerf.NeuralRadianceFieldConfig(grid=GRIDS['octree'][1],
                                                **NERF),
                trt.RFTracerConfig(num_steps=8), tdata, num_rays=8,
                device='cpu')


def test_octree_trainer_takes_the_point_cloud(monkeypatch):
    """On depth-captured data the octree comes from the point cloud
    (dilated by 2 cells), as the JAX trainer builds it."""
    jdata, tdata = _scene(num_views=2, res=8)
    pts = (np.random.RandomState(0).randn(30, 3) * 0.2).astype(np.float32)
    tdata.pointcloud = pts
    ttr = tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**TRAIN),
        tnerf.NeuralRadianceFieldConfig(grid=GRIDS['octree'][1], **NERF),
        trt.RFTracerConfig(num_steps=8), tdata, num_rays=8, device='cpu')
    want = jog.OctreeStructure.from_pointcloud(GRIDS['octree'][0], pts)
    assert ttr.structure.num_corners == want.num_corners
    for got, w in zip(ttr.structure_tables['trinkets'],
                      want.tables()['trinkets']):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_trainer_takes_a_given_structure():
    """A caller's structure (here an octree deeper than the grid's LODs,
    through ``from_spc``) replaces the dense one."""
    _, tdata = _scene(num_views=2, res=8)
    cfg = GRIDS['octree'][1]
    octree = spc.Octree.from_quantized_points(
        torch.as_tensor([[0, 0, 0], [5, 6, 7], [15, 15, 15]]), 4)
    st = og.OctreeStructure.from_spc(cfg, octree)
    ttr = tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**TRAIN),
        tnerf.NeuralRadianceFieldConfig(grid=cfg, **NERF),
        trt.RFTracerConfig(num_steps=8), tdata, num_rays=8, device='cpu',
        structure=st)
    assert ttr.structure is st
    assert [t.shape[0] for t in ttr.params['grid']['features']] == [
        st.num_corners[l] for l in cfg.active_lods]
    assert np.isfinite(float(ttr.train(num_iterations=2)['iterations']))


# ---------------------------------------------------------------------------
# the app on one backbone
# ---------------------------------------------------------------------------

FLAGS = ['--epochs', '3', '--chunk-size', '6', '--grid-type', 'OctreeGrid',
         '--base-lod', '2', '--num-lods', '2', '--feature-dim', '2',
         '--feature-std', '0.05', '--hidden-dim', '8', '--num-layers', '1',
         '--blas-level', '3', '--num-steps', '32',
         '--num-rays-sampled-per-img', '64', '--prune-every', '6',
         '--prune-min-density', '0.5', '--log-every', '-1',
         '--device', 'cpu', '--num-angles', '2']


@pytest.fixture(scope='module')
def app_runs(tmp_path_factory):
    scene = str(tmp_path_factory.mktemp('scene'))
    write_nerf_scene(scene, views=6, val_views=2, res=16)
    log_dir = str(tmp_path_factory.mktemp('runs'))
    argv = ['--dataset-path', scene, '--log-dir', log_dir, '--exp-name',
            'octree', *FLAGS]
    out = {'dir': os.path.join(log_dir, 'octree'), 'argv': argv}
    for name, extra in (('train', ['--save-every', '1']),
                        ('resume', ['--resume', 'true', '--epochs', '4']),
                        ('valid', ['--resume', 'true', '--epochs', '4',
                                   '--valid-only'])):
        assert train_nerf.main(argv + extra) == 0
        with open(os.path.join(out['dir'], 'metrics.json')) as f:
            out[name] = json.load(f)
        if name == 'resume':
            out['resume_state'] = tckpt.load_state(
                os.path.join(out['dir'], 'resume_state.ckpt'))
    return out


def test_app_trains_saves_resumes_and_reloads_an_octree(app_runs):
    files = os.listdir(app_runs['dir'])
    for f in ('metrics.json', 'model_best.ckpt', 'resume_state.ckpt',
              'val_view0.png', 'turntable.gif'):
        assert f in files
    for name in ('train', 'resume', 'valid'):
        m = app_runs[name]
        assert np.isfinite(m['psnr']) and m['total_size_kb'] > 0
        assert set(m) >= {'grid_size_kb', 'remainder_size_kb'}
    assert app_runs['resume_state']['iteration'] == 4 * 6
    feats = app_runs['resume_state']['params']['grid']['features']
    assert isinstance(feats, list) and len(feats) == 2
    # --valid-only reloads model_best.ckpt and reproduces the PSNR
    assert app_runs['valid']['psnr'] == pytest.approx(
        app_runs['resume']['psnr'], abs=1e-4)


@pytest.mark.parametrize('kind', ['codebook', 'triplanar'])
def test_jax_checkpoints_of_backbones_load_into_the_port(kind, tmp_path):
    """A JAX model file and resume state of a list- or dict-shaped grid
    tree restore into a port trainer, leaf for leaf."""
    jtr, ttr, _ = _pair(kind, num_views=2)
    model = str(tmp_path / 'model.ckpt')
    jckpt.save_model(model, jtr.params, model_format='state_dict')
    state = tckpt.load_model(model)
    tckpt.check_like(state['params'], ttr.params, model)
    resume = str(tmp_path / 'resume.ckpt')
    jckpt.save_trainer(jtr, resume)
    ttr.set_params(params_from_jax(jax.tree.map(
        lambda x: np.zeros_like(np.asarray(x)), jtr.params)))
    tckpt.restore_trainer(ttr, resume)
    for got, want in zip(_tleaves(ttr.params), _leaves(jtr.params)):
        np.testing.assert_array_equal(got, want)
    paths = [p for p, _ in toptim.tree_leaves_with_path(ttr.params)]
    if kind == 'triplanar':
        assert ('grid', 'planes', '1', 'xy') in paths
    else:
        assert ('grid', 'dictionary', '1') in paths
    # and a port resume state of the same tree round-trips
    path = str(tmp_path / 'port.ckpt')
    tckpt.save_trainer(ttr, path)
    tckpt.restore_trainer(ttr, path)
    for got, want in zip(_tleaves(ttr.params), _leaves(jtr.params)):
        np.testing.assert_array_equal(got, want)
