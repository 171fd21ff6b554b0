"""Port parity for RTMV data: the port's EXR codec (``ops/exr.py``) and
RTMV loader (``datasets/rtmv.py``) against shacira_tpu's, the occupancy
the trainer seeds from the depth point cloud, ``chip_smoke.py``'s RTMV
writer against ``tools/make_synthetic_data.write_rtmv_scene``, and the
NeRF app end to end on a tiny RTMV scene with the 'voxel' march.

Tolerances: EXR planes, loaded arrays, bounds, point clouds and the seeded
occupancy exactly (the same numpy code on the same files); the scenes the
two writers produce byte for byte.
"""
import filecmp
import functools
import json
import logging
import os

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from shacira_tpu.datasets.rtmv import load_rtmv as jload  # noqa: E402
from shacira_tpu.ops import exr as jexr  # noqa: E402
from shacira_tpu_torch.apps import train_nerf  # noqa: E402
from shacira_tpu_torch.datasets.rtmv import load_rtmv as tload  # noqa: E402
from shacira_tpu_torch.ops import exr as texr  # noqa: E402
from tools.make_synthetic_data import write_rtmv_scene  # noqa: E402

import chip_smoke  # noqa: E402


@pytest.fixture(scope='module', autouse=True)
def _no_tensorboard():
    """The app's logger without TensorBoard: its writer imports TensorFlow
    where that is installed (~25 s)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_nerf, 'ExperimentLogger', functools.partial(
            train_nerf.ExperimentLogger, use_tensorboard=False))
        yield

from tests.test_torch_step import GRID, LDEC, NERF, TRAIN  # noqa: E402


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('rtmv'))
    write_rtmv_scene(path, views=12, res=32)
    return path


def _planes(seed):
    rng = np.random.default_rng(seed)
    return {'R': rng.random((5, 7)).astype(np.float32),
            'G': rng.random((5, 7)).astype(np.float32),
            'B': rng.random((5, 7)).astype(np.float32),
            'A': (rng.random((5, 7)) > 0.5).astype(np.float32),
            'Z': (rng.random((5, 7)) * 9).astype(np.float32)}


@pytest.mark.parametrize('writer,reader', [(texr, texr), (texr, jexr),
                                           (jexr, texr)])
def test_exr_round_trip_across_packages(tmp_path, writer, reader):
    chans = _planes(0)
    path = str(tmp_path / 't.exr')
    writer.write_exr(path, chans)
    back = reader.read_exr(path)
    assert set(back) == set(chans)
    for k in chans:
        np.testing.assert_array_equal(back[k], chans[k])
    rgba = reader.read_exr_rgba(path)
    assert rgba.shape == (5, 7, 5)
    np.testing.assert_array_equal(rgba[..., 3], chans['A'])
    np.testing.assert_array_equal(rgba[..., 4], chans['Z'])   # depth last


def test_exr_files_are_byte_identical_and_bad_files_raise(tmp_path):
    chans = _planes(1)
    texr.write_exr(str(tmp_path / 'a.exr'), chans)
    jexr.write_exr(str(tmp_path / 'b.exr'), chans)
    assert filecmp.cmp(tmp_path / 'a.exr', tmp_path / 'b.exr', shallow=False)
    (tmp_path / 'x.exr').write_bytes(b'not an exr file at all')
    with pytest.raises(ValueError):
        texr.read_exr(str(tmp_path / 'x.exr'))
    # a depth plane without alpha: alpha is inserted at slot 3
    texr.write_exr(str(tmp_path / 'z.exr'), {k: chans[k] for k in 'RGBZ'})
    rgba = texr.read_exr_rgba(str(tmp_path / 'z.exr'))
    np.testing.assert_array_equal(rgba[..., 3], 1.0)
    np.testing.assert_array_equal(rgba[..., 4], chans['Z'])


@pytest.mark.parametrize('split,mip', [('train', 0), ('val', 0),
                                       ('test', 0), ('train', 1)])
def test_load_rtmv_matches_jax(scene, split, mip):
    want = jload(scene, split=split, mip=mip)
    got = tload(scene, split=split, mip=mip)
    assert (got.h, got.w) == (want.h, want.w) == (32 >> mip, 32 >> mip)
    for k in ('rgb', 'rays_o', 'rays_d', 'masks', 'pointcloud',
              'norm_center'):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    for k in ('dist_min', 'dist_max', 'norm_scale'):
        assert getattr(got, k) == getattr(want, k), k
    assert got.num_views == {'train': 8, 'val': 1, 'test': 3}[split]
    assert np.abs(got.pointcloud).max() <= 0.9 + 1e-6


def test_rtmv_splits_share_one_frame(scene):
    """Surface points of a val view's depths, through the val split's rays,
    lie on the train split's point cloud (one normalization frame)."""
    train, val = tload(scene, split='train'), tload(scene, split='val')
    np.testing.assert_array_equal(val.norm_center, train.norm_center)
    assert val.norm_scale == train.norm_scale
    files = sorted(f for f in os.listdir(scene) if f.endswith('.exr'))
    img = texr.read_exr_rgba(os.path.join(scene, files[int(len(files) * .7)]))
    hit = (img[..., 3] > 0.5).reshape(-1) & (img[..., 4].reshape(-1) > 0)
    t = img[..., 4].reshape(-1)[hit] / val.norm_scale
    pts = val.rays_o[0][hit] + val.rays_d[0][hit] * t[:, None]
    d = np.sqrt(((pts[:, None, :] - train.pointcloud[None, :, :]) ** 2
                 ).sum(-1)).min(1)
    assert hit.sum() > 20 and np.median(d) < 0.05, float(np.median(d))


def test_trainer_seeds_occupancy_from_the_point_cloud(scene):
    """A voxel trainer on RTMV data starts from the dilated cells of the
    depth point cloud, as the JAX trainer does, and trains from there."""
    from shacira_tpu.models.grids import latent_grid as jlg
    from shacira_tpu.models.nefs import nerf as jnerf
    from shacira_tpu.tracers import rf_tracer as jrt
    from shacira_tpu.trainers import multiview_trainer as jmt
    from shacira_tpu_torch.models.grids import latent_grid as tlg
    from shacira_tpu_torch.models.nefs import nerf as tnerf
    from shacira_tpu_torch.tracers import rf_tracer as trt
    from shacira_tpu_torch.trainers import multiview_trainer as tmt
    nerf = dict(NERF, blas_level=5)
    trace = dict(raymarch_type='voxel', num_steps=4, max_intersections=16)
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN),
        jnerf.NeuralRadianceFieldConfig(
            grid=jlg.LatentGridConfig.from_geometric(**GRID).with_ldec(LDEC),
            **nerf), jrt.RFTracerConfig(**trace),
        jload(scene, split='train'), num_rays=32, seed=0)
    ttr = tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**TRAIN), tnerf.NeuralRadianceFieldConfig(
            grid=tlg.LatentGridConfig.from_geometric(**GRID).with_ldec(LDEC),
            **nerf), trt.RFTracerConfig(**trace),
        tload(scene, split='train'), num_rays=32, seed=0, device='cpu')
    np.testing.assert_array_equal(ttr.occ_state['occ'].numpy(),
                                  np.asarray(jtr.occ_state['occ']))
    frac = float(ttr.occ_state['occ'].float().mean())
    assert 0.0 < frac < 0.5
    log = []
    ttr.train(num_iterations=4, log_fn=log.append)
    assert np.isfinite(log[-1]['loss'])


@pytest.mark.parametrize('workers', [1, 2])
def test_chip_smoke_writer_equals_the_tools_writer(scene, tmp_path, workers):
    out = str(tmp_path / 'port')
    chip_smoke.write_rtmv_scene(out, views=12, res=32, workers=workers)
    names = sorted(os.listdir(scene))
    assert names == sorted(os.listdir(out)) and len(names) == 24
    match, mismatch, errors = filecmp.cmpfiles(scene, out, names,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == 24


# tiny V8-shaped flags: the voxel march, RTMV data, latent_dim 2
FLAGS = ['--multiview-dataset-format', 'rtmv', '--raymarch-type', 'voxel',
         '--num-steps', '4', '--max-intersections', '16', '--epochs', '2',
         '--chunk-size', '4', '--num-lods', '3', '--min-grid-res', '4',
         '--max-grid-res', '16', '--codebook-bitwidth', '8',
         '--feature-dim', '2', '--latent-dim', '2', '--hidden-dim', '8',
         '--blas-level', '4', '--num-rays-sampled-per-img', '64',
         '--prune-every', '10', '--ldecode-enabled', 'True',
         '--entropy-reg', '1e-4', '--log-every', '-1', '--device', 'cpu',
         '--num-angles', '2', '--save-every', '1']


def _main(argv, log_dir):
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger('shacira_tpu_torch')
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        assert train_nerf.main(argv) == 0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    with open(os.path.join(log_dir, 'rtmv', 'metrics.json')) as f:
        return json.load(f), lines


def test_app_trains_rtmv_with_the_voxel_march(scene, tmp_path):
    """The app on RTMV data: training across a prune, ``metrics.json`` with
    PSNR, SSIM and the size report, the saved view and the turntable; then
    ``--valid-only`` (with ``--resume``, for the trained occupancy)
    reproduces the PSNR."""
    log_dir = str(tmp_path / 'runs')
    argv = ['--dataset-path', scene, '--log-dir', log_dir, '--exp-name',
            'rtmv', *FLAGS]
    trained, lines = _main(argv, log_dir)
    assert any(ln.startswith('Loaded 8 train views of 32x32') for ln in lines)
    assert any(ln.startswith('iteration 16 ') for ln in lines)
    assert trained['split'] == 'val' and trained['num_eval_views'] == 1
    assert np.isfinite(trained['psnr']) and 0 < trained['ssim'] <= 1
    assert trained['total_size_kb'] > 0
    files = os.listdir(os.path.join(log_dir, 'rtmv'))
    for f in ('metrics.json', 'model_best.ckpt', 'resume_state.ckpt',
              'val_view0.png', 'turntable.gif'):
        assert f in files, f
    again, lines = _main(argv + ['--resume', 'true', '--valid-only'],
                         log_dir)
    assert 'valid-only: loaded model_best.ckpt' in lines
    assert not any(ln.startswith('iteration ') for ln in lines)
    assert abs(again['psnr'] - trained['psnr']) <= 1e-4


def test_config_reads_nerf_v8_like_the_jax_package():
    """configs/nerf_V8.yaml as it is, and with chip_smoke.py's
    ``VOXEL_FLAGS`` (bench_nerf.measure_voxel's setting): the same grid,
    tracer and trainer configs as the JAX package's."""
    from dataclasses import fields

    from shacira_tpu import config as jconfig
    from shacira_tpu_torch import config as tconfig
    v8 = ['--config', os.path.join(chip_smoke.ROOT, 'configs', 'nerf_V8.yaml')]
    for argv in (v8, v8 + chip_smoke.VOXEL_FLAGS):
        jargs = jconfig.parse_args(
            jconfig.add_nerf_args(jconfig.build_image_parser()), argv)
        targs = tconfig.parse_args(tconfig.build_nerf_parser(), argv)
        jm = jconfig.build_nerf_model_config(jargs)
        tm = tconfig.build_nerf_model_config(targs)
        assert tm.grid.spec.total_size == jm.grid.spec.total_size \
            == 1_966_521
        assert (tm.grid.latent_dim, tm.grid.num_lods, tm.blas_level) \
            == (2, 20, 7)
        for build in ('build_tracer_config', 'build_nerf_trainer_config'):
            got = getattr(tconfig, build)(targs)
            want = getattr(jconfig, build)(jargs)
            for f in fields(got):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert targs.multiview_dataset_format == 'rtmv'
    tt = tconfig.build_tracer_config(targs)
    assert (tt.raymarch_type, tt.num_steps, tt.max_samples,
            tt.eval_seg_budget, tt.term_tau) == ('voxel', 16, 262144, 16384,
                                                 11.5)
    assert tm.grid.hash_layout == 'paged' and tm.amp
