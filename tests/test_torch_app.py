"""The port's NeRF app (``apps/train_nerf.py``) end to end on a tiny
generated Blender scene (CPU), as a user drives it: train with
``--save-every``, ``--resume``, ``--valid-only`` (which reloads
``model_best.ckpt`` and never evaluates an untrained field), ``--pretrained``,
``--profile`` and ``--metrics-only``; and the offline renderer
(``render/offline.py``) against the JAX package's.
"""
import functools
import json
import logging
import os

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from shacira_tpu.render import offline as joffline  # noqa: E402
from shacira_tpu_torch.apps import train_nerf  # noqa: E402
from shacira_tpu_torch.render import offline as toffline  # noqa: E402
from shacira_tpu_torch.utils import checkpoint  # noqa: E402
from tools.make_synthetic_data import write_nerf_scene  # noqa: E402

# the tiny flags of tests/test_apps_e2e.py::test_train_nerf_app_e2e
FLAGS = ['--epochs', '4', '--chunk-size', '6', '--num-lods', '3',
         '--min-grid-res', '4', '--max-grid-res', '16',
         '--codebook-bitwidth', '8', '--feature-dim', '2',
         '--hidden-dim', '8', '--num-layers', '1', '--blas-level', '3',
         '--num-steps', '32', '--num-rays-sampled-per-img', '64',
         '--ldecode-enabled', 'True', '--entropy-reg', '1e-4',
         '--render-batch', '128', '--log-every', '-1', '--device', 'cpu',
         '--num-angles', '3']


@pytest.fixture(scope='module', autouse=True)
def _no_tensorboard():
    """The app's logger without TensorBoard: its writer imports TensorFlow
    where that is installed (~25 s)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_nerf, 'ExperimentLogger', functools.partial(
            train_nerf.ExperimentLogger, use_tensorboard=False))
        yield


def _argv(scene, log_dir, *extra):
    return ['--dataset-path', scene, '--log-dir', log_dir,
            '--exp-name', 'nerf', *FLAGS, *extra]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _main(argv):
    """Run the app; (its metrics.json, its log text)."""
    lines, logger = _Lines(), logging.getLogger('shacira_tpu_torch')
    level = logger.level
    logger.addHandler(lines)
    logger.setLevel(logging.INFO)
    try:
        assert train_nerf.main(argv) == 0
    finally:
        logger.removeHandler(lines)
        logger.setLevel(level)
    with open(os.path.join(argv[3], 'nerf', 'metrics.json')) as f:
        return json.load(f), '\n'.join(lines.lines)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('scene'))
    write_nerf_scene(path, views=6, val_views=2, res=16)
    return path


@pytest.fixture(scope='module')
def runs(scene, tmp_path_factory):
    """Train 4 epochs (a resume state every epoch), resume to 5, then
    ``--valid-only`` with the second run's flags."""
    log_dir = str(tmp_path_factory.mktemp('runs'))
    first = _argv(scene, log_dir, '--save-every', '1')
    out = {'dir': os.path.join(log_dir, 'nerf'), 'first_args': first}
    out['first'], out['first_log'] = _main(first)
    out['files'] = sorted(os.listdir(out['dir']))
    second = first + ['--resume', 'true', '--epochs', '5']
    out['second'], out['second_log'] = _main(second)
    out['valid'], out['valid_log'] = _main(second + ['--valid-only'])
    return out


def test_app_writes_metrics_and_files(runs):
    m = runs['first']
    assert m['split'] == 'val' and m['num_eval_views'] == 2
    assert np.isfinite(m['psnr']) and 0 < m['ssim'] <= 1
    assert m['total_size_kb'] > 0 and m['stream'] in ('histogram',
                                                      'prob_model')
    for k in ('ldec_size_kb', 'latent_size_kb', 'remainder_size_kb',
              'latent_size_kb_hist', 'latent_size_kb_pm'):
        assert m[k] > 0, k
    for f in ('metrics.json', 'val_view0.png', 'turntable.gif',
              'model_best.ckpt', 'resume_state.ckpt'):
        assert f in runs['files'], f
    from PIL import Image
    with Image.open(os.path.join(runs['dir'], 'turntable.gif')) as gif:
        assert gif.n_frames == 3 and gif.size == (16, 16)
    with Image.open(os.path.join(runs['dir'], 'val_view0.png')) as png:
        assert png.size == (16, 16)


def test_resume_continues_from_the_saved_iteration(runs):
    assert 'Resumed at iteration 24' in runs['second_log']
    assert 'iteration 30 |' in runs['second_log']
    assert 'iteration 6 |' not in runs['second_log']
    state = checkpoint.load_state(os.path.join(runs['dir'],
                                               'resume_state.ckpt'))
    assert state['iteration'] == 30 and state['opt_state']['count'] == 30


def test_valid_only_reloads_and_reproduces_the_psnr(runs):
    assert 'valid-only: loaded model_best.ckpt' in runs['valid_log']
    assert 'Resumed at iteration 30' in runs['valid_log']
    assert '| loss' not in runs['valid_log']                # no training
    assert runs['valid']['psnr'] == runs['second']['psnr']
    assert runs['valid']['ssim'] == runs['second']['ssim']
    assert runs['valid']['total_size_kb'] == runs['second']['total_size_kb']
    assert runs['second']['psnr'] != runs['first']['psnr']


def test_pretrained_loads_the_model(runs, tmp_path):
    """``--pretrained`` with ``--valid-only`` in a new log dir: the model
    the second run saved (no prune ran, so a fresh occupancy is the
    trained one) reproduces its PSNR."""
    best = os.path.join(runs['dir'], 'model_best.ckpt')
    m, text = _main(_argv(runs['first_args'][1], str(tmp_path),
                          '--pretrained', best, '--valid-only',
                          '--metrics-only'))
    assert 'Loaded pretrained model' in text
    assert m['psnr'] == runs['second']['psnr']
    state = checkpoint.load_model(best)
    assert state['format'] == 'full' and 'model' in state['configs']


def test_valid_only_without_a_checkpoint_raises(scene, tmp_path):
    with pytest.raises(FileNotFoundError, match='model_best.ckpt'):
        train_nerf.main(_argv(scene, str(tmp_path), '--valid-only'))
    assert not os.path.exists(os.path.join(str(tmp_path), 'nerf',
                                           'metrics.json'))


def test_profile_writes_a_trace_and_metrics_only_skips_images(
        scene, tmp_path):
    m, _ = _main(_argv(scene, str(tmp_path), '--profile', '--metrics-only',
                       '--epochs', '1'))
    exp = os.path.join(str(tmp_path), 'nerf')
    with open(os.path.join(exp, 'profile', 'trace.json')) as f:
        trace = json.load(f)
    names = {e.get('name') for e in trace['traceEvents']}
    assert 'step/decode' in names and 'step/adam' in names
    assert np.isfinite(m['psnr'])
    files = os.listdir(exp)
    assert 'val_view0.png' not in files and 'turntable.gif' not in files


@pytest.mark.parametrize('origin,res', [((-3.0, 0.65, -3.0), (16, 16)),
                                        ((1.5, 2.0, 0.3), (9, 13)),
                                        ((0.0, -1.0, 4.0), (24, 8))])
def test_lookat_rays_match_jax(origin, res):
    cfg_t = toffline.CameraConfig(width=res[0], height=res[1], fov=40.0)
    cfg_j = joffline.CameraConfig(width=res[0], height=res[1], fov=40.0)
    for got, want in zip(toffline.lookat_rays(origin, (0.1, 0.0, -0.2), cfg_t),
                         joffline.lookat_rays(origin, (0.1, 0.0, -0.2), cfg_j)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_turntable_matches_jax():
    """A deterministic trace_fn (no jitter) in both packages: the frames,
    with tail padding (70 rays in batches of 16), agree."""
    def jtrace(rays, key):
        rgb = jax.nn.sigmoid(rays.origins * 0.3 + rays.dirs * 2.0)
        return {'rgb': rgb * (rays.dist_max - rays.dist_min)[:, None] / 6.0}

    def ttrace(rays, generator):
        assert isinstance(generator, torch.Generator)
        rgb = torch.sigmoid(rays.origins * 0.3 + rays.dirs * 2.0)
        return {'rgb': rgb * (rays.dist_max - rays.dist_min)[:, None] / 6.0}

    kw = dict(width=10, height=7, fov=35.0, dist_min=0.5, dist_max=5.0)
    ro, rd = toffline.lookat_rays((2.0, 0.5, 1.0), (0, 0, 0),
                                  toffline.CameraConfig(**kw))
    got = toffline.render_rays(ttrace, ro, rd, toffline.CameraConfig(**kw),
                               batch=16, device='cpu')['rgb']
    want = joffline.render_rays(jtrace, ro, rd, joffline.CameraConfig(**kw),
                                batch=16)['rgb']
    assert got.shape == (70, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    got = list(toffline.turntable(ttrace, toffline.CameraConfig(**kw),
                                  num_angles=4, radius=2.5, elevation=0.4,
                                  device='cpu'))
    want = list(joffline.turntable(jtrace, joffline.CameraConfig(**kw),
                                   num_angles=4, radius=2.5, elevation=0.4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (7, 10, 3)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)


def test_overlay_layers_raise(scene):
    """``--overlay-layers true`` draws the wireframe of the occupied cells
    and the axes gizmo over each turntable frame (the rasterizer equals the
    JAX package's: tests/test_torch_overlay.py); a layer that is no
    PrimitivesPack raises."""
    from shacira_tpu_torch import config as cfg_mod
    from shacira_tpu_torch.datasets.nerf_synthetic import load_nerf_synthetic
    args = cfg_mod.parse_args(cfg_mod.build_nerf_parser(),
                              _argv(scene, 'unused'))
    trainer = train_nerf.build_trainer(
        args, load_nerf_synthetic(scene, split='train'))
    plain = train_nerf.render_turntable(trainer, args, num_angles=2)
    args.overlay_layers = True
    drawn = train_nerf.render_turntable(trainer, args, num_angles=2)
    for p, d in zip(plain, drawn):
        assert p.shape == d.shape == (16, 16, 3)
        changed = np.any(p != d, axis=-1)
        assert changed.any() and not changed.all()
    with pytest.raises(AttributeError):
        next(toffline.turntable(
            lambda r, g: {'rgb': torch.ones_like(r.origins)},
            toffline.CameraConfig(width=4, height=4),
            layers={'axes': None}, device='cpu'))


def test_save_png_and_gif(tmp_path):
    from PIL import Image
    img = np.linspace(-0.2, 1.2, 5 * 4 * 3, dtype=np.float32).reshape(5, 4, 3)
    toffline.save_png(str(tmp_path / 'a.png'), img)
    with Image.open(str(tmp_path / 'a.png')) as png:
        got = np.asarray(png)
    np.testing.assert_array_equal(
        got, np.clip(img * 255.0, 0, 255).astype(np.uint8))
    toffline.save_gif([img, 1 - img], str(tmp_path / 'a.gif'))
    with Image.open(str(tmp_path / 'a.gif')) as gif:
        assert gif.n_frames == 2
