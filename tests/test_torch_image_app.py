"""The port's image app (``apps/train_image.py``) end to end on two tiny
generated PNGs (CPU), as a user drives it: per-image directories, the
aggregate ``metrics.json`` and ``complete``, resume at the image index,
``--valid-only`` reproducing the PSNR (within the JAX app test's 0.75 dB),
``--pretrained`` and ``--profile``; the image trainer's checkpoints (its own
round trip, and a JAX image trainer's ``resume_state.ckpt`` and
``model_best.ckpt`` loaded without importing the JAX package); and the
multiview trainer's grid lr on a multi-decoder grid (C3)."""
import functools
import json
import logging
import os

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from shacira_tpu.datasets import image as jimage  # noqa: E402
from shacira_tpu.trainers import image_trainer as jit_  # noqa: E402
from shacira_tpu.utils import checkpoint as jckpt  # noqa: E402
from shacira_tpu_torch import optim as toptim  # noqa: E402
from shacira_tpu_torch.apps import train_image  # noqa: E402
from shacira_tpu_torch.datasets import image as timage  # noqa: E402
from shacira_tpu_torch.trainers import image_trainer as tit  # noqa: E402
from shacira_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from tests.test_torch_image_step import _cfgs, image8  # noqa: E402

# kodak's config at a tiny width: 4 LODs, a 2^6 table, hidden 8
FLAGS = ['--config', 'configs/kodak.yaml', '--device', 'cpu',
         '--num-lods', '4', '--codebook-bitwidth', '6', '--hidden-dim', '8',
         '--epochs', '40', '--log-every', '10', '--save-every', '20']


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    # where TensorFlow is installed, TensorBoard's writer imports it (~20 s)
    monkeypatch.setattr(train_image, 'ExperimentLogger', functools.partial(
        train_image.ExperimentLogger, use_tensorboard=False))


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _main(argv):
    """Run the app; (its aggregate metrics.json, its log lines)."""
    lines, logger = _Lines(), logging.getLogger('shacira_tpu_torch')
    level = logger.level
    logger.addHandler(lines)
    logger.setLevel(logging.INFO)
    try:
        assert train_image.main(argv) == 0
    finally:
        logger.removeHandler(lines)
        logger.setLevel(level)
    with open(os.path.join(argv[argv.index('--log-dir') + 1], 'img',
                           'metrics.json')) as f:
        return json.load(f), lines.lines


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp('imgs')
    for i in range(2):
        img = image8(16, 24, seed=i)
        Image.fromarray((img * 255).round().astype(np.uint8)).save(
            str(d / f'im{i}.png'))
    return str(d)


def _argv(images, log_dir, *extra):
    return ['--dataset-path', images, '--log-dir', log_dir, '--exp-name',
            'img', *FLAGS, *extra]


@pytest.fixture(scope='module')
def trained(images, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp('runs'))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_image, 'ExperimentLogger', functools.partial(
            train_image.ExperimentLogger, use_tensorboard=False))
        agg, lines = _main(_argv(images, log_dir))
    return {'dir': os.path.join(log_dir, 'img'), 'log_dir': log_dir,
            'agg': agg, 'lines': lines}


def test_app_writes_per_image_results_and_complete(trained, images):
    exp = trained['dir']
    assert sorted(os.listdir(exp)) == ['complete', 'im0', 'im1',
                                       'metrics.json']
    for name in ('im0', 'im1'):
        files = set(os.listdir(os.path.join(exp, name)))
        assert {'metrics.json', 'predicted.png', 'model_best.ckpt',
                'resume_state.ckpt'} <= files
    agg = trained['agg']
    assert agg['average']['num_images'] == 2
    for m in agg['per_image']:
        assert np.isfinite(m['PSNR']) and m['BPP'] > 0
        assert m['total_size_kb'] > 0 and m['stream'] in ('histogram',
                                                          'prob_model')
        assert m['epoch'] == 40
    assert any(ln.startswith('epoch 40 | PSNR') for ln in trained['lines'])
    # a complete experiment exits without training
    _, lines = _main(_argv(images, trained['log_dir']))
    assert any('already complete' in ln for ln in lines)


def test_valid_only_reproduces_the_psnr(trained, images):
    agg, lines = _main(_argv(images, trained['log_dir'], '--valid-only'))
    assert not any(ln.startswith('epoch ') for ln in lines)
    assert abs(agg['average']['PSNR'] - trained['agg']['average']['PSNR']) \
        < 0.75
    assert agg['average']['BPP'] == pytest.approx(
        trained['agg']['average']['BPP'], rel=1e-6)


def test_resume_continues_at_the_image_index(images, tmp_path):
    log_dir = str(tmp_path)
    _main(_argv(images, log_dir, '--resume', 'true', '--epochs', '20'))
    exp = os.path.join(log_dir, 'img')
    with open(os.path.join(exp, 'resume_image_idx.json')) as f:
        assert json.load(f) == {'image_idx': 2}
    os.remove(os.path.join(exp, 'complete'))
    with open(os.path.join(exp, 'resume_image_idx.json'), 'w') as f:
        json.dump({'image_idx': 1}, f)
    agg, lines = _main(_argv(images, log_dir, '--resume', 'true'))
    assert 'Resuming at image index 1' in lines
    assert not any(ln.startswith('Training image 1/2') for ln in lines)
    assert 'Resumed image run at epoch 20' in lines
    assert agg['average']['num_images'] == 1
    assert agg['per_image'][0]['epoch'] == 40


def test_pretrained_and_profile(trained, images, tmp_path):
    best = os.path.join(trained['dir'], 'im0', 'model_best.ckpt')
    _, lines = _main(_argv(images, str(tmp_path), '--pretrained', best,
                           '--profile', '--epochs', '2', '--metrics-only'))
    assert any(ln.startswith('Loaded pretrained model') for ln in lines)
    run = os.path.join(str(tmp_path), 'img', 'im0')
    assert os.path.exists(os.path.join(run, 'profile', 'trace.json'))
    assert 'predicted.png' not in os.listdir(run)


def _trained_port(tmp_path, epochs=6):
    *_, tm, tc = _cfgs(epochs=12, log_every=-1, chunk_size=4, valid_every=3)
    ds = timage.ImageDataset(image8(), 100, 'woreplace', seed=0)
    tr = tit.ImageTrainer(tc, tm, ds, seed=3, device='cpu',
                          log_dir=str(tmp_path))
    tr.train(epochs=epochs, finalize=False)
    return tr, (tc, tm, ds)


def test_image_trainer_restore_round_trip(tmp_path):
    tr, (tc, tm, ds) = _trained_port(tmp_path)
    path = str(tmp_path / 'resume_state.ckpt')
    tckpt.save_trainer(tr, path)
    state = tckpt.load_state(path)
    assert state['epoch'] == 6 and state['iteration'] is None
    assert {'best_params', 'best_loss', 'best_psnr', '_resampled_epoch',
            'val_best_params', 'best_val_psnr'} <= set(state)
    back = tit.ImageTrainer(tc, tm, timage.ImageDataset(
        image8(), 100, 'woreplace', seed=0), seed=99, device='cpu')
    tckpt.restore_trainer(back, path)
    assert back.epoch == 6 and back.best_val_psnr == tr.best_val_psnr
    for a, b in ((back.params, tr.params), (back.best_params, tr.best_params),
                 (back.opt_state['mu'], tr.opt_state['mu'])):
        for (_, x), (_, y) in zip(toptim.tree_leaves_with_path(a),
                                  toptim.tree_leaves_with_path(b)):
            assert torch.equal(x, y)
    assert float(back.best_loss) == float(tr.best_loss)
    # the restored trainer continues exactly as the original
    tr.train(epochs=2, finalize=False)
    back.train(epochs=2, finalize=False)
    assert torch.equal(back.params['grid']['codebook'],
                       tr.params['grid']['codebook'])


def test_jax_image_checkpoints_load_into_the_port(tmp_path):
    jm, jc, tm, tc = _cfgs(epochs=6, log_every=-1, chunk_size=3)
    img = image8()
    jtr = jit_.ImageTrainer(jc, jm, jimage.ImageDataset(img), seed=0)
    jtr.train(finalize=False)
    resume = str(tmp_path / 'resume_state.ckpt')
    best = str(tmp_path / 'model_best.ckpt')
    jckpt.save_trainer(jtr, resume)
    jckpt.save_model(best, jtr.best_params, configs={'model': jm,
                                                     'trainer': jc})
    state = tckpt.load_model(best)
    assert state['format'] == 'full'
    assert isinstance(state['configs']['model'], tckpt.JaxObject)
    assert state['configs']['model'].jax_class \
        == 'shacira_tpu.models.nefs.image.NeuralImageConfig'
    ttr = tit.ImageTrainer(tc, tm, timage.ImageDataset(img), device='cpu')
    tckpt.check_like(state['params'], ttr.params, best)
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray,
                                                  jtr.best_params))
    got = [t.numpy() for _, t in toptim.tree_leaves_with_path(
        state['params'])]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    gen_state = ttr.generator.get_state()
    tckpt.restore_trainer(ttr, resume)
    assert ttr.epoch == 6
    # a JAX key cannot seed the generator: it is kept
    assert torch.equal(ttr.generator.get_state(), gen_state)
    for tree_t, tree_j in ((ttr.params, jtr.params),
                           (ttr.opt_state['mu'], jtr.opt_state.mu),
                           (ttr.best_params, jtr.best_params)):
        for (_, g), w in zip(toptim.tree_leaves_with_path(tree_t),
                             jax.tree_util.tree_leaves(tree_j)):
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    assert ttr.opt_state['count'] == int(jtr.opt_state.count)
    assert float(ttr.best_loss) == float(jtr.best_loss)
    np.testing.assert_array_equal(ttr.noise.numpy(), np.asarray(jtr.noise))
    # and trains on to the configured end
    out = ttr.train()
    assert ttr.epoch == 6 and np.isfinite(out['PSNR'])


def test_multiview_grid_lr_is_not_scaled_for_a_multi_decoder(monkeypatch):
    """C3: the multiview trainer scales the grid lr by the decoder's scale
    norm only for the single decoder, as the JAX trainer does."""
    from shacira_tpu_torch.models.grids import latent_grid as tlg
    from shacira_tpu_torch.models.nefs import nerf as tnerf
    from shacira_tpu_torch.tracers import rf_tracer as trt
    from shacira_tpu_torch.trainers import multiview_trainer as tmt
    from tests.test_torch_step import GRID, LDEC, TRAIN, _scene
    _, tdata = _scene(num_views=2, res=8)
    seen = {}
    orig = toptim.adam_update

    def spy(grads, state, params, labels, lr, *a, **k):
        seen.setdefault('grid', []).append(float(lr['grid']))
        return orig(grads, state, params, labels, lr, *a, **k)

    monkeypatch.setattr(tmt.optim, 'adam_update', spy)
    for ltype in ('multi', 'single'):
        grid = tlg.LatentGridConfig.from_geometric(**GRID).with_ldec(
            LDEC, ldecode_type=ltype)
        tr = tmt.MultiviewTrainer(
            tmt.MultiviewTrainerConfig(**TRAIN),
            tnerf.NeuralRadianceFieldConfig(grid=grid, hidden_dim=8),
            trt.RFTracerConfig(num_steps=16), tdata, num_rays=32, seed=0,
            device='cpu')
        assert TRAIN['scale_grid_lr'] == 'div'
        seen.clear()
        tr.train(num_iterations=1)
        grid_lr = float(np.float32(TRAIN['grid_lr']))    # an f32 fill
        if ltype == 'multi':
            assert seen['grid'] == [grid_lr]
        else:
            assert seen['grid'][0] != pytest.approx(grid_lr)
