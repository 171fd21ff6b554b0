"""Port parity of the image INR step: the full-image step (row-major pixel
lattice, plain B1) against the JAX package's step on its lattice path, the
sampled steps with injected pixels against its host-batch path, the
schedules, a short training run with the JAX-drawn randomness, and the
size report.

Tolerances: the loss and PSNR agree to rtol 1e-5; the Adam first moments
(0.1 x the gradient) to 2e-4 of each leaf's largest entry (the lattice
path sums the same products in another order); the updated parameters to
1e-5 absolute at the grid lr of 0.02, scaled with the grid lr where
``scale_grid_lr='div'`` raises it (Adam's first update is lr * g / (|g| +
eps), so a table entry with a gradient near eps moves by up to the lr
times the gradient's relative error).  Identical
injected draws (SGA uniforms, rate noise, pixel indices) on both sides."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.datasets import image as jimage  # noqa: E402
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.nefs import image as jnef  # noqa: E402
from shacira_tpu.trainers import image_trainer as jit_  # noqa: E402
from shacira_tpu_torch import optim as toptim  # noqa: E402
from shacira_tpu_torch.datasets import image as timage  # noqa: E402
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.nefs import image as tnef  # noqa: E402
from shacira_tpu_torch.trainers import image_trainer as tit  # noqa: E402
from shacira_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)

TINY = float(np.finfo(np.float32).tiny)
H, W = 24, 36
GRID = dict(feature_dim=1, num_lods=4, min_grid_res=4, max_grid_res=32,
            latent_dim=1, multiscale_type='cat', resolution_dim=2,
            feature_std=0.5, codebook_bitwidth=6, init_grid='uniform',
            num_prob_layers=2, entropy_enabled=True)
LDEC = dict(norm='max', ldecode_matrix='sq', use_shift=True, ldec_std=0.1,
            use_sga=True, diff_sampling=True)
TRAIN = dict(epochs=20, use_sga=True, decay_period=0.5, temperature=0.1,
             norm='max', norm_every=3, entropy_reg=1e-3,
             entropy_reg_end=1e-4, log_every=-1, lr=5e-3, grid_lr=0.02)


def image8(h=H, w=W, seed=0):
    """An 8-bit-source image in [0, 1] (smooth plus noise)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing='ij')
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx), 0.5 + 0.4 * np.cos(5 * yy),
                    0.5 * (xx + yy)], -1) + rng.rand(h, w, 3) * 0.1
    return (np.round(np.clip(img, 0, 1) * 255) / 255).astype(np.float32)


def _cfgs(ldecode_type='single', **train):
    kw = {**TRAIN, **train}
    jg = jlg.LatentGridConfig.from_geometric(**GRID).with_ldec(
        LDEC, ldecode_type=ldecode_type)
    tg = tlg.LatentGridConfig.from_geometric(**GRID).with_ldec(
        LDEC, ldecode_type=ldecode_type)
    return (jnef.NeuralImageConfig(grid=jg, hidden_dim=8),
            jit_.ImageTrainerConfig(**kw),
            tnef.NeuralImageConfig(grid=tg, hidden_dim=8),
            tit.ImageTrainerConfig(**kw))


def _pair(mode='full', num_samples=-1, ldecode_type='single', **train):
    """A JAX trainer and a port trainer on the same image and params."""
    img = image8()
    jm, jc, tm, tc = _cfgs(ldecode_type, **train)
    jds = jimage.ImageDataset(img, num_samples, mode, seed=0)
    tds = timage.ImageDataset(img, num_samples, mode, seed=0)
    jtr = jit_.ImageTrainer(jc, jm, jds, seed=0)
    ttr = tit.ImageTrainer(tc, tm, tds, seed=0, device='cpu')
    ttr.set_params(params_from_jax(jax.tree.map(np.asarray, jtr.params)),
                   adam_state_from_jax(jtr.opt_state.mu, jtr.opt_state.nu,
                                       jtr.opt_state.count))
    return jtr, ttr


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tleaves(tree):
    return [t.detach().numpy() for _, t in toptim.tree_leaves_with_path(tree)]


def _draws(key, cb_shape, use_sga, refresh, idx=None):
    """The port's draws of one JAX step key (the split the JAX step
    makes)."""
    k_sga, k_noise = jax.random.split(key)
    d = tit.ImageStepDraws()
    if use_sga:
        d.sga_u = torch.as_tensor(np.array(jax.random.uniform(
            k_sga, cb_shape, dtype=jnp.float32, minval=TINY, maxval=1.0)))
    if refresh:
        d.noise = torch.as_tensor(np.array(
            jax.random.uniform(k_noise, cb_shape) - 0.5))
    if idx is not None:
        d.idx = torch.as_tensor(idx)
    return d


def _check_state(ttr, params, opt, metrics, tmet, param_atol=1e-5):
    np.testing.assert_allclose(float(tmet['loss']), float(metrics['loss']),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet['rgb_loss']),
                               float(metrics['rgb_loss']), rtol=1e-5)
    np.testing.assert_allclose(float(tmet['psnr']), float(metrics['psnr']),
                               rtol=1e-5)
    for got, want in zip(_tleaves(ttr.opt_state['mu']), _leaves(opt.mu)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-4 * np.abs(want).max() + 1e-12)
    for got, want in zip(_tleaves(ttr.params), _leaves(params)):
        np.testing.assert_allclose(got, want, rtol=0, atol=param_atol)
    assert ttr.opt_state['count'] == int(opt.count)


# (use_sga, do_recalib, scale_grid_lr, optimizer)
FULL_CASES = {'sga': (True, False, 'none', 'adam'),
              'ste': (False, False, 'none', 'adam'),
              'recalib': (True, True, 'none', 'adam'),
              'div': (False, True, 'div', 'adamw')}


@pytest.mark.parametrize('case', sorted(FULL_CASES))
def test_full_step_matches_the_jax_lattice_step(case):
    use_sga, recal, scale, opt_type = FULL_CASES[case]
    jtr, ttr = _pair(scale_grid_lr=scale, optimizer_type=opt_type)
    assert jtr.plan_meta is not None          # the JAX lattice path
    ds = jtr.dataset
    coords = jnp.asarray(jimage.pixel_coords(H, W))
    gt = jnp.asarray(ds.rgb)
    tcoords, tgt = (torch.as_tensor(np.array(coords)),
                    torch.as_tensor(ds.rgb))
    jstep = jax.jit(jtr._raw_step(use_sga))
    state = (jtr.params, jtr.opt_state, jtr.noise)
    cb_shape = jtr.params['grid']['codebook'].shape
    lod_mask = jnp.ones((GRID['num_lods'],), jnp.float32)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(5), 2)):
        lr_scale = (float(1.0 / np.linalg.norm(
            state[0]['grid']['latent_dec']['layers'][0]['scale']))
            if scale == 'div' else 1.0)
        sched = dict(ent_lambda=1e-3, temperature=0.4, lr_ldec=0.01)
        p, o, n, metrics = jstep(
            *state, coords, gt, jtr.plan_arrays, key,
            jnp.float32(sched['ent_lambda']),
            jnp.float32(sched['temperature']), jnp.float32(sched['lr_ldec']),
            jnp.asarray(recal), jnp.asarray(True), lod_mask)
        state = (p, o, n)
        tmet = ttr.step(tcoords, tgt, _draws(key, cb_shape, use_sga, True),
                        use_sga=use_sga, do_recalib=recal, **sched)
        _check_state(ttr, p, o, metrics, tmet,
                     param_atol=1e-5 * max(1.0, lr_scale))
        np.testing.assert_allclose(ttr.noise.numpy(), np.asarray(n))


@pytest.mark.parametrize('mode', ['wreplace', 'woreplace'])
def test_sampled_step_matches_the_jax_host_batch_step(mode):
    ns = 200
    jtr, ttr = _pair(mode, ns)
    jds = jtr.dataset
    jstep = jax.jit(jtr._raw_step(True))
    state = (jtr.params, jtr.opt_state, jtr.noise)
    cb_shape = jtr.params['grid']['codebook'].shape
    lod_mask = jnp.ones((GRID['num_lods'],), jnp.float32)
    rng = np.random.RandomState(3)
    for it, key in enumerate(jax.random.split(jax.random.PRNGKey(9), 2), 1):
        if mode == 'wreplace':
            idx = rng.randint(0, H * W, ns)
            c = jimage.index_to_coords(idx, H, W)
            g = jds.rgb[idx]
        else:
            idx = None
            c, g = jds.batch(it - 1)
        sched = dict(ent_lambda=1e-3, temperature=0.4, lr_ldec=0.01)
        p, o, n, metrics = jstep(
            *state, jnp.asarray(c), jnp.asarray(g), None, key,
            jnp.float32(sched['ent_lambda']),
            jnp.float32(sched['temperature']), jnp.float32(sched['lr_ldec']),
            jnp.asarray(False), jnp.asarray(True), lod_mask)
        state = (p, o, n)
        if ttr._dev_img is None:
            ttr._sampling_setup()
        draws = _draws(key, cb_shape, True, True, idx)
        tc, tg = ttr.pixel_batch(draws.idx if idx is not None
                                 else ttr.batch_indices(it))
        np.testing.assert_array_equal(tg.numpy(), g)
        np.testing.assert_allclose(tc.numpy(), c, rtol=0, atol=1e-7)
        tmet = ttr.step(tc, tg, draws, use_sga=True, **sched)
        _check_state(ttr, p, o, metrics, tmet)


def test_u8_image_dequantizes_bit_equal_and_tail_slice_is_clamped():
    ns = 100
    ds = timage.ImageDataset(image8(), ns, 'woreplace', seed=1)
    tr = tit.ImageTrainer(tit.ImageTrainerConfig(),
                          _cfgs()[2], ds, device='cpu')
    tr._sampling_setup()
    assert tr._dev_img.dtype == torch.uint8 and tr._lut is not None
    idx = torch.arange(H * W)
    np.testing.assert_array_equal(tr.pixel_batch(idx)[1].numpy(), ds.rgb)
    # coordinates as the host computes them
    np.testing.assert_array_equal(tr.pixel_batch(idx)[0].numpy(),
                                  jimage.index_to_coords(np.arange(H * W),
                                                         H, W))
    nb = len(ds)
    assert nb == -(-H * W // ns)
    for b in range(nb - 1):
        np.testing.assert_array_equal(tr.batch_indices(b + 1).numpy(),
                                      ds.shuffle_idx[b * ns:(b + 1) * ns])
    # the tail batch overlaps the one before it (the start clamped)
    np.testing.assert_array_equal(tr.batch_indices(nb).numpy(),
                                  ds.shuffle_idx[H * W - ns:])
    # a float image that is not 8-bit stays float32
    img = image8() + 1e-3
    tr2 = tit.ImageTrainer(tit.ImageTrainerConfig(), _cfgs()[2],
                           timage.ImageDataset(img, ns, 'wreplace'),
                           device='cpu')
    tr2._sampling_setup()
    assert tr2._dev_img.dtype == torch.float32 and tr2._lut is None


def test_resample_fires_once_an_epoch():
    ds = timage.ImageDataset(image8(), 96, 'woreplace', seed=0)
    calls = []
    orig = ds.resample
    ds.resample = lambda: (calls.append(1), orig())[1]
    cfg = tit.ImageTrainerConfig(epochs=3, log_every=-1, chunk_size=3,
                                 resample=True, resample_every=1)
    mcfg = tnef.NeuralImageConfig(
        grid=tlg.LatentGridConfig.from_geometric(
            **{**GRID, 'entropy_enabled': False}), hidden_dim=8)
    tr = tit.ImageTrainer(cfg, mcfg, ds, device='cpu')
    perms = []
    orig_upload = tr._upload_perm
    tr._upload_perm = lambda: (orig_upload(), perms.append(
        tr._dev_perm.clone()))[0]
    tr.train(finalize=False)
    # epochs 2 and 3 start with a new permutation, never inside a chunk
    assert len(calls) == 2 and tr.epoch == 3
    assert len(perms) == 3
    np.testing.assert_array_equal(perms[-1].numpy(), ds.shuffle_idx)


def test_schedules_and_sga_flip_equal_jax_on_kodak():
    from shacira_tpu import config as jconfig
    from shacira_tpu_torch import config as tconfig
    argv = ['--config', 'configs/kodak.yaml']
    jargs = jconfig.parse_args(jconfig.build_image_parser(), argv)
    targs = tconfig.parse_args(tconfig.build_image_parser(), argv)
    jc = jconfig.build_image_trainer_config(jargs)
    tc = tconfig.build_image_trainer_config(targs)
    for f in ('epochs', 'use_sga', 'decay_period', 'temperature', 'norm',
              'norm_every', 'entropy_reg', 'entropy_reg_end', 'noise_freq',
              'ldec_lr', 'grid_lr', 'weight_decay_decoder', 'log_every'):
        assert getattr(tc, f) == getattr(jc, f), f
    # the kodak widths on a small image: the schedules need no training
    img = image8()
    jm = jconfig.build_image_model_config(jargs)
    tm = tconfig.build_image_model_config(targs)
    assert tm.grid.spec.total_size == jm.grid.spec.total_size == 40282
    jtr = jit_.ImageTrainer(jc, jm, jimage.ImageDataset(img), seed=0)
    ttr = tit.ImageTrainer(tc, tm, timage.ImageDataset(img), device='cpu')
    for e0, n in ((1, 400), (53_990, 20), (59_900, 101)):
        want = jtr._schedule_arrays(e0, n)
        got = ttr._schedule_arrays(e0, n)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    # sampled: epochs by iteration (pearl's noise_freq 50)
    iters = np.arange(1, 301)
    want = jtr._schedule_arrays(0, 300, epochs=(iters - 1) // 16 + 1,
                                iters=iters)
    got = ttr._schedule_arrays(0, 300, epochs=(iters - 1) // 16 + 1,
                               iters=iters)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    for e in (1, 53_999, 54_000, 54_001, 60_000):
        assert ttr._use_sga_at(e) == jtr._use_sga_at(e), e
    assert ttr._sga_flip() == 54_000


def _record_jax_chunks(jtr):
    """Wrap the JAX trainer's chunk function to record each chunk's
    (use_sga, per-step keys, refresh flags)."""
    chunks = []
    orig = jtr._get_chunk_fn

    def get(use_sga):
        fn = orig(use_sga)

        def run(*args):
            xs = args[-1]
            chunks.append((use_sga, np.asarray(xs['rng']),
                           np.asarray(xs['refresh_noise'])))
            return fn(*args)
        return run
    jtr._get_chunk_fn = get
    return chunks


def test_training_matches_jax_best_state_history_and_metrics(tmp_path):
    jm, jc, tm, tc = _cfgs(epochs=12, log_every=4, chunk_size=4)
    img = image8()
    jtr = jit_.ImageTrainer(jc, jm, jimage.ImageDataset(img), seed=0,
                            log_dir=str(tmp_path / 'jax'))
    ttr = tit.ImageTrainer(tc, tm, timage.ImageDataset(img), device='cpu',
                           log_dir=str(tmp_path / 'port'))
    ttr.set_params(params_from_jax(jax.tree.map(np.asarray, jtr.params)))
    chunks = _record_jax_chunks(jtr)
    want = jtr.train()
    cb_shape = jtr.params['grid']['codebook'].shape
    draws = [_draws(jnp.asarray(k), cb_shape, sga, bool(r))
             for sga, keys, refresh in chunks for k, r in zip(keys, refresh)]
    assert len(draws) == 12
    it = iter(draws)
    ttr.draw_step = lambda use_sga, refresh_noise=True: next(it)
    got = ttr.train()
    assert [e['epoch'] for e in ttr.history] \
        == [e["epoch"] for e in jtr.history] == [4, 12]
    for te, je in zip(ttr.history, jtr.history):
        assert set(te) == set(je)
        for k in ('psnr', 'rgb_loss', 'best_psnr', 'ent_loss'):
            np.testing.assert_allclose(te[k], je[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(ttr.best_loss), float(jtr.best_loss),
                               rtol=1e-5)
    for g, w in zip(_tleaves(ttr.best_params), _leaves(jtr.best_params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert set(got) == set(want)
    for k in ('PSNR', 'rgb_loss', 'epoch', 'remainder_size_kb',
              'ldec_size_kb'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    import json
    with open(tmp_path / 'port' / 'metrics.json') as f:
        assert set(json.load(f)) == set(want)


def test_size_report_equals_jax_in_every_key():
    jtr, ttr = _pair()
    params = jax.tree.map(np.asarray, jtr.params)
    # spread the latents over a few dozen symbols
    params['grid']['codebook'] = (params['grid']['codebook'] * 30).round(3)
    ttr.set_params(params_from_jax(params))
    for use_codec in (False, True):
        want = jtr.size_report(use_codec=use_codec, params=params)
        got = ttr.size_report(use_codec=use_codec)
        assert set(got) == set(want), use_codec
        for k, v in want.items():
            if k == 'stream':
                assert got[k] == v
            elif k == 'latent_size_kb_pm' or (
                    want.get('stream') == 'prob_model'
                    and k in ('latent_size_kb', 'total_size_kb', 'bpp')):
                # the prob-model stream rests on two f32 CDFs
                np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-7, err_msg=k)
