"""Port parity: the compressed size report and the latent codestream.

A small NeRF ``MultiviewTrainer`` in each package, the JAX params carried
across with ``params_from_jax`` (the codebook scaled so that the rounded
latents span a few dozen symbols).  ``size_report`` must equal the JAX
package's exactly in every histogram key, with ``use_codec`` False and
True; the prob-model entries agree within 0.1 % (the BitEstimator CDF is
evaluated in f32 by two libraries, and the CDF quantization can flip on a
last-bit difference) and ``stream`` is the same.  Histogram-coded streams
are byte-identical to the JAX package's.
"""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.nefs import nerf as jnerf  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu_torch.models import latent_decoders as tld  # noqa: E402
from shacira_tpu_torch.models import mlp as tmlp  # noqa: E402
from shacira_tpu_torch.models import pipeline as tpipe  # noqa: E402
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.nefs import nerf as tnerf  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils.convert import params_from_jax  # noqa: E402

from tests.test_torch_step import GRID, LDEC, NERF, TRAIN, _scene  # noqa: E402

HIST_KEYS = ('ldec_size_kb', 'latent_size_kb', 'remainder_size_kb',
             'total_size_kb', 'latent_size_kb_hist', 'total_size_kb_hist')


def _trainers(latent_dim, amp=False, scale=6.0, res=8):
    """(JAX trainer, port trainer, JAX params as numpy, port params)."""
    jdata, tdata = _scene(num_views=2, res=res)
    grid = dict(GRID, latent_dim=latent_dim, num_prob_layers=4)
    jm = jnerf.NeuralRadianceFieldConfig(
        grid=jlg.LatentGridConfig.from_geometric(**grid).with_ldec(LDEC),
        amp=amp, **NERF)
    tm = tnerf.NeuralRadianceFieldConfig(
        grid=tlg.LatentGridConfig.from_geometric(**grid).with_ldec(LDEC),
        amp=amp, **NERF)
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN), jm,
        jrt.RFTracerConfig(num_steps=32), jdata, num_rays=16, seed=0)
    ttr = tmt.MultiviewTrainer(tmt.MultiviewTrainerConfig(**TRAIN), tm,
                               trt.RFTracerConfig(num_steps=32), tdata,
                               num_rays=16, seed=0, device='cpu')
    params = jax.tree.map(np.asarray, jtr.params)
    params['grid']['codebook'] = params['grid']['codebook'] * scale
    tparams = params_from_jax(params)
    ttr.set_params(tparams)
    return jtr, ttr, params, tparams


@pytest.fixture(scope='module', params=[1, 2], ids=['ld1', 'ld2'])
def trainers(request):
    return _trainers(request.param)


@pytest.mark.parametrize('use_codec', [False, True])
def test_size_report_equals_jax(trainers, use_codec):
    jtr, ttr, params, _ = trainers
    want = jtr.size_report(use_codec=use_codec, params=params)
    got = ttr.size_report(use_codec=use_codec)
    assert set(got) == set(want)
    assert got['total_size_kb'] > 0
    for k in HIST_KEYS:
        if k in want:
            assert got[k] == want[k], k
    if use_codec:
        assert got['stream'] == want['stream'] == 'histogram'
        np.testing.assert_allclose(got['latent_size_kb_pm'],
                                   want['latent_size_kb_pm'], rtol=1e-3)


@pytest.mark.parametrize('use_codec', [False, True])
def test_prob_model_sizes_match_jax(trainers, use_codec):
    _, ttr, params, tparams = trainers
    jcfg = jlg.LatentGridConfig.from_geometric(
        **dict(GRID, latent_dim=params['grid']['codebook'].shape[1],
               num_prob_layers=4)).with_ldec(LDEC)
    want = jlg.grid_size_bits(params['grid'], jcfg, use_codec=use_codec,
                              use_prob_model=True, count_side_info=True)
    got = tlg.grid_size_bits(tparams['grid'], ttr.model_cfg.grid,
                             use_codec=use_codec, use_prob_model=True,
                             count_side_info=True)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)


def test_side_info_and_model_bits_equal_jax(trainers):
    _, _, params, tparams = trainers
    assert (tlg.stream_side_info_bits(tparams['grid'])
            == jlg.stream_side_info_bits(params['grid']))
    assert (tlg.prob_model_size_bits(tparams['grid'])
            == jlg.prob_model_size_bits(params['grid']) > 0)
    np.testing.assert_allclose(
        float(tlg.rounding_loss(tparams['grid']).detach()),
        float(jlg.rounding_loss(params['grid'])), rtol=1e-6)


@pytest.mark.parametrize('use_prob_model', [False, True])
def test_codestream_round_trip(trainers, use_prob_model):
    _, ttr, params, tparams = trainers
    blob = tlg.encode_grid_stream(tparams['grid'], ttr.model_cfg.grid,
                                  use_prob_model=use_prob_model)
    np.testing.assert_array_equal(tlg.decode_grid_stream(blob),
                                  np.round(params['grid']['codebook']))
    if not use_prob_model:
        jcfg = jlg.LatentGridConfig.from_geometric(
            **dict(GRID, latent_dim=blob['latent_dim'],
                   num_prob_layers=4)).with_ldec(LDEC)
        jblob = jlg.encode_grid_stream(params['grid'], jcfg)
        for got, want in zip(blob['channels'], jblob['channels']):
            assert got['stream'] == want['stream']
            np.testing.assert_array_equal(got['alphabet'], want['alphabet'])


def test_single_channel_cdf_matches_jax(trainers):
    _, ttr, params, tparams = trainers
    from shacira_tpu.models import prob_models as jpm
    from shacira_tpu_torch.models import prob_models as tpm
    x = np.linspace(-20, 20, 81).astype(np.float32)
    pcfg = ttr.model_cfg.grid.prob_cfg
    for c in range(pcfg.channels):
        want = np.asarray(jpm.bit_estimator_apply(
            params['grid']['prob_model'], pcfg, x, single_channel=c))
        got = tpm.bit_estimator_apply(tparams['grid']['prob_model'], pcfg,
                                      torch.as_tensor(x), single_channel=c)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-7)


def test_head_bits_count_the_stored_dtype():
    """With AMP the head runs in bf16 but stores f32: 32 bits a weight."""
    jtr, ttr, params, tparams = _trainers(1, amp=True)
    assert ttr.model_cfg.amp
    n = sum(t.numel() for name in ('decoder_density', 'decoder_color')
            for layer in tparams[name]['layers'] for t in layer.values())
    assert tnerf.non_grid_size_bits(tparams) == 32 * n \
        == jnerf.non_grid_size_bits(params)
    assert (tld.latent_decoder_size_bits(tparams['grid']['latent_dec'])
            == jlg.latent_decoder_size_bits(params['grid']['latent_dec']))
    assert (tmlp.mlp_size_bits(tparams['decoder_color'])
            == jnerf.mlp_mod.mlp_size_bits(params['decoder_color']))


def test_decode_once_and_pipeline(trainers):
    _, ttr, params, tparams = trainers
    from shacira_tpu.models import pipeline as jpipe
    jcfg = jlg.LatentGridConfig.from_geometric(
        **dict(GRID, latent_dim=params['grid']['codebook'].shape[1],
               num_prob_layers=4)).with_ldec(LDEC)
    want = np.asarray(jpipe.decode_once(params, jcfg))
    got = tpipe.decode_once(tparams, ttr.model_cfg.grid)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    pipe = tpipe.Pipeline(nef_fn=lambda p, x: ('nef', x),
                          tracer_fn=lambda p, x: ('tracer', x))
    assert pipe(tparams, 1) == ('tracer', 1)
    assert tpipe.Pipeline(nef_fn=lambda p, x: ('nef', x))(tparams, 2) \
        == ('nef', 2)


def test_unported_decoders_raise():
    """The multi and hierarchical decoders are ported now (their sizes are
    held to JAX's in tests/test_torch_image_decoders.py); what raises is an
    unknown decoder type, and the config reader's ``--ldecode-type`` other
    than 'single', which the JAX apps parse but never pass on."""
    from shacira_tpu_torch import config as tconfig
    for ltype in ('multi', 'hierarchical'):
        cfg = tlg.LatentGridConfig.from_geometric(**GRID).with_ldec(
            LDEC, ldecode_type=ltype)
        params = tlg.latent_grid_init(torch.Generator().manual_seed(0), cfg,
                                      'cpu')
        assert tlg.grid_size_bits(params, cfg)[0] > 0
    with pytest.raises(ValueError):
        tlg.LatentGridConfig.from_geometric(**GRID, ldecode_type='bogus')
    args = tconfig.parse_args(tconfig.build_nerf_parser(),
                              ['--ldecode-enabled', 'true',
                               '--ldecode-type', 'multi'])
    with pytest.raises(NotImplementedError, match='never pass it'):
        tconfig.build_nerf_model_config(args)
