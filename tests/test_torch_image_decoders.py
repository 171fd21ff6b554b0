"""Port parity of the decoders the image path adds: the multi and
hierarchical latent decoders and grids (forward, ``ste_one_hot`` gradient,
size bits), ``recalibrate_div``, the identity decoder, the normalized MLP
layers and weight inits, the image field, and the parameter trees that
``utils/convert.py`` carries across.  Forward values agree to rtol 1e-5,
gradients to 1e-5 of their largest entry; sizes exactly."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.models import latent_decoders as jld  # noqa: E402
from shacira_tpu.models import mlp as jmlp  # noqa: E402
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.nefs import image as jnef  # noqa: E402
from shacira_tpu_torch import optim as toptim  # noqa: E402
from shacira_tpu_torch.models import latent_decoders as tld  # noqa: E402
from shacira_tpu_torch.models import mlp as tmlp  # noqa: E402
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.nefs import image as tnef  # noqa: E402
from shacira_tpu_torch.utils.convert import params_from_jax  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_ste_one_hot_forward_and_gradient():
    alpha = np.random.RandomState(0).randn(3, 7).astype(np.float32)
    coef = np.random.RandomState(1).randn(3, 7).astype(np.float32)
    want = jld.ste_one_hot(jnp.asarray(alpha))
    jg = jax.grad(lambda a: jnp.sum(jld.ste_one_hot(a) * coef))(
        jnp.asarray(alpha))
    a = torch.tensor(alpha, requires_grad=True)
    got = tld.ste_one_hot(a)
    _close(got, want, rtol=0, atol=0)
    (tg,) = torch.autograd.grad(torch.sum(got * torch.as_tensor(coef)), a)
    _close(tg, jg, rtol=0, atol=0)


@pytest.mark.parametrize('matrix,straight,use_sga', [
    ('sq', True, False), ('sq', False, True), ('dft', False, True),
    ('dft', True, False)])
def test_multi_decoder_matches_jax(matrix, straight, use_sga):
    cfg_kw = dict(latent_dim=2, feature_dim=3, num_entries=40,
                  num_decoders=3, use_shift=True, ldecode_matrix=matrix,
                  diff_sampling=True)
    jcfg = jld.MultiLatentDecoderConfig(**cfg_kw)
    tcfg = tld.MultiLatentDecoderConfig(**cfg_kw)
    params = _np(jld.multi_latent_decoder_init(jax.random.PRNGKey(2), jcfg))
    params['div'] = np.asarray([1.5, 0.7], np.float32)
    w = (np.random.RandomState(0).randn(40, 2) * 2).astype(np.float32)
    key = jax.random.PRNGKey(4)
    u = np.array(jax.random.uniform(key, w.shape, dtype=jnp.float32,
                                    minval=TINY, maxval=1.0))
    kw = dict(use_sga=use_sga, temperature=0.6, straight_through=straight)

    def jf(p, w_):
        return jld.multi_latent_decoder_apply(p, jcfg, w_, rng=key, **kw)

    want = jax.jit(jf)(params, jnp.asarray(w))
    cot = np.random.RandomState(5).randn(*want.shape).astype(np.float32)
    jgp, jgw = jax.jit(jax.grad(lambda p, w_: jnp.sum(jf(p, w_) * cot),
                                argnums=(0, 1)))(params, jnp.asarray(w))
    tp = params_from_jax(params)
    trained = [(pth, t) for pth, t in toptim.tree_leaves_with_path(tp)]
    for _, t in trained:
        t.requires_grad_(True)
    tw = torch.tensor(w, requires_grad=True)
    got = tld.multi_latent_decoder_apply(tp, tcfg, tw, sga_u=torch.as_tensor(
        u), **kw)
    _close(got, want)
    grads = torch.autograd.grad(torch.sum(got * torch.as_tensor(cot)),
                                [t for _, t in trained] + [tw],
                                allow_unused=True)
    jflat = dict(zip(
        [tuple(str(getattr(k, 'key', getattr(k, 'idx', k))) for k in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(jgp)[0]],
        jax.tree_util.tree_leaves(jgp)))
    for (pth, _), g in zip(trained, grads[:-1]):
        want_g = np.asarray(jflat[pth])
        got_g = np.zeros_like(want_g) if g is None else g.numpy()
        np.testing.assert_allclose(got_g, want_g, rtol=0,
                                   atol=1e-5 * np.abs(want_g).max() + 1e-12,
                                   err_msg=str(pth))
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgw), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgw)).max())


@pytest.mark.parametrize('use_codec', [False, True])
def test_multi_decoder_size_bits_match_jax(use_codec):
    jcfg = jld.MultiLatentDecoderConfig(latent_dim=1, feature_dim=2,
                                        num_entries=500, num_decoders=4,
                                        use_shift=True)
    params = _np(jld.multi_latent_decoder_init(jax.random.PRNGKey(1), jcfg))
    want = jld.multi_latent_decoder_size_bits(params, use_codec=use_codec)
    got = tld.multi_latent_decoder_size_bits(params_from_jax(params),
                                             use_codec=use_codec)
    assert got == pytest.approx(want, rel=1e-12)


def test_hierarchical_decoder_matches_jax_slice_by_slice():
    dec = dict(latent_dim=1, feature_dim=2, use_shift=True, diff_sampling=True)
    jcfg = jld.HierarchicalLatentDecoderConfig(
        num_decoders=3, offsets=(0, 4, 10, 17),
        decoder=jld.LatentDecoderConfig(**dec))
    tcfg = tld.HierarchicalLatentDecoderConfig(
        num_decoders=3, offsets=(0, 4, 10, 17),
        decoder=tld.LatentDecoderConfig(**dec))
    params = _np(jld.hierarchical_latent_decoder_init(jax.random.PRNGKey(0),
                                                      jcfg))
    w = (np.random.RandomState(0).randn(17, 1) * 2).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p: jld.hierarchical_latent_decoder_apply(
        p, jcfg, jnp.asarray(w), use_sga=True, temperature=0.5,
        rng=key))(params)
    # the JAX decoder draws each slice's uniforms from its own key
    keys = jax.random.split(key, 3)
    u = np.concatenate([np.array(jax.random.uniform(
        keys[l], (jcfg.offsets[l + 1] - jcfg.offsets[l], 1),
        dtype=jnp.float32, minval=TINY, maxval=1.0)) for l in range(3)])
    got = tld.hierarchical_latent_decoder_apply(
        params_from_jax(params), tcfg, torch.as_tensor(w), use_sga=True,
        temperature=0.5, sga_u=torch.as_tensor(u))
    _close(got, want)
    assert tld.hierarchical_latent_decoder_size_bits(
        params_from_jax(params)) \
        == jld.hierarchical_latent_decoder_size_bits(params)


GRID = dict(feature_dim=2, num_lods=3, min_grid_res=4, max_grid_res=16,
            latent_dim=1, multiscale_type='cat', resolution_dim=2,
            feature_std=2.0, codebook_bitwidth=5, init_grid='normal',
            num_prob_layers=2, entropy_enabled=True)
LDEC = dict(norm='none', ldecode_matrix='sq', use_shift=True, ldec_std=0.1)


@pytest.mark.parametrize('ltype', ['multi', 'hierarchical'])
def test_grids_with_multi_and_hierarchical_decoders_match_jax(ltype):
    jcfg = jlg.LatentGridConfig.from_geometric(**GRID).with_ldec(
        LDEC, ldecode_type=ltype, num_decoders=3)
    tcfg = tlg.LatentGridConfig.from_geometric(**GRID).with_ldec(
        LDEC, ldecode_type=ltype, num_decoders=3)
    assert not tlg.supports_affine_fusion(tcfg)
    params = _np(jlg.latent_grid_init(jax.random.PRNGKey(0), jcfg))
    coords = np.random.RandomState(2).uniform(-1, 1, (50, 2)).astype(
        np.float32)

    def jloss(p):
        return jnp.sum((jlg.interpolate(p, jcfg, jnp.asarray(coords))
                        - 1.0) ** 2)

    tp = params_from_jax(params)
    for _, t in toptim.tree_leaves_with_path(tp):
        t.requires_grad_(True)
    feats = tlg.interpolate(tp, tcfg, torch.as_tensor(coords))
    _close(feats, jax.jit(lambda p: jlg.interpolate(
        p, jcfg, jnp.asarray(coords)))(params))
    _close(tlg.decode_codebook(tp, tcfg),
           jax.jit(lambda p: jlg.decode_codebook(p, jcfg))(params))
    (g,) = torch.autograd.grad(torch.sum((feats - 1.0) ** 2),
                               [tp['codebook']])
    jg = jax.jit(jax.grad(jloss))(params)['codebook']
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())
    assert float(np.abs(np.asarray(jg)).sum()) > 0
    for use_codec in (False, True):
        want = jlg.grid_size_bits(params, jcfg, use_codec=use_codec)
        got = tlg.grid_size_bits(params_from_jax(params), tcfg,
                                 use_codec=use_codec)
        assert got[0] == pytest.approx(want[0], rel=1e-12)
        assert got[1] == pytest.approx(want[1], rel=1e-12)


@pytest.mark.parametrize('norm', ['max', 'std', 'none'])
def test_recalibrate_div_matches_jax(norm):
    params = _np(jld.latent_decoder_init(
        jax.random.PRNGKey(0), jld.LatentDecoderConfig(2, 3)))
    lat = (np.random.RandomState(1).randn(100, 2) * 3).astype(np.float32)
    want = jld.recalibrate_div(params, jnp.asarray(lat), norm)
    got = tld.recalibrate_div(params_from_jax(params), torch.as_tensor(lat),
                              norm)
    _close(got['div'], want['div'], rtol=1e-6)
    w = torch.as_tensor(lat)
    assert tld.decoder_identity_apply({}, tld.DecoderIdentityConfig(), w) \
        is w


@pytest.mark.parametrize('layer_type', ['none', 'frobenius_norm', 'l_1_norm',
                                        'l_inf_norm', 'spectral_norm'])
def test_normalized_mlp_layers_match_jax(layer_type):
    kw = dict(input_dim=5, output_dim=3, hidden_dim=7, num_layers=2,
              activation='relu', layer_type=layer_type)
    jcfg, tcfg = jmlp.MLPConfig(**kw), tmlp.MLPConfig(**kw)
    params = _np(jmlp.mlp_init(jax.random.PRNGKey(3), jcfg))
    x = np.random.RandomState(0).randn(11, 5).astype(np.float32)
    want = jax.jit(lambda p: jmlp.mlp_apply(p, jcfg, jnp.asarray(x)))(
        params)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(
        jmlp.mlp_apply(p, jcfg, jnp.asarray(x)) ** 2)))(params)
    tp = params_from_jax(params)
    leaves = [t.requires_grad_(True)
              for _, t in toptim.tree_leaves_with_path(tp)]
    got = tmlp.mlp_apply(tp, tcfg, torch.as_tensor(x))
    _close(got, want)
    grads = torch.autograd.grad(torch.sum(got ** 2), leaves)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize('init', ['svd', 'spectral', 'identity',
                                  'orthonormal'])
def test_weight_inits_match_jax(init):
    w = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    got = tmlp.WEIGHT_INITS[init](torch.Generator().manual_seed(0),
                                  torch.as_tensor(w))
    if init == 'orthonormal':
        # random: orthonormal columns of the right shape
        np.testing.assert_allclose(got.t() @ got, np.eye(4), atol=1e-5)
        return
    want = jmlp.WEIGHT_INITS[init](jax.random.PRNGKey(0), jnp.asarray(w))
    _close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('act', ['sin', 'sine', 'fullsort', 'minmax',
                                 'softplus', 'lrelu'])
def test_activations_match_jax(act):
    x = np.random.RandomState(0).randn(5, 6).astype(np.float32)
    _close(tmlp.get_activation(act)(torch.as_tensor(x)),
           jmlp.get_activation(act)(jnp.asarray(x)))


@pytest.mark.parametrize('pos,final', [('none', 'sigmoid'),
                                       ('positional', 'none'),
                                       ('identity', 'relu')])
def test_image_field_and_its_tree_carry_across(pos, final):
    """The image pipeline's tree (``grid``, ``decoder_color``) converts and
    the port's field computes what the JAX field computes, on the fused,
    decoded and fresh-decode paths."""
    kw = dict(**GRID, ldecode_type='single')
    jg = jlg.LatentGridConfig.from_geometric(**kw).with_ldec(LDEC)
    tg = tlg.LatentGridConfig.from_geometric(**kw).with_ldec(LDEC)
    ncfg = dict(hidden_dim=8, final_activation=final, pos_embedder=pos,
                pos_multires=3)
    jcfg = jnef.NeuralImageConfig(grid=jg, **ncfg)
    tcfg = tnef.NeuralImageConfig(grid=tg, **ncfg)
    params = _np(jnef.neural_image_init(jax.random.PRNGKey(1), jcfg))
    tp = params_from_jax(params)
    assert set(tp) == {'grid', 'decoder_color'}
    coords = np.random.RandomState(0).uniform(-1, 1, (30, 2)).astype(
        np.float32)
    want = jax.jit(lambda p: jnef.neural_image_rgb(
        p, jcfg, jnp.asarray(coords)))(params)
    tc = torch.as_tensor(coords)
    _close(tnef.neural_image_rgb(tp, tcfg, tc), want)
    _close(tnef.neural_image_rgb(tp, tcfg, tc, decoded=tlg.decode_codebook(
        tp['grid'], tg)), want)
    _close(tnef.neural_image_rgb(tp, tcfg, tc, affine=tlg.affine_parts(
        tp['grid'], tg)), want)
    assert tnef.non_grid_size_bits(tp) == jnef.non_grid_size_bits(params)
