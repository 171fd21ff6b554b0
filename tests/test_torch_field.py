"""Port parity: quantizers, entropy model, MLP, the NeRF field, pruning and
the JAX -> torch parameter conversion.

Inputs (and every random draw) come from numpy seeds or are drawn by JAX
and handed to the port.  f32 paths agree to rtol 1e-5 (forward) and 1e-4
(gradients); the bf16 head to 2e-2 absolute on sigmoid colours and 3e-2 on
densities near 1 (bf16 keeps 8 bits of mantissa and rounds at per-layer
casts that XLA and PyTorch may fuse differently)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.models import latent_decoders as jld  # noqa: E402
from shacira_tpu.models import mlp as jmlp  # noqa: E402
from shacira_tpu.models import prob_models as jpm  # noqa: E402
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.nefs import nerf as jnerf  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.models import latent_decoders as tld  # noqa: E402
from shacira_tpu_torch.models import mlp as tmlp  # noqa: E402
from shacira_tpu_torch.models import prob_models as tpm  # noqa: E402
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.nefs import nerf as tnerf  # noqa: E402
from shacira_tpu_torch.utils.convert import params_from_jax  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_ste_round_value_and_identity_grad():
    x = torch.tensor([-1.5, -0.5, 0.2, 0.5, 1.5, 2.5], requires_grad=True)
    y = tld.ste_round(x)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jld.ste_round(jnp.asarray(
            x.detach().numpy()))))
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_array_equal(g.numpy(), np.ones(6, np.float32))


@pytest.mark.parametrize('diff_sampling', [True, False])
def test_sga_quantize_with_injected_uniforms(diff_sampling):
    rng = np.random.RandomState(0)
    x = (rng.randn(500, 1) * 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    temp = 0.7
    # the uniforms JAX draws inside sga_quantize, handed to the port
    u = np.asarray(jax.random.uniform(key, x.shape, dtype=jnp.float32,
                                      minval=TINY, maxval=1.0))
    ct = rng.randn(*x.shape).astype(np.float32)
    want = np.asarray(jld.sga_quantize(jnp.asarray(x), temp, key,
                                       diff_sampling))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jld.sga_quantize(
        v, temp, key, diff_sampling) * ct))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = tld.sga_quantize(xt, temp, torch.tensor(u), diff_sampling)
    (got_g,) = torch.autograd.grad(torch.sum(got * torch.as_tensor(ct)), xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-4, atol=1e-5)


def test_entropy_bits_and_grads_match_jax():
    cfg_j = jpm.BitEstimatorConfig(2, num_layers=4)
    cfg_t = tpm.BitEstimatorConfig(2, num_layers=4)
    params = _np_tree(jpm.bit_estimator_init(jax.random.PRNGKey(1), cfg_j))
    # larger parameters than the N(0, .01) init exercise every term
    params = jax.tree.map(lambda a: a * 40.0, params)
    w = (np.random.RandomState(1).randn(400, 2) * 4).astype(np.float32)
    want = float(jpm.entropy_bits(params, cfg_j, jnp.asarray(w)))
    want_g = np.asarray(jax.grad(lambda v: jpm.entropy_bits(
        params, cfg_j, v))(jnp.asarray(w)))
    tparams = params_from_jax(params)
    wt = torch.tensor(w, requires_grad=True)
    got = tpm.entropy_bits(tparams, cfg_t, wt)
    (got_g,) = torch.autograd.grad(got, wt)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('kw', [
    dict(ldecode_matrix='sq', use_shift=True),
    dict(ldecode_matrix='dft', use_shift=False),
    dict(num_layers_dec=1, hidden_dim_dec=6, activation='tanh',
         final_activation='sigmoid', clamp_weights=0.7)])
@pytest.mark.parametrize('use_sga', [False, True])
def test_latent_decoder_apply_matches_jax(kw, use_sga):
    cfg_j = jld.LatentDecoderConfig(latent_dim=2, feature_dim=4,
                                    ldec_std=0.5, diff_sampling=True, **kw)
    cfg_t = tld.LatentDecoderConfig(latent_dim=2, feature_dim=4,
                                    ldec_std=0.5, diff_sampling=True, **kw)
    params = _np_tree(jld.latent_decoder_init(jax.random.PRNGKey(3), cfg_j))
    params['div'] = np.asarray([1.5, 0.5], np.float32)
    w = (np.random.RandomState(3).randn(300, 2) * 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    u = np.array(jax.random.uniform(key, w.shape, dtype=jnp.float32,
                                    minval=TINY, maxval=1.0))
    want = np.asarray(jld.latent_decoder_apply(
        params, cfg_j, jnp.asarray(w), use_sga=use_sga, temperature=0.6,
        rng=key))
    got = tld.latent_decoder_apply(
        params_from_jax(params), cfg_t, torch.as_tensor(w), use_sga=use_sga,
        temperature=0.6, sga_u=torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert tld.latent_decoder_is_affine(cfg_t) == jld.latent_decoder_is_affine(
        cfg_j)


@pytest.mark.parametrize('skip', [(), (1,)])
def test_mlp_apply_matches_jax_and_init_is_torch_default(skip):
    cfg_j = jmlp.MLPConfig(7, 3, hidden_dim=16, num_layers=2, skip=skip)
    cfg_t = tmlp.MLPConfig(7, 3, hidden_dim=16, num_layers=2, skip=skip)
    params = _np_tree(jmlp.mlp_init(jax.random.PRNGKey(2), cfg_j))
    x = np.random.RandomState(2).randn(50, 7).astype(np.float32)
    want = np.asarray(jmlp.mlp_apply(params, cfg_j, jnp.asarray(x)))
    got = tmlp.mlp_apply(params_from_jax(params), cfg_t, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    init = tmlp.mlp_init(gen, cfg_t, 'cpu')
    for (din, dout), layer in zip(cfg_t.layer_dims(), init['layers']):
        assert tuple(layer['w'].shape) == (din, dout)
        assert float(layer['w'].abs().max()) <= 1.0 / np.sqrt(din)


def _nerf_cfgs(amp=False, min_density=2.956):
    grid_kw = dict(feature_dim=2, num_lods=3, min_grid_res=4, max_grid_res=20,
                   latent_dim=1, multiscale_type='cat', feature_std=0.5,
                   codebook_bitwidth=9, entropy_enabled=True,
                   num_prob_layers=1)
    ldec = dict(ldec_std=0.5, use_shift=True, use_sga=True,
                diff_sampling=True)
    nerf_kw = dict(hidden_dim=16, view_embedder='positional', blas_level=3,
                   amp=amp, prune_min_density=min_density)
    j = jnerf.NeuralRadianceFieldConfig(
        grid=jlg.LatentGridConfig.from_geometric(**grid_kw).with_ldec(ldec),
        **nerf_kw)
    t = tnerf.NeuralRadianceFieldConfig(
        grid=tlg.LatentGridConfig.from_geometric(**grid_kw).with_ldec(ldec),
        **nerf_kw)
    return j, t


def _field_inputs(seed, n=200):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return coords, dirs


def test_params_from_jax_keeps_tree_and_values():
    jcfg, _ = _nerf_cfgs()
    params = _np_tree(jnerf.nerf_init(jax.random.PRNGKey(3), jcfg))
    tparams = params_from_jax(params)
    jl = jax.tree_util.tree_leaves_with_path(params)
    assert len(jl) == len(jax.tree_util.tree_leaves(tparams))
    for path, leaf in jl:
        node = tparams
        for k in path:
            node = node[k.key if hasattr(k, 'key') else k.idx]
        np.testing.assert_array_equal(node.numpy(), leaf)
    # density output bias 1.0, as nerf_init sets it in both packages
    assert float(tparams['decoder_density']['layers'][-1]['b'][0]) == 1.0
    gen = torch.Generator().manual_seed(0)
    _, tcfg = _nerf_cfgs()
    own = tnerf.nerf_init(gen, tcfg, 'cpu')
    assert float(own['decoder_density']['layers'][-1]['b'][0]) == 1.0
    assert own['grid']['codebook'].shape == tparams['grid']['codebook'].shape


@pytest.mark.parametrize('path', ['affine', 'decoded'])
def test_nerf_rgba_matches_jax_f32(path):
    jcfg, tcfg = _nerf_cfgs()
    params = _np_tree(jnerf.nerf_init(jax.random.PRNGKey(4), jcfg))
    tparams = params_from_jax(params)
    coords, dirs = _field_inputs(4)
    if path == 'affine':
        jkw = {'affine': jlg.affine_parts(params['grid'], jcfg.grid)}
        tkw = {'affine': tlg.affine_parts(tparams['grid'], tcfg.grid)}
    else:
        jkw = {'decoded': jlg.decode_codebook(params['grid'], jcfg.grid)}
        tkw = {'decoded': tlg.decode_codebook(tparams['grid'], tcfg.grid)}
    jrgb, jd = jnerf.nerf_rgba(params, jcfg, jnp.asarray(coords),
                               jnp.asarray(dirs), **jkw)
    trgb, td = tnerf.nerf_rgba(tparams, tcfg, torch.as_tensor(coords),
                               torch.as_tensor(dirs), **tkw)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


def test_nerf_head_bf16_matches_jax():
    jcfg, tcfg = _nerf_cfgs(amp=True)
    params = _np_tree(jnerf.nerf_init(jax.random.PRNGKey(5), jcfg))
    tparams = params_from_jax(params)
    coords, dirs = _field_inputs(5)
    feats = np.random.RandomState(5).randn(
        coords.shape[0], jcfg.grid.output_dim).astype(np.float32)
    jrgb, jd = jnerf.nerf_head(params, jcfg, jnp.asarray(feats),
                               jnp.asarray(dirs))
    trgb, td = tnerf.nerf_head(tparams, tcfg, torch.as_tensor(feats),
                               torch.as_tensor(dirs))
    assert trgb.dtype == torch.float32 and td.dtype == torch.float32
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), atol=2e-2)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=3e-2)


def test_ent_loss_matches_jax():
    jcfg, tcfg = _nerf_cfgs()
    params = _np_tree(jnerf.nerf_init(jax.random.PRNGKey(6), jcfg))
    noise = (np.random.RandomState(6).rand(
        *params['grid']['codebook'].shape) - 0.5).astype(np.float32)
    tparams = params_from_jax(params)
    for is_val in (False, True):
        want = jlg.ent_loss(params['grid'], jcfg.grid, jnp.asarray(noise),
                            is_val=is_val)
        got = tlg.ent_loss(tparams['grid'], tcfg.grid, torch.as_tensor(noise),
                           is_val=is_val)
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)


def test_prune_with_injected_points_matches_jax():
    jcfg, tcfg = _nerf_cfgs(min_density=1.0)
    params = _np_tree(jnerf.nerf_init(jax.random.PRNGKey(8), jcfg))
    key = jax.random.PRNGKey(9)
    n = jcfg.occ_cfg.num_cells
    # the cell jitter JAX draws inside cell_centers_jittered
    u = np.array(jax.random.uniform(key, (n, 3)))
    state_j = jocc.occupancy_init(jcfg.occ_cfg)
    state_j = {**state_j, 'density': jnp.full_like(state_j['density'], 0.5)}
    want = jnerf.prune(params, jcfg, state_j, key)
    state_t = {k: torch.tensor(np.asarray(v)) for k, v in state_j.items()}
    got = tnerf.prune(params_from_jax(params), tcfg, state_t,
                      torch.as_tensor(u))
    wd = np.asarray(want['density'])
    np.testing.assert_allclose(got['density'].numpy(), wd, rtol=1e-5,
                               atol=1e-6)
    clear = np.abs(wd - 1.0) > 1e-4
    assert 0 < np.asarray(want['occ']).sum() < n
    np.testing.assert_array_equal(got['occ'].numpy()[clear],
                                  np.asarray(want['occ'])[clear])


def test_prune_keeps_occupancy_when_nothing_survives():
    cfg = tocc.OccupancyGridConfig(level=2)
    state = tocc.occupancy_init(cfg, 'cpu')
    new = tocc.prune_update(state, cfg, torch.zeros(cfg.num_cells),
                            density_decay=0.6, min_density=1.0)
    assert bool(new['occ'].all())
