"""Port parity: the alternative grid backbones of shacira_tpu_torch (NGLOD's
octree grid, VQAD's codebook octree grid, the triplanar grid) and the
``--grid-type`` dispatch of the config reader, against the JAX package.

The JAX-initialized params go across through ``params_from_jax``.
Tolerances: values and gradients within 1e-5 relative (to the largest
magnitude) of ``jax.grad``; the octree structure, VQAD's eval-mode indices
and the size report's bits are equal."""
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shacira_tpu import config as jconfig
from shacira_tpu.models.grids import octree_grid as jog
from shacira_tpu.models.grids import triplanar_grid as jtg
from shacira_tpu_torch import config as tconfig
from shacira_tpu_torch.models.grids import octree_grid as og
from shacira_tpu_torch.models.grids import triplanar_grid as tg
from shacira_tpu_torch.ops import spc
from shacira_tpu_torch.utils.convert import params_from_jax

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * scale)


def _coords(seed, n, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def _structures(cfg, sparse: bool):
    if not sparse:
        return (og.OctreeStructure.make_dense(cfg),
                jog.OctreeStructure.make_dense(cfg))
    pts = (np.random.RandomState(7).randn(40, 3) * 0.25).clip(-1, 1)
    pts = pts.astype(np.float32)
    return (og.OctreeStructure.from_pointcloud(cfg, pts, dilate=1),
            jog.OctreeStructure.from_pointcloud(cfg, pts, dilate=1))


def _grads(tree):
    return [t.grad.numpy() for t in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]


def _leaf_params(jparams):
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    for t in jax.tree_util.tree_leaves(
            params, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        t.requires_grad_(True)
    return params


@pytest.mark.parametrize('sparse', [False, True])
def test_octree_structure_tables_equal_jax(sparse):
    cfg = og.OctreeGridConfig(feature_dim=2, base_lod=2, num_lods=3)
    st, jst = _structures(cfg, sparse)
    assert st.num_corners == jst.num_corners
    tables, jtables = st.tables(), jst.tables()
    for key in ('codes', 'trinkets'):
        for got, want in zip(tables[key], jtables[key]):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want).astype(
                                              got.numpy().dtype))


@pytest.mark.parametrize('ms', ['sum', 'cat'])
@pytest.mark.parametrize('sparse', [False, True])
def test_octree_interpolate_and_grad_match_jax(ms, sparse):
    kw = dict(feature_dim=3, base_lod=2, num_lods=3, multiscale_type=ms,
              feature_std=0.3, feature_bias=0.1)
    cfg, jcfg = og.OctreeGridConfig(**kw), jog.OctreeGridConfig(**kw)
    st, jst = _structures(cfg, sparse)
    jparams = jog.octree_grid_init(jax.random.PRNGKey(0), jcfg, jst)
    coords = _coords(1, 300, -1.05, 1.05)
    cot = np.random.RandomState(2).randn(300, cfg.output_dim).astype(
        np.float32)

    def jloss(p):
        out = jog.interpolate(p, jcfg, jst.tables(), jnp.asarray(coords))
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = _leaf_params(jparams)
    out = og.interpolate(params, cfg, st, torch.as_tensor(coords))
    _close(out.detach().numpy(), jout)
    if sparse:       # points outside the octree give zeros in both
        zero = np.all(np.asarray(jout) == 0, axis=-1)
        assert zero.any() and (out.detach().numpy()[zero] == 0).all()
    torch.sum(out * torch.as_tensor(cot)).backward()
    for got, want in zip(_grads(params), jax.tree_util.tree_leaves(jgrad)):
        _close(got, want)


@pytest.mark.parametrize('sparse', [False, True])
def test_codebook_train_forward_grads_and_eval_match_jax(sparse):
    kw = dict(feature_dim=3, base_lod=2, num_lods=2, multiscale_type='sum',
              feature_std=0.5, codebook_bitwidth=3)
    cfg = og.CodebookOctreeGridConfig(**kw)
    jcfg = jog.CodebookOctreeGridConfig(**kw)
    st, jst = _structures(cfg, sparse)
    jparams = jog.codebook_grid_init(jax.random.PRNGKey(3), jcfg, jst)
    coords = _coords(4, 256, -0.9, 0.9)
    cot = np.random.RandomState(5).randn(256, 3).astype(np.float32)

    def jloss(p):
        out = jog.codebook_interpolate(p, jcfg, jst.tables(),
                                       jnp.asarray(coords), training=True)
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = _leaf_params(jparams)
    out = og.codebook_interpolate(params, cfg, st, torch.as_tensor(coords),
                                  training=True)
    _close(out.detach().numpy(), jout)
    torch.sum(out * torch.as_tensor(cot)).backward()
    grads = {k: [t.grad.numpy() for t in params[k]]
             for k in ('logits', 'dictionary')}
    for k in grads:
        for got, want in zip(grads[k], jgrad[k]):
            assert np.abs(np.asarray(want)).max() > 0
            _close(got, want)
    # eval mode: the argmax lookup; its indices are equal, the blended
    # features within the tolerance (sums in another order)
    with torch.no_grad():
        ev = og.codebook_interpolate(params, cfg, st.tables(),
                                     torch.as_tensor(coords), training=False)
    jev = jog.codebook_interpolate(jparams, jcfg, jst, jnp.asarray(coords),
                                   training=False)
    _close(ev.numpy(), jev)
    for got, l in zip(og.codebook_indices(params), jparams['logits']):
        np.testing.assert_array_equal(got, np.asarray(jnp.argmax(l, -1)))


def test_codebook_eval_takes_the_first_maximum():
    cfg = og.CodebookOctreeGridConfig(feature_dim=1, base_lod=1, num_lods=1,
                                      codebook_bitwidth=2)
    st = og.OctreeStructure.make_dense(cfg)
    n = st.num_corners[1]
    logits = torch.zeros((n, 4))
    logits[:, 1] = logits[:, 3] = 1.0           # ties: index 1 wins
    params = {'logits': [logits],
              'dictionary': [torch.arange(4.0)[:, None]]}
    out = og.codebook_interpolate(params, cfg, st, torch.zeros((2, 3)),
                                  training=False)
    np.testing.assert_array_equal(out.numpy(), 1.0)
    assert (og.codebook_indices(params)[0] == 1).all()


@pytest.mark.parametrize('use_codec', [False, True])
def test_codebook_size_bits_equal_jax(use_codec):
    kw = dict(feature_dim=2, base_lod=2, num_lods=2, feature_std=0.5,
              codebook_bitwidth=3)
    jcfg = jog.CodebookOctreeGridConfig(**kw)
    jst = jog.OctreeStructure.make_dense(jcfg)
    jparams = jog.codebook_grid_init(jax.random.PRNGKey(6), jcfg, jst)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    got = og.codebook_grid_size_bits(params, use_codec=use_codec)
    want = jog.codebook_grid_size_bits(jparams, use_codec=use_codec)
    assert got[0] == want[0] == 0.0
    assert got[1] == pytest.approx(want[1], rel=1e-12)
    ocfg = jog.OctreeGridConfig(feature_dim=5, base_lod=2, num_lods=2)
    op = jog.octree_grid_init(jax.random.PRNGKey(0), ocfg, jst)
    assert og.grid_size_bits(params_from_jax(jax.tree.map(
        np.asarray, op))) == jog.grid_size_bits(op)


@pytest.mark.parametrize('ms', ['sum', 'cat'])
def test_triplanar_value_and_grads_match_jax(ms):
    kw = dict(feature_dim=2, base_lod=1, num_lods=3, multiscale_type=ms,
              feature_std=0.3, feature_bias=0.05)
    cfg, jcfg = tg.TriplanarGridConfig(**kw), jtg.TriplanarGridConfig(**kw)
    jparams = jtg.triplanar_grid_init(jax.random.PRNGKey(8), jcfg)
    coords = _coords(9, 400, -1.1, 1.1)
    cot = np.random.RandomState(10).randn(400, cfg.output_dim).astype(
        np.float32)

    def jloss(p):
        out = jtg.interpolate(p, jcfg, jnp.asarray(coords))
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = _leaf_params(jparams)
    out = tg.interpolate(params, cfg, torch.as_tensor(coords))
    assert tuple(out.shape) == (400, cfg.output_dim)
    _close(out.detach().numpy(), jout)
    torch.sum(out * torch.as_tensor(cot)).backward()
    for got, want in zip(_grads(params), jax.tree_util.tree_leaves(jgrad)):
        _close(got, want)
    assert tg.grid_size_bits(params) == jtg.grid_size_bits(jparams)


def test_triplanar_is_exact_at_grid_points():
    cfg = tg.TriplanarGridConfig(feature_dim=1, base_lod=2, num_lods=1)
    s = 5
    plane = torch.arange(s * s, dtype=torch.float32).reshape(s, s, 1)
    params = {'planes': [{'yz': plane, 'xz': plane * 0, 'xy': plane * 0}]}
    g = np.linspace(-1, 1, s, dtype=np.float32)
    yy, zz = np.meshgrid(g, g, indexing='ij')
    coords = np.stack([np.zeros_like(yy), yy, zz], -1).reshape(-1, 3)
    out = tg.interpolate(params, cfg, torch.as_tensor(coords))
    np.testing.assert_array_equal(out[:, 0].numpy(), np.arange(s * s))
    jout = jtg.interpolate({'planes': [{k: jnp.asarray(v.numpy()) for k, v
                                        in params['planes'][0].items()}]},
                           jtg.TriplanarGridConfig(**cfg.__dict__),
                           jnp.asarray(coords))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def _args(pkg, grid_type, *extra):
    parser = (pkg.build_nerf_parser() if pkg is tconfig
              else pkg.add_nerf_args(pkg.build_image_parser()))
    return pkg.parse_args(parser, [
        '--grid-type', grid_type, '--feature-dim', '2',
        '--feature-std', '0.05', '--base-lod', '3', '--num-lods', '3',
        '--min-grid-res', '4', '--max-grid-res', '16',
        '--codebook-bitwidth', '6', *extra])


@pytest.mark.parametrize('grid_type,extra', [
    ('LatentGrid', ()), ('LatentGrid', ('--tree-type', 'octree')),
    ('HashGrid', ('--ldecode-enabled', 'true', '--latent-dim', '1')),
    ('HashGrid', ('--tree-type', 'octree')),
    ('OctreeGrid', ('--multiscale-type', 'cat')),
    ('CodebookOctreeGrid', ()), ('TriplanarGrid', ())])
def test_build_grid_config_matches_jax(grid_type, extra):
    got = tconfig.build_grid_config(_args(tconfig, grid_type, *extra), 3)
    want = jconfig.build_grid_config(_args(jconfig, grid_type, *extra), 3)
    assert type(got).__name__ == type(want).__name__
    for f in fields(got):
        if f.name == 'ldec':
            assert (got.ldec is None) == (want.ldec is None)
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.output_dim == want.output_dim
    if grid_type == 'HashGrid':
        assert got.ldec is None and got.latent_dim == 0
        assert got.effective_latent_dim == got.feature_dim
    if '--tree-type' in extra:
        assert got.resolutions == (8, 16, 32) == want.resolutions


@pytest.mark.parametrize('grid_type', ['OctreeGrid', 'CodebookOctreeGrid',
                                       'TriplanarGrid'])
def test_3d_only_backbones_refuse_2d_as_jax(grid_type):
    for pkg in (tconfig, jconfig):
        with pytest.raises(ValueError, match='3D-only'):
            pkg.build_grid_config(_args(pkg, grid_type), 2)


def test_unknown_grid_type_raises_value_error_as_jax():
    for pkg in (tconfig, jconfig):
        with pytest.raises(ValueError, match='Unknown grid_type'):
            pkg.build_grid_config(_args(pkg, 'NoSuchGrid'), 3)


def test_octree_structure_from_spc_checks_its_depth():
    cfg = og.OctreeGridConfig(feature_dim=2, base_lod=2, num_lods=2)
    st = og.OctreeStructure.from_spc(cfg, spc.Octree.make_dense(4))
    assert st.num_corners[3] == 9 ** 3
    with pytest.raises(ValueError, match='max_level'):
        og.OctreeStructure.from_spc(cfg, spc.Octree.make_dense(2))
