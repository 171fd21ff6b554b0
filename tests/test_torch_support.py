"""Port parity of the support modules: BitEstimatorN, the channel kit and
RenderBuffer, the counter registry, FiLM, SPCField,
RandomViewDataset, image processing, object transforms, framework state,
and the static-coordinate encode plan, each against the JAX package on the
same inputs (numpy, from a seed) and parameters (``params_from_jax``).

Tolerances: 1e-6 for the estimator, the channel kit, FiLM and the static
plan's forward (f32, one op order apart), 1e-6 of the largest value for the
plan's codebook gradient (sums of up to K terms); exact for the plan's
arrays, the numpy copies (image processing, transforms, random views) and
integer outputs."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.core import channel_fn as jcf  # noqa: E402
from shacira_tpu.core.renderbuffer import RenderBuffer as JRB  # noqa: E402
from shacira_tpu.models import prob_models as jpm  # noqa: E402
from shacira_tpu.ops import hashgrid as jhg  # noqa: E402
from shacira_tpu_torch.core import channel_fn as tcf  # noqa: E402
from shacira_tpu_torch.core.renderbuffer import RenderBuffer as TRB  # noqa
from shacira_tpu_torch.models import prob_models as tpm  # noqa: E402
from shacira_tpu_torch.ops import hashgrid as thg  # noqa: E402
from shacira_tpu_torch.utils.convert import params_from_jax  # noqa: E402


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_bit_estimator_n_matches_jax():
    jcfg = jpm.BitEstimatorNConfig(channels=3, width=4)
    tcfg = tpm.BitEstimatorNConfig(channels=3, width=4)
    jp = jpm.bit_estimator_n_init(jax.random.PRNGKey(0), jcfg)
    # scale the N(0, 0.01) draws up so the layers do real work
    jp = jax.tree.map(lambda v: v * 100.0, jp)
    tp = params_from_jax(_np_tree(jp))
    xs = np.linspace(-10, 10, 101, dtype=np.float32)[:, None].repeat(3, 1)
    want = np.asarray(jpm.bit_estimator_n_apply(jp, jcfg, jnp.asarray(xs)))
    got = tpm.bit_estimator_n_apply(tp, tcfg, torch.as_tensor(xs)).numpy()
    assert got.shape == (101, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got >= 0) and np.all(got <= 1)
    assert np.all(np.diff(got, axis=0) >= -1e-6)          # monotone CDF
    for k in range(3):
        one = tpm.bit_estimator_n_apply(tp, tcfg, torch.as_tensor(xs[:, k]),
                                        single_channel=k).numpy()
        jone = np.asarray(jpm.bit_estimator_n_apply(
            jp, jcfg, jnp.asarray(xs[:, k]), single_channel=k))
        np.testing.assert_allclose(one, jone, rtol=0, atol=1e-6)
        np.testing.assert_allclose(one, got[:, k], rtol=0, atol=1e-6)
    # the port's own init: the JAX layout and scales
    g = torch.Generator().manual_seed(0)
    own = tpm.bit_estimator_n_init(g, tcfg, 'cpu')
    assert jax.tree.structure(_np_tree(jp)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), own))
    assert float(own['f4']['b'].abs().max()) == 0.0
    assert 0.005 < float(own['f2']['m'].std()) < 0.02


def _buffers():
    """The arrays of tests/test_lifecycle.py::test_renderbuffer_channel_kit."""
    n = 8
    rng = np.random.RandomState(0)
    front = {
        'rgb': rng.rand(n, 3).astype(np.float32),
        'alpha': rng.rand(n, 1).astype(np.float32),
        'normal': rng.randn(n, 3).astype(np.float32),
        'hit': rng.rand(n, 1) > 0.5,
        'err': rng.rand(n, 1).astype(np.float32),
        'depth': rng.rand(n, 1).astype(np.float32),
    }
    back = {k: (rng.rand(*v.shape).astype(np.float32)
                if v.dtype != bool else rng.rand(*v.shape) > 0.5)
            for k, v in front.items()}
    return front, back


def test_renderbuffer_channel_kit_matches_jax():
    front, back = _buffers()
    jf = JRB({k: jnp.asarray(v) for k, v in front.items()})
    jb = JRB({k: jnp.asarray(v) for k, v in back.items()})
    tf = TRB({k: torch.as_tensor(v) for k, v in front.items()})
    tb = TRB({k: torch.as_tensor(v) for k, v in back.items()})
    jout, tout = jf.blend(jb), tf.blend(tb)
    assert set(tout.channels) == set(jout.channels)
    for k, v in tout.channels.items():
        want = np.asarray(jout.channels[k])
        if want.dtype == bool:
            np.testing.assert_array_equal(v.numpy(), want)
        else:
            np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=1e-6)
    # the JAX test's own checks, on the port's buffers
    expect = tcf.blend_alpha_composite_over(tf.rgb, tb.rgb, tf.alpha,
                                            tb.alpha)
    np.testing.assert_allclose(tout.rgb.numpy(), expect.numpy(), atol=1e-6)
    np.testing.assert_array_equal(tout.channels['hit'].numpy(),
                                  front['hit'] | back['hit'])
    np.testing.assert_array_equal(tout.channels['depth'].numpy(),
                                  front['depth'])
    norms = np.linalg.norm(tout.channels['normal'].numpy(), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    jdisp, tdisp = jout.normalized(), tout.normalized()
    for k, v in tdisp.channels.items():
        np.testing.assert_allclose(v.numpy().astype(np.float32),
                                   np.asarray(jdisp.channels[k], np.float32),
                                   rtol=0, atol=1e-6)
    assert float(tdisp.channels['err'].max()) <= 1.0 + 1e-6
    d, jd = tout.exr_dict(2, 4), jout.exr_dict(2, 4)
    assert d['rgb'].shape == (2, 4, 3) and d['depth'].shape == (2, 4, 1)
    for k in d:
        np.testing.assert_allclose(d[k], jd[k], rtol=0, atol=1e-6)
    # the JAX reshape_image fails on channels wider than 1 (its first
    # reshape drops the channel axis): compare on the 1-wide ones
    img = tout.reshape_image(2, 4)
    assert img['rgb'].shape == (2, 4, 3) and img['err'].shape == (2, 4, 1)
    narrow = ('alpha', 'err', 'depth')
    jimg = JRB({k: jout.channels[k] for k in narrow}).reshape_image(2, 4)
    for k in narrow:
        np.testing.assert_allclose(img[k], jimg[k], rtol=0, atol=1e-6)
    cat = TRB.cat([tf, tb])
    assert cat.rgb.shape == (16, 3)


@pytest.mark.parametrize('name', ['blend_linear', 'blend_alpha_lerp',
                                  'blend_alpha_slerp', 'blend_multiply',
                                  'blend_screen', 'blend_sub',
                                  'blend_logical_and'])
def test_blend_functions_match_jax(name):
    rng = np.random.RandomState(1)
    c1, c2 = rng.randn(16, 3).astype(np.float32), \
        rng.randn(16, 3).astype(np.float32)
    c2[0] = c1[0]                   # parallel: slerp's guarded branch
    c2[1] = -c1[1]                  # antiparallel
    a1, a2 = rng.rand(16, 1).astype(np.float32), \
        rng.rand(16, 1).astype(np.float32)
    want = np.asarray(getattr(jcf, name)(*map(jnp.asarray, (c1, c2, a1, a2))))
    got = getattr(tcf, name)(*map(torch.as_tensor, (c1, c2, a1, a2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_renderbuffer_save_exr_reads_back(tmp_path):
    from shacira_tpu_torch.ops.exr import read_exr
    front, _ = _buffers()
    buf = TRB({k: torch.as_tensor(v.astype(np.float32))
               for k, v in front.items()})
    path = str(tmp_path / 'b.exr')
    assert buf.save_exr(path, 2, 4)
    planes = read_exr(path)
    np.testing.assert_array_equal(planes['R'], front['rgb'][:, 0]
                                  .reshape(2, 4))
    np.testing.assert_array_equal(planes['normal.G'],
                                  front['normal'][:, 1].reshape(2, 4))
    np.testing.assert_array_equal(planes['depth'],
                                  front['depth'].reshape(2, 4))


def test_perf_timer_and_named_range():
    """``device_sync`` and the counter registry: host numbers always,
    device scalars only while a profiler records, one accumulator a name
    and the totals read once."""
    from shacira_tpu_torch.utils import perf
    x = torch.ones((8,)) * 2
    perf.device_sync(None)
    perf.device_sync({'x': [x]})
    perf.reset_counts()
    perf.count('host', 2)
    perf.count('host', 3)
    perf.count('dev', torch.sum(x).long())            # no profiler: dropped
    assert perf.counted('host') == 5.0 and perf.counted('dev') == 0.0
    assert perf._device == {} and not perf.tracing()
    with torch.profiler.profile():
        assert perf.tracing()
        perf.count('dev', torch.sum(x).long())
        perf.count('dev', torch.tensor(4))
        perf.count('dev_f', torch.tensor(0.5))
    assert perf.counted('dev') == 20.0 and perf.counted('dev_f') == 0.5
    assert perf._device['dev'].dtype == torch.int64
    assert perf.counts() == {'dev': 20.0, 'dev_f': 0.5, 'host': 5.0}
    perf.reset_counts()
    assert perf.counts() == {} and perf.counted('host') == 0.0


def test_film_conditioner_matches_jax():
    from shacira_tpu.models import conditioners as jc
    from shacira_tpu_torch.models import conditioners as tc
    jcfg, tcfg = jc.FiLMConfig(4, 8, 16), tc.FiLMConfig(4, 8, 16)
    jp = jc.film_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_np_tree(jp))
    rng = np.random.RandomState(2)
    feats = rng.randn(5, 8).astype(np.float32)
    cond = rng.randn(5, 4).astype(np.float32)
    want = np.asarray(jc.film_apply(jp, jcfg, jnp.asarray(feats),
                                    jnp.asarray(cond)))
    got = tc.film_apply(tp, tcfg, torch.as_tensor(feats),
                        torch.as_tensor(cond)).numpy()
    assert got.shape == (5, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    own = tc.film_init(torch.Generator().manual_seed(0), tcfg, 'cpu')
    assert [tuple(v.shape) for l in own['mlp']['layers'] for v in l.values()
            ] == [tuple(np.shape(v)) for l in jp['mlp']['layers']
                  for v in l.values()]


def test_spc_field_matches_jax():
    from shacira_tpu.models.nefs.spc_field import SPCField as JSPC
    from shacira_tpu.models.nefs.spc_field import SPCFieldConfig as JCfg
    from shacira_tpu_torch.models.nefs.spc_field import SPCField, \
        SPCFieldConfig
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32)
    cols = rng.rand(500, 3).astype(np.float32)
    jf = JSPC(JCfg(level=4), pts, cols)
    tf = SPCField(SPCFieldConfig(level=4), pts, cols, 'cpu')
    np.testing.assert_array_equal(tf.codes.numpy(), np.asarray(jf.codes))
    np.testing.assert_allclose(tf.colors.numpy(), np.asarray(jf.colors),
                               rtol=0, atol=1e-6)
    q = np.concatenate([pts[:50], rng.uniform(-1, 1, (50, 3))
                        .astype(np.float32), [[0.95, 0.95, 0.95]]])
    jrgb, jd = jf.rgba(jnp.asarray(q))
    trgb, td = tf.rgba(torch.as_tensor(q))
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert float(td[-1, 0]) == 0.0 and np.all(td[:50].numpy() > 0)
    np.testing.assert_array_equal(tf.occupancy_mask(), jf.occupancy_mask())


def test_random_view_dataset_matches_jax():
    from shacira_tpu.datasets.random_view import RandomViewDataset as JRV
    from shacira_tpu.render.offline import CameraConfig as JCam
    from shacira_tpu_torch.datasets.random_view import RandomViewDataset
    from shacira_tpu_torch.render.offline import CameraConfig
    kw = dict(width=6, height=5, fov=40.0)
    got = list(RandomViewDataset(3, 2.0, CameraConfig(**kw), seed=1))
    want = list(JRV(3, 2.0, JCam(**kw), seed=1))
    assert len(got) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(np.linalg.norm(g[2]), 2.0, rtol=1e-6)


def test_image_processing_matches_jax():
    from shacira_tpu.ops import image_processing as jip
    from shacira_tpu_torch.ops import image_processing as tip
    x = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    for fn in ('linear_to_srgb', 'srgb_to_linear'):
        np.testing.assert_array_equal(getattr(tip, fn)(x),
                                      getattr(jip, fn)(x))
    np.testing.assert_allclose(tip.srgb_to_linear(tip.linear_to_srgb(x)), x,
                               atol=1e-5)
    np.testing.assert_array_equal(tip.resize_mip(x, 2), jip.resize_mip(x, 2))
    ro = np.zeros((4, 3), np.float32)
    rd = np.tile(np.asarray([0, 0, 1.0], np.float32), (4, 1))
    depth = np.asarray([1.0, 2.0, 0.0, np.inf], np.float32)
    rgb = np.ones((4, 3), np.float32)
    for a, b in zip(tip.rgbd_to_pointcloud(rgb, depth, ro, rd),
                    jip.rgbd_to_pointcloud(rgb, depth, ro, rd)):
        np.testing.assert_array_equal(a, b)


def test_object_transform_matches_jax():
    from shacira_tpu.core.transforms import ObjectTransform as JT
    from shacira_tpu_torch.core.transforms import ObjectTransform
    t = ObjectTransform().scale(2.0).translate([1, 0, 0]).rotate('y', 0.3)
    j = JT().scale(2.0).translate([1, 0, 0]).rotate('y', 0.3)
    np.testing.assert_array_equal(t.m, j.m)
    p = np.asarray([[1.0, 1.0, 1.0]], np.float32)
    np.testing.assert_array_equal(t.apply_points(p), j.apply_points(p))
    np.testing.assert_array_equal(t.inverse().m, j.inverse().m)
    back = t.inverse().apply_points(t.apply_points(p))
    np.testing.assert_allclose(back, p, atol=1e-6)


def test_framework_state_watch():
    from shacira_tpu_torch.framework.state import WispState
    state = WispState()
    seen = []
    state.optimization.watch('epoch', lambda o, n, v: seen.append(v))
    state.optimization.epoch = 5
    state.optimization.epoch = 6
    assert seen == [5, 6]
    state.optimization.log(rgb_loss=0.5, psnr=30.0)
    assert state.optimization.losses['rgb_loss'] == [0.5]
    assert state.optimization.metrics['psnr'] == [30.0]
    state.graph.add('obj', object())
    assert 'obj' in state.graph.objects


@pytest.mark.parametrize('dim,res', [(2, (5, 9, 33)), (3, (4, 7, 17))])
def test_static_plan_matches_jax_and_the_dynamic_encode(dim, res):
    jspec, tspec = jhg.HashGridSpec(res, 6, dim), thg.HashGridSpec(res, 6, dim)
    rng = np.random.RandomState(3)
    coords = rng.uniform(-1, 1, (200, dim)).astype(np.float32)
    cb = rng.randn(tspec.total_size, 2).astype(np.float32)
    jmeta, jarr = jhg.build_static_plan(coords, jspec)
    tmeta, tarr = thg.build_static_plan(coords, tspec, 'cpu')
    assert tmeta.bucket_ks == jmeta.bucket_ks
    assert tmeta.num_coords == jmeta.num_coords == 200
    for key in ('idx', 'w', 'src', 'srcw'):
        for lod in range(len(res)):
            want = np.asarray(jarr[key][lod])
            got = tarr[key][lod].numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    jarr = jax.tree.map(jnp.asarray, jarr)

    def jloss(c):
        return jnp.sum(jnp.sin(jhg.static_hash_encode(jarr, c, jmeta)))
    want_out = np.asarray(jhg.static_hash_encode(jarr, jnp.asarray(cb),
                                                 jmeta))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(cb)))
    t_cb = torch.as_tensor(cb).requires_grad_(True)
    out = thg.static_hash_encode(tarr, t_cb, tmeta)
    (g,) = torch.autograd.grad(torch.sum(torch.sin(out)), t_cb)
    # a row's gradient sums up to K contributions in another order on
    # each side: 1e-6 of the largest value
    gtol = 1e-6 * float(np.abs(want_g).max())
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=0, atol=gtol)
    d_cb = torch.as_tensor(cb).requires_grad_(True)
    dyn = thg.hash_encode(torch.as_tensor(coords), d_cb, tspec)
    (dg,) = torch.autograd.grad(torch.sum(torch.sin(dyn)), d_cb)
    np.testing.assert_allclose(out.detach().numpy(), dyn.detach().numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), dg.numpy(), rtol=0, atol=gtol)


def test_static_plan_through_latent_grid_and_image_field():
    from shacira_tpu.models.grids import latent_grid as jlg
    from shacira_tpu.models.nefs import image as jimage
    from shacira_tpu_torch.models.grids import latent_grid as tlg
    from shacira_tpu_torch.models.nefs import image as timage
    kw = dict(feature_dim=2, num_lods=3, min_grid_res=4, max_grid_res=16,
              latent_dim=1, multiscale_type='cat', resolution_dim=2,
              feature_std=0.5, codebook_bitwidth=6, init_grid='normal')
    ldec = dict(norm='none', ldecode_matrix='sq', use_shift=True,
                ldec_std=0.1)
    jgrid = jlg.LatentGridConfig.from_geometric(**kw).with_ldec(ldec)
    tgrid = tlg.LatentGridConfig.from_geometric(**kw).with_ldec(ldec)
    jcfg = jimage.NeuralImageConfig(grid=jgrid, hidden_dim=8, num_layers=1)
    tcfg = timage.NeuralImageConfig(grid=tgrid, hidden_dim=8, num_layers=1)
    jp = jimage.neural_image_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_np_tree(jp))
    coords = np.random.RandomState(4).uniform(-1, 1, (64, 2)).astype(
        np.float32)
    jplan = jhg.build_static_plan(coords, jgrid.spec)
    jplan = (jplan[0], jax.tree.map(jnp.asarray, jplan[1]))
    tplan = thg.build_static_plan(coords, tgrid.spec, 'cpu')
    want = np.asarray(jimage.neural_image_rgb(jp, jcfg, jnp.asarray(coords),
                                              static_plan=jplan))
    got = timage.neural_image_rgb(tp, tcfg, torch.as_tensor(coords),
                                  static_plan=tplan)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    dyn = tlg.interpolate(tp['grid'], tgrid, torch.as_tensor(coords))
    via_plan = tlg.interpolate(tp['grid'], tgrid, torch.as_tensor(coords),
                               static_plan=tplan)
    np.testing.assert_allclose(via_plan.detach().numpy(),
                               dyn.detach().numpy(), rtol=0, atol=1e-6)
