"""Port parity for SDF rendering: the sphere tracer, its normals and the
matcap and shadow shaders, against shacira_tpu.tracers.sdf_tracer and
shacira_tpu.render.shaders (the tests of tests/test_shaders.py and the
tracer and render tests of tests/test_sdf.py, each on the port and
compared with the JAX package).

Tolerances: hit masks equal; depths and normals within 1e-4; shader
outputs within 1e-5; renders of ``SDFTrainer.render`` within 1e-4.  The
normals are autodiff gradients of the field in both packages: neither
package's hash-grid encode has a gradient with respect to the
coordinates, so both hold the MLP's raw-position path alone."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.datasets import sdf as jds  # noqa: E402
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.nefs import sdf as jsdf  # noqa: E402
from shacira_tpu.render import shaders as jshaders  # noqa: E402
from shacira_tpu.tracers import sdf_tracer as jtracer  # noqa: E402
from shacira_tpu.trainers import sdf_trainer as jst  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays as tmake_rays  # noqa: E402
from shacira_tpu_torch.datasets import sdf as tds  # noqa: E402
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.nefs import sdf as tsdf  # noqa: E402
from shacira_tpu_torch.ops.differential import autodiff_gradient  # noqa: E402
from shacira_tpu_torch.render import offline  # noqa: E402
from shacira_tpu_torch.render import shaders as tshaders  # noqa: E402
from shacira_tpu_torch.tracers import sdf_tracer as ttracer  # noqa: E402
from shacira_tpu_torch.trainers import sdf_trainer as tst  # noqa: E402
from shacira_tpu_torch.utils.convert import params_from_jax  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers share the machine's cores, and OpenMP regions over small
    tensors stall when their threads outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sphere_sdf(p, r=0.5):
    return (np.linalg.norm(np.asarray(p), axis=-1, keepdims=True)
            - r).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _both_rays(o, d, dmin=0.0, dmax=5.0):
    return (jmake_rays(o, d, dmin, dmax),
            tmake_rays(_t(np.asarray(o, np.float32)),
                       _t(np.asarray(d, np.float32)), dmin, dmax))


def _camera_rays(res=24, origin=(-1.8, 1.2, -1.8)):
    cam = offline.CameraConfig(width=res, height=res)
    return offline.lookat_rays(origin, (0.0, 0.0, 0.0), cam)


def _assert_traces_equal(got, want, atol=1e-4):
    np.testing.assert_array_equal(got['hit'].numpy(), np.asarray(want['hit']))
    for k in ('depth', 'xyz', 'normal', 'rgb', 'alpha'):
        if k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=atol, err_msg=k)


# --- tests/test_sdf.py's tracer tests on the port -------------------------

def test_sphere_trace_analytic():
    cfg = tocc.OccupancyGridConfig(level=3)
    state = tocc.occupancy_init(cfg, 'cpu')
    rays = tmake_rays(torch.tensor([[0, 0, -2.0], [0, 1.5, -2.0]]),
                      torch.tensor([[0, 0, 1.0], [0, 0, 1.0]]), 0.0, 5.0)

    def sdf_fn(x):
        return torch.linalg.norm(x, dim=-1, keepdim=True) - 0.5

    out = ttracer.trace(sdf_fn, state, cfg,
                        ttracer.SDFTracerConfig(num_steps=64), rays)
    hit = out['hit'].numpy()
    assert hit[0] and not hit[1]            # center ray hits, offset misses
    np.testing.assert_allclose(float(out['depth'][0, 0]), 1.5, atol=5e-3)


def _sphere_cells(cfg):
    ii = np.stack(np.meshgrid(*[np.arange(cfg.res)] * 3, indexing='ij'), -1)
    centers = ((ii + 0.5) / cfg.res) * 2 - 1
    return np.linalg.norm(centers, axis=-1) < 0.75


def test_sphere_trace_skips_empty_cells():
    cfg = tocc.OccupancyGridConfig(level=4)
    state = tocc.occupancy_init(cfg, 'cpu')
    state['occ'] = _t(_sphere_cells(cfg))
    rays = tmake_rays(torch.tensor([[0, 0, -2.0]]),
                      torch.tensor([[0, 0, 1.0]]), 0.0, 5.0)

    def sdf_fn(x):
        return torch.linalg.norm(x, dim=-1, keepdim=True) - 0.5

    out = ttracer.trace(sdf_fn, state, cfg,
                        ttracer.SDFTracerConfig(num_steps=64), rays)
    assert bool(out['hit'][0])
    np.testing.assert_allclose(float(out['depth'][0, 0]), 1.5, atol=5e-3)


@pytest.mark.parametrize('skip', [False, True], ids=['all-occupied',
                                                     'sphere-cells'])
def test_trace_and_normals_of_an_analytic_sphere_match_jax(skip):
    """Camera rays (some missing the box, some grazing the sphere) plus
    axis-aligned rays with zero direction components: hit masks equal,
    depth, hit points and normals within 1e-4."""
    ro, rd = _camera_rays(32, origin=(0.3, 0.2, -2.2))
    ro = np.concatenate([ro, [[0, 0, -2.0], [0.2, 0.1, 3.0]]]).astype(
        np.float32)
    rd = np.concatenate([rd, [[0, 0, 1.0], [0, 0, -1.0]]]).astype(np.float32)
    jrays, trays = _both_rays(ro, rd, 0.0, 6.0)
    jcfg, tcfg = jocc.OccupancyGridConfig(level=4), \
        tocc.OccupancyGridConfig(level=4)
    jstate, tstate = jocc.occupancy_init(jcfg), tocc.occupancy_init(tcfg,
                                                                    'cpu')
    if skip:
        occ = _sphere_cells(tcfg)
        jstate = {**jstate, 'occ': jnp.asarray(occ)}
        tstate['occ'] = _t(occ)
    want = jtracer.trace(
        lambda x: jnp.linalg.norm(x, axis=-1, keepdims=True) - 0.5, jstate,
        jcfg, jtracer.SDFTracerConfig(num_steps=64), jrays)
    want = jtracer.shade_normals(
        jax.vmap(jax.grad(lambda c: jnp.linalg.norm(c) - 0.5)), want)

    def sdf_fn(x):
        return torch.linalg.norm(x, dim=-1, keepdim=True) - 0.5

    got = ttracer.trace(sdf_fn, tstate, tcfg,
                        ttracer.SDFTracerConfig(num_steps=64), trays)
    got = ttracer.shade_normals(lambda x: autodiff_gradient(sdf_fn, x), got)
    assert 0 < got['hit'].sum() < len(ro)
    _assert_traces_equal(got, want)


# --- a small trained field ------------------------------------------------

def _grid(mod):
    return mod.LatentGridConfig.from_geometric(
        feature_dim=2, num_lods=4, min_grid_res=4, max_grid_res=32,
        latent_dim=0, multiscale_type='cat', resolution_dim=3,
        feature_std=0.01, codebook_bitwidth=8, init_grid='normal')


@pytest.fixture(scope='module')
def trained():
    """tests/test_sdf.py's render-test field, trained 200 steps by the JAX
    trainer; a port trainer holding the same parameters."""
    rng = np.random.RandomState(0)
    surf = rng.randn(500, 3).astype(np.float32)
    surf = 0.5 * surf / np.linalg.norm(surf, axis=-1, keepdims=True)
    kw = dict(num_samples=8000, batch_size=2048, surface_pts=surf, seed=0)
    mkw = dict(hidden_dim=32, num_layers=1, position_input=True)
    jtr = jst.SDFTrainer(jst.SDFTrainerConfig(epochs=30, chunk_size=50),
                         jsdf.NeuralSDFConfig(grid=_grid(jlg), **mkw),
                         jds.from_analytic(sphere_sdf, **kw), seed=0)
    jtr.train(num_iterations=200)
    ttr = tst.SDFTrainer(tst.SDFTrainerConfig(epochs=30, chunk_size=50),
                         tsdf.NeuralSDFConfig(grid=_grid(tlg), **mkw),
                         tds.from_analytic(sphere_sdf, **kw), seed=0,
                         device='cpu')
    ttr.set_params(params_from_jax(jax.tree.map(np.asarray, jtr.params)))
    return jtr, ttr


def test_trace_and_autodiff_normals_of_a_trained_field_match_jax(trained):
    """The trained field's trace and normals, the normals autodiff in both
    packages (``jax.grad`` against ``torch.autograd.grad``)."""
    jtr, ttr = trained
    ro, rd = _camera_rays(24)
    jrays, trays = _both_rays(ro, rd, 0.0, 6.0)
    jcfg, tcfg = jocc.OccupancyGridConfig(level=4), \
        tocc.OccupancyGridConfig(level=4)
    jstate, tstate = jocc.occupancy_init(jcfg), tocc.occupancy_init(tcfg,
                                                                    'cpu')
    jm, tm = jtr.model_cfg, ttr.model_cfg
    jp = jtr.params
    want = jtracer.trace(lambda c: jsdf.neural_sdf(jp, jm, c), jstate, jcfg,
                         jtracer.SDFTracerConfig(num_steps=128), jrays)
    want = jtracer.shade_normals(jax.vmap(jax.grad(
        lambda c: jsdf.neural_sdf(jp, jm, c[None])[0, 0])), want)

    def sdf_fn(c):
        return tsdf.neural_sdf(ttr.params, tm, c)

    got = ttracer.trace(sdf_fn, tstate, tcfg,
                        ttracer.SDFTracerConfig(num_steps=128), trays)
    got = ttracer.shade_normals(lambda x: autodiff_gradient(sdf_fn, x), got)
    assert 0 < got['hit'].sum() < len(ro)
    _assert_traces_equal(got, want)


def test_autodiff_normals_have_no_grid_term_in_either_package():
    """With the raw position off, nothing of the field's gradient is left:
    zeros in both packages."""
    jm = jsdf.NeuralSDFConfig(grid=_grid(jlg), hidden_dim=32,
                              position_input=False)
    tm = tsdf.NeuralSDFConfig(grid=_grid(tlg), hidden_dim=32,
                              position_input=False)
    jp = jsdf.neural_sdf_init(jax.random.PRNGKey(1), jm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.RandomState(0).uniform(-0.6, 0.6, (50, 3)).astype(
        np.float32)
    want = jax.vmap(jax.grad(
        lambda c: jsdf.neural_sdf(jp, jm, c[None])[0, 0]))(x)
    got = autodiff_gradient(lambda c: tsdf.neural_sdf(tp, tm, c), _t(x))
    assert not np.asarray(want).any() and not got.any()


@pytest.mark.parametrize('shading', ['normal', 'matcap', 'shadow'])
def test_render_matches_jax(trained, shading):
    jtr, ttr = trained
    tex = np.random.RandomState(2).rand(8, 8, 3).astype(np.float32)
    kw = dict(res=(20, 24), shading=shading, matcap=tex, min_y=-0.9)
    want = jtr.render(**kw)
    got = ttr.render(**kw)
    assert got.shape == want.shape == (20, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.slow
def test_sdf_render_shading_modes():
    """tests/test_sdf.py's render test on the port's own training run."""
    rng = np.random.RandomState(0)
    surf = rng.randn(500, 3).astype(np.float32)
    surf = 0.5 * surf / np.linalg.norm(surf, axis=-1, keepdims=True)
    ds = tds.from_analytic(sphere_sdf, num_samples=8000, batch_size=2048,
                           surface_pts=surf, seed=0)
    mcfg = tsdf.NeuralSDFConfig(grid=_grid(tlg), hidden_dim=32,
                                num_layers=1, position_input=True)
    trainer = tst.SDFTrainer(tst.SDFTrainerConfig(epochs=30, chunk_size=50),
                             mcfg, ds, seed=0, device='cpu')
    trainer.train(num_iterations=200)

    img_n = trainer.render(res=(48, 48), shading='normal')
    assert img_n.shape == (48, 48, 3) and np.isfinite(img_n).all()
    assert img_n[24, 24].sum() > 0
    assert img_n[0, 0].sum() == 0

    tex = np.broadcast_to(np.asarray([0.2, 0.6, 0.9], np.float32),
                          (8, 8, 3)).copy()
    img_m = trainer.render(res=(48, 48), shading='matcap', matcap=tex)
    assert np.isfinite(img_m).all()
    np.testing.assert_allclose(img_m[24, 24], [0.2, 0.6, 0.9], atol=1e-4)

    img_s = trainer.render(res=(48, 48), shading='shadow', min_y=-0.9)
    assert np.isfinite(img_s).all()
    assert img_s[0, 0].sum() > 0 or img_s[47, 47].sum() > 0


# --- tests/test_shaders.py on the port, and against the JAX shaders ----

def test_spherical_envmap_matches_reference_numpy():
    rng = np.random.RandomState(0)
    rd = rng.randn(64, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    n = rng.randn(64, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    rds = rd * np.array([1, 1, -1])
    dot = np.sum(n * rds, axis=-1)[..., None]
    r = rds - 2.0 * dot * n
    m = 2.0 * np.sqrt(r[..., 0] ** 2 + r[..., 1] ** 2 + (r[..., 2] - 1) ** 2)
    want = 1.0 - (r[..., :2] / m[..., None] + 0.5)
    want = np.clip(want, 0, 1)
    want[np.isnan(want)] = 0

    got = tshaders.spherical_envmap(_t(rd), _t(n)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jshaders.spherical_envmap(rd, n)), rtol=0, atol=1e-6)


def test_bilinear_sample_exact_on_grid_points():
    tex = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    uv = np.asarray([[0.0, 0.0], [1.0, 1.0], [1 / 3, 0.5]], np.float32)
    out = tshaders.sample_texture_bilinear(_t(tex), _t(uv)).numpy()
    np.testing.assert_allclose(out[0], tex[0, 0], atol=1e-5)
    np.testing.assert_allclose(out[1], tex[3, 2], atol=1e-5)
    np.testing.assert_allclose(out[2], tex[1, 1], atol=1e-5)
    uv = np.random.RandomState(0).rand(100, 2).astype(np.float32)
    np.testing.assert_allclose(
        tshaders.sample_texture_bilinear(_t(tex), _t(uv)).numpy(),
        np.asarray(jshaders.sample_texture_bilinear(tex, uv)), rtol=0,
        atol=1e-5)


def test_matcap_shader_shapes_and_range():
    rng = np.random.RandomState(1)
    n = rng.randn(32, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    o = np.zeros((32, 3), np.float32)
    d = rng.randn(32, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jrays, trays = _both_rays(o, d)
    tex = rng.rand(16, 16, 3).astype(np.float32)
    mm = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    for rot in (None, mm):
        out = tshaders.matcap_shader({'normal': _t(n)}, trays, tex, mm=rot)
        assert out['rgb'].shape == (32, 3)
        assert float(out['rgb'].min()) >= 0.0
        assert float(out['rgb'].max()) <= 1.0
        want = jshaders.matcap_shader({'normal': jnp.asarray(n)}, jrays, tex,
                                      mm=rot)
        np.testing.assert_allclose(out['rgb'].numpy(),
                                   np.asarray(want['rgb']), rtol=0, atol=1e-5)


def _shadow_scene(h=8, w=8):
    n = h * w
    o = np.zeros((n, 3), np.float32)
    o[:, 1] = 2.0                     # camera above, looking down
    d = np.tile(np.asarray([[0, -1.0, 0]], np.float32), (n, 1))
    o[:, 0] = np.repeat(np.linspace(-1, 1, w), h)
    o[:, 2] = np.tile(np.linspace(-0.4, 0.4, h), w)
    return o, d


def test_shadow_shader_blocks_light():
    h = w = 8
    n = h * w
    o, d = _shadow_scene(h, w)
    jrays, trays = _both_rays(o, d, 0.0, 10.0)
    rb = {'hit': torch.zeros((n,), dtype=torch.bool),
          'depth': torch.zeros((n, 1)), 'xyz': torch.zeros((n, 3)),
          'normal': torch.zeros((n, 3)), 'rgb': torch.ones((n, 3))}
    light = [0.0, 5.0, 0.0]

    def hit_fn(xp):
        def trace_hit_fn(sr):
            # occluder: a disc of radius 0.3 at y=1
            dy = sr.dirs[:, 1]
            t = (1.0 - sr.origins[:, 1]) / xp.where(xp.abs(dy) < 1e-6, 1e-6,
                                                    dy)
            p = sr.origins + sr.dirs * t[:, None]
            return (t > 0) & (p[:, 0] ** 2 + p[:, 2] ** 2 < 0.3 ** 2)
        return trace_hit_fn

    out = tshaders.shadow_shader(rb, trays, hit_fn(torch), light, min_y=0.0,
                                 image_shape=(h, w))
    rgbs = out['rgb'].numpy().reshape(w, h, 3)
    assert out['hit'].all()                      # everything hits ground
    assert rgbs[w // 2, h // 2].mean() < rgbs[0, 0].mean()
    want = jshaders.shadow_shader({k: jnp.asarray(v.numpy())
                                   for k, v in rb.items()}, jrays,
                                  hit_fn(jnp), light, min_y=0.0,
                                  image_shape=(h, w))
    for k in ('rgb', 'hit', 'depth', 'xyz', 'normal', 'shadow'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_shadow_shader_on_traced_sphere_matches_jax():
    """The shadow shader over a traced analytic sphere, its shadow rays
    traced by the sphere tracer in each package; the jitter draws from a
    generator only when one is given."""
    ro, rd = _camera_rays(16)
    jrays, trays = _both_rays(ro, rd, 0.0, 6.0)
    jcfg, tcfg = jocc.OccupancyGridConfig(level=4), \
        tocc.OccupancyGridConfig(level=4)
    jstate, tstate = jocc.occupancy_init(jcfg), tocc.occupancy_init(tcfg,
                                                                    'cpu')
    tr_cfg = dict(num_steps=96)

    def jsphere(x):
        return jnp.linalg.norm(x, axis=-1, keepdims=True) - 0.5

    def tsphere(x):
        return torch.linalg.norm(x, dim=-1, keepdim=True) - 0.5

    jrb = jtracer.shade_normals(
        jax.vmap(jax.grad(lambda c: jnp.linalg.norm(c) - 0.5)),
        jtracer.trace(jsphere, jstate, jcfg,
                      jtracer.SDFTracerConfig(**tr_cfg), jrays))
    trb = ttracer.shade_normals(
        lambda x: autodiff_gradient(tsphere, x),
        ttracer.trace(tsphere, tstate, tcfg,
                      ttracer.SDFTracerConfig(**tr_cfg), trays))
    light = (1.5, 4.0, 1.5)
    want = jshaders.shadow_shader(
        jrb, jrays, lambda sr: jtracer.trace(
            jsphere, jstate, jcfg, jtracer.SDFTracerConfig(**tr_cfg),
            sr)['hit'], light, min_y=-0.6, image_shape=(16, 16))

    def thit(sr):
        return ttracer.trace(tsphere, tstate, tcfg,
                             ttracer.SDFTracerConfig(**tr_cfg), sr)['hit']

    got = tshaders.shadow_shader(trb, trays, thit, light, min_y=-0.6,
                                 image_shape=(16, 16))
    assert got['shadow'].any() and got['hit'].any()
    for k in ('rgb', 'hit', 'depth', 'xyz', 'normal', 'shadow'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    g = torch.Generator().manual_seed(0)
    jittered = tshaders.shadow_shader(trb, trays, thit, light, min_y=-0.6,
                                      image_shape=(16, 16), generator=g)
    assert torch.isfinite(jittered['rgb']).all()


def test_gaussian_blur_matches_jax():
    img = np.random.RandomState(0).rand(9, 13).astype(np.float32)
    for sigma in (0.3, 1.0, 2.0):
        np.testing.assert_allclose(
            tshaders.gaussian_blur(_t(img), sigma).numpy(),
            np.asarray(jshaders.gaussian_blur(jnp.asarray(img), sigma)),
            rtol=0, atol=1e-6)


def test_load_matcap_transposes(tmp_path):
    from PIL import Image
    arr = (np.random.RandomState(0).rand(5, 7, 3) * 255).astype(np.uint8)
    path = str(tmp_path / 'matcap.png')
    Image.fromarray(arr).save(path)
    got = tshaders.load_matcap(path)
    assert got.shape == (7, 5, 3)
    np.testing.assert_array_equal(got, jshaders.load_matcap(path))
