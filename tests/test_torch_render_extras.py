"""Port parity of the tracer's extra per-sample channels and of the NeRF
trainer's ``render_tb_every``.

Extras (mirroring tests/test_lifecycle.py::test_tracer_extra_channels on
both packages, the JAX march jitter passed to both): a field returning
(color, density, {'feat': [..., 4]}) is integrated on the dense and the
compact path of the 'ray' and 'voxel' marches; port against JAX within
1e-5, the dense path against a brute-force sum of the weights within
1e-5 and the compact path against the dense one within 1e-4 (the JAX
test's bound).  ``render_tb_every``: the iterations at which the port logs
``render/view0`` and ends its chunks equal the JAX trainer's."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays as tmake_rays  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402

from tests.test_torch_step import _cfgs, _scene, TRAIN  # noqa: E402

R = 32


def _rays():
    o = np.zeros((R, 3), np.float32)
    o[:, 2] = -2.0
    d = np.zeros((R, 3), np.float32)
    d[:, 2] = 1.0
    d[:, 0] = np.linspace(-0.3, 0.3, R)
    d[:, 1] = np.linspace(0.2, -0.1, R)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _jfield(c, dirs):
    dens = jax.nn.relu(1.0 - 4.0 * jnp.sum(c * c, -1, keepdims=True))
    col = 0.5 + 0.5 * jnp.tanh(c)
    return col, dens * 20.0, {'feat': jnp.concatenate([c * 2.0, c[..., :1]],
                                                      axis=-1)}


def _tfield(c, dirs):
    dens = torch.relu(1.0 - 4.0 * torch.sum(c * c, -1, keepdim=True))
    col = 0.5 + 0.5 * torch.tanh(c)
    return col, dens * 20.0, {'feat': torch.cat([c * 2.0, c[..., :1]],
                                                dim=-1)}


MARCHES = {
    'ray dense': dict(raymarch_type='ray', num_steps=64, max_samples=0),
    'ray compact': dict(raymarch_type='ray', num_steps=64,
                        max_samples=R * 64 // 2),
    'voxel dense': dict(raymarch_type='voxel', num_steps=4,
                        max_intersections=12, max_samples=0),
    'voxel compact': dict(raymarch_type='voxel', num_steps=4,
                          max_intersections=12, max_samples=R * 24),
}


def _trace_both(kw, level=3):
    occ = np.random.RandomState(0).rand(2 ** level, 2 ** level,
                                        2 ** level) < 0.7
    o, d = _rays()
    jcfg, tcfg = jrt.RFTracerConfig(**kw), trt.RFTracerConfig(**kw)
    u = np.random.RandomState(1).rand(
        *trt.march_jitter_shape(tcfg, R)).astype(np.float32)
    js = {'occ': jnp.asarray(occ), 'density': jnp.zeros(occ.shape)}
    ts = {'occ': torch.as_tensor(occ), 'density': torch.zeros(occ.shape)}
    want = jax.jit(lambda s_, u_: jrt.trace(
        _jfield, s_, jocc.OccupancyGridConfig(level), jcfg,
        jmake_rays(o, d, 0.0, 4.0), u_))(js, jnp.asarray(u))
    got = trt.trace(_tfield, ts, tocc.OccupancyGridConfig(level), tcfg,
                    tmake_rays(torch.as_tensor(o), torch.as_tensor(d), 0.0,
                               4.0), torch.as_tensor(u))
    return got, want, (ts, tcfg, o, d, u, level)


@pytest.mark.parametrize('march', list(MARCHES))
def test_extra_channels_match_jax(march):
    got, want, _ = _trace_both(MARCHES[march])
    assert got['feat'].shape == (R, 4)
    assert float(got['alpha'].max()) > 0.5       # the rays hit the blob
    for k in ('rgb', 'alpha', 'depth', 'feat'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)


def test_extra_channels_are_integrated_with_the_rgb_weights():
    """Dense 'ray' path: the brute-force sum of the integration weights;
    the compact path with a full budget equals the dense one."""
    got, _, (ts, tcfg, o, d, u, level) = _trace_both(MARCHES['ray dense'])
    m = tocc.raymarch_ray(ts, tocc.OccupancyGridConfig(level), tmake_rays(
        torch.as_tensor(o), torch.as_tensor(d), 0.0, 4.0), 64,
        torch.as_tensor(u))
    dirs = torch.broadcast_to(torch.as_tensor(d)[:, None], m['samples'].shape)
    _, dens, extras = _tfield(m['samples'], dirs)
    w = trt.integration_weights(dens[..., 0] * m['mask'], m['deltas'],
                                torch.ones_like(m['deltas']))
    ref = torch.sum(w[..., None] * extras['feat'] * m['mask'][..., None],
                    dim=-2)
    np.testing.assert_allclose(got['feat'].numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)
    full, _, _ = _trace_both(dict(MARCHES['ray dense'],
                                  max_samples=R * 64 - 1))
    np.testing.assert_allclose(full['feat'].numpy(), got['feat'].numpy(),
                               rtol=0, atol=1e-4)


def test_compact_extras_ride_the_one_segment_sum(monkeypatch):
    """The compact path sums rgb, alpha, depth and every extra column in
    one per-ray segment sum (kernel B1(b) on the card), 5 + k wide."""
    widths = []
    real = trt.segment_sum

    def spy(idx, vals, n):
        widths.append(vals.shape[1])
        return real(idx, vals, n)

    monkeypatch.setattr(trt, 'segment_sum', spy)
    _trace_both(MARCHES['ray compact'])
    assert widths == [5 + 4]


class _Logger:
    """Records what the trainers log."""

    def __init__(self):
        self.images, self.scalars, self.records = [], [], []

    def scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def image(self, tag, img, step):
        self.images.append((tag, step, np.array(img)))

    def record(self, metrics):
        self.records.append(dict(metrics))


def _stub_render_and_eval(tr):
    tr.render_view = lambda v, dataset=None, **kw: np.full((2, 2, 3), v,
                                                            np.float32)
    tr.evaluate = lambda view_indices=None, dataset=None: {'psnr': 20.0,
                                                           'ssim': 0.5}


def test_render_tb_every_logs_and_ends_chunks_as_the_jax_trainer():
    """5 epochs of 3 views, chunks of 4, validation every 2 epochs and a
    render every 2: the JAX trainer's chunk function and the port's step
    are stubbed (no field work), so only the loop's schedule runs."""
    jdata, tdata = _scene(num_views=3, res=8)
    jm, jt, _, tm, tt, _ = _cfgs(max_samples=0)
    sched = dict(TRAIN, epochs=5, chunk_size=4, valid_every=2,
                 render_tb_every=2)
    jlog, tlog = _Logger(), _Logger()
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **sched), jm, jt,
        jdata, num_rays=16, seed=0, logger=jlog)
    ttr = tmt.MultiviewTrainer(tmt.MultiviewTrainerConfig(**sched), tm, tt,
                               tdata, num_rays=16, seed=0, device='cpu',
                               logger=tlog)
    for tr in (jtr, ttr):
        _stub_render_and_eval(tr)

    def jchunk(use_sga):
        def run(params, opt_state, noise, occ_state, structure, xs):
            n = xs['rays_o'].shape[0]
            return (params, opt_state, noise), {
                'rgb_loss': jnp.zeros((n,)), 'psnr': jnp.zeros((n,))}
        return run

    jtr._get_chunk_fn = jchunk
    ttr.step = lambda *a, **k: {k_: torch.zeros(()) for k_ in
                                ('loss', 'rgb_loss', 'psnr')}
    jlog_fn, tlog_fn = [], []
    jtr.train(log_fn=jlog_fn.append)
    ttr.train(log_fn=tlog_fn.append)
    chunk_ends = [[e['iteration'] for e in log if 'iteration' in e]
                  for log in (jlog_fn, tlog_fn)]
    assert chunk_ends[0] == chunk_ends[1] == [4, 6, 10, 12, 15]
    images = [[(tag, step) for tag, step, _ in lg.images]
              for lg in (jlog, tlog)]
    assert images[0] == images[1] == [('render/view0', 6),
                                      ('render/view0', 12)]
    assert ([r['iteration'] for r in jlog.records]
            == [r['iteration'] for r in tlog.records] == [6, 12])
    assert sorted(set(jlog.scalars)) == sorted(set(tlog.scalars))


def test_render_tb_every_logs_the_first_validation_view():
    """A real port run: the image logged at the last epoch is
    ``render_view(0)`` of the validation split."""
    _, tdata = _scene(num_views=3, res=8)
    _, val = _scene(num_views=2, res=8)
    *_, tm, tt, _ = _cfgs(max_samples=0)
    log = _Logger()
    tr = tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**dict(TRAIN, epochs=2, chunk_size=3,
                                          render_tb_every=1)),
        tm, tt, tdata, num_rays=16, seed=0, device='cpu',
        val_dataset=val, logger=log)
    tr.train()
    assert [(t, s) for t, s, _ in log.images] == [('render/view0', 3),
                                                   ('render/view0', 6)]
    np.testing.assert_array_equal(log.images[-1][2],
                                  tr.render_view(0, dataset=val))
