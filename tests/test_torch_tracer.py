"""Port parity: raymarch, stride compaction, compact volume integration and
trace() against shacira_tpu.accel.occupancy / shacira_tpu.tracers.rf_tracer.

March samples agree to 1e-6 and masks exactly (same injected jitter);
compaction is exact; integration agrees to rtol 1e-5 / atol 1e-6 and its
gradients to 1e-5 (f32; the port's segmented prefix sum runs in float64,
JAX's associative scan in f32)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays as tmake_rays  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402


def _rays(seed, r):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-0.3, 0.3, size=(r, 3)).astype(np.float32)
    o[:, 2] -= 2.5
    d = rng.randn(r, 3).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _occ(level, seed):
    rng = np.random.RandomState(seed)
    res = 2 ** level
    occ = rng.rand(res, res, res) < 0.5
    return occ


def test_linspace_matches_jax_bitwise():
    for n in (2, 7, 64, 2048):
        np.testing.assert_array_equal(tocc.linspace01(n, 'cpu').numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_raymarch_ray_with_injected_jitter():
    o, d = _rays(0, 32)
    occ = _occ(3, 0)
    cfg_j, cfg_t = jocc.OccupancyGridConfig(3), tocc.OccupancyGridConfig(3)
    u = np.random.RandomState(1).rand(32, 64).astype(np.float32)
    sj = {'occ': jnp.asarray(occ), 'density': jnp.zeros(occ.shape)}
    st = {'occ': torch.as_tensor(occ), 'density': torch.zeros(occ.shape)}
    mj = jocc.raymarch_ray(sj, cfg_j, jmake_rays(o, d, 1.0, 4.0), 64,
                           jnp.asarray(u))
    mt = tocc.raymarch_ray(st, cfg_t, tmake_rays(o, d, 1.0, 4.0), 64,
                           torch.as_tensor(u))
    for k in ('samples', 'depth', 'deltas'):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(mt['mask'].numpy(), np.asarray(mj['mask']))


@pytest.mark.parametrize('budget', [5000, 600, 97, 1])
def test_stride_compact_is_exact(budget):
    mask = np.random.RandomState(budget).rand(4000) < 0.3
    sj, vj, slj = jrt._stride_compact(jnp.asarray(mask), budget)
    st, vt, slt = trt._stride_compact(torch.as_tensor(mask), budget)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(slt.numpy(), np.asarray(slj))


def _compact_rows(seed, rays=12, k=400, valid_rows=330):
    rng = np.random.RandomState(seed)
    ray_id = np.sort(rng.randint(0, rays, size=valid_rows))
    ray_id = np.concatenate([ray_id, np.zeros(k - valid_rows, int)])
    valid = np.arange(k) < valid_rows
    color = rng.rand(k, 3).astype(np.float32)
    density = (rng.rand(k) * 4).astype(np.float32)
    deltas = (rng.rand(k) * 0.2).astype(np.float32)
    depth = np.cumsum(deltas).astype(np.float32)
    return color, density, deltas, depth, valid, ray_id.astype(np.int32), rays


def test_segmented_cumsum_and_grad_match_jax():
    rng = np.random.RandomState(3)
    tau = rng.rand(300).astype(np.float32)
    start = rng.rand(300) < 0.1
    start[0] = True
    ct = rng.randn(300).astype(np.float32)
    want = np.asarray(jax.jit(jrt._segmented_cumsum_excl)(
        jnp.asarray(tau), jnp.asarray(start)))
    want_g = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(
        jrt._segmented_cumsum_excl(t, jnp.asarray(start)) * ct)))(
            jnp.asarray(tau)))
    tt = torch.tensor(tau, requires_grad=True)
    got = trt._segmented_cumsum_excl(tt, torch.as_tensor(start))
    (got_g,) = torch.autograd.grad(torch.sum(got * torch.as_tensor(ct)), tt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-5, atol=1e-5)


def test_volume_integrate_compact_and_grads_match_jax():
    color, density, deltas, depth, valid, ray_id, rays = _compact_rows(4)
    ct = np.random.RandomState(4).randn(rays, 5).astype(np.float32)

    def jloss(c, dn):
        out = jrt.volume_integrate_compact(
            c, dn, jnp.asarray(deltas), jnp.asarray(depth), jnp.asarray(valid),
            jnp.asarray(ray_id), rays)
        s = jnp.concatenate([out['rgb'], out['alpha'], out['depth']], -1)
        return jnp.sum(s * ct), s

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, (0, 1),
                                                   has_aux=True))(
        jnp.asarray(color), jnp.asarray(density))
    c_t = torch.tensor(color, requires_grad=True)
    d_t = torch.tensor(density, requires_grad=True)
    out = trt.volume_integrate_compact(
        c_t, d_t, torch.as_tensor(deltas), torch.as_tensor(depth),
        torch.as_tensor(valid), torch.as_tensor(ray_id), rays)
    got = torch.cat([out['rgb'], out['alpha'], out['depth']], -1)
    got_g = torch.autograd.grad(torch.sum(got * torch.as_tensor(ct)),
                                (c_t, d_t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_compact_integration_equals_dense():
    color, density, deltas, depth, valid, ray_id, rays = _compact_rows(5)
    n_valid = int(valid.sum())
    out = trt.volume_integrate_compact(
        *(torch.as_tensor(a) for a in (color, density, deltas, depth, valid,
                                       ray_id)), rays)
    # dense [R, S] layout of the same rows, padded with masked samples
    per_ray = np.bincount(ray_id[:n_valid], minlength=rays)
    s = int(per_ray.max())
    dense = {k: np.zeros((rays, s) + a.shape[1:], np.float32)
             for k, a in (('c', color), ('d', density), ('dl', deltas),
                          ('t', depth))}
    mask = np.zeros((rays, s), bool)
    fill = np.zeros(rays, int)
    for i in range(n_valid):
        r = ray_id[i]
        for k, a in (('c', color), ('d', density), ('dl', deltas),
                     ('t', depth)):
            dense[k][r, fill[r]] = a[i]
        mask[r, fill[r]] = True
        fill[r] += 1
    rgb, alpha, dep = trt.volume_integrate(
        torch.as_tensor(dense['c']), torch.as_tensor(dense['d']),
        torch.as_tensor(dense['dl']), torch.as_tensor(dense['t']),
        torch.as_tensor(mask))
    torch.testing.assert_close(out['rgb'], rgb, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out['alpha'], alpha, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out['depth'], dep, rtol=1e-5, atol=1e-6)


def _field_pair():
    def jfield(c, d):
        col = jax.nn.sigmoid(c * 2.0 + d)
        den = jax.nn.relu(3.0 - 4.0 * jnp.sum(c * c, -1, keepdims=True))
        return col, den

    def tfield(c, d):
        col = torch.sigmoid(c * 2.0 + d)
        den = torch.relu(3.0 - 4.0 * torch.sum(c * c, -1, keepdim=True))
        return col, den

    return jfield, tfield


@pytest.mark.parametrize('max_samples', [20000, 2500, 0])
def test_trace_matches_jax(max_samples):
    """Compact branch without and with stride overflow, and the dense one."""
    o, d = _rays(6, 48)
    occ = _occ(3, 6)
    occ[2:6, 2:6, 2:6] = True
    u = np.random.RandomState(7).rand(48, 128).astype(np.float32)
    jfield, tfield = _field_pair()
    jcfg = jrt.RFTracerConfig(num_steps=128, max_samples=max_samples)
    tcfg = trt.RFTracerConfig(num_steps=128, max_samples=max_samples)
    sj = {'occ': jnp.asarray(occ), 'density': jnp.zeros(occ.shape)}
    st = {'occ': torch.as_tensor(occ), 'density': torch.zeros(occ.shape)}
    want = jax.jit(lambda s_, u_: jrt.trace(
        jfield, s_, jocc.OccupancyGridConfig(3), jcfg,
        jmake_rays(o, d, 1.0, 4.5), u_))(sj, jnp.asarray(u))
    got = trt.trace(tfield, st, tocc.OccupancyGridConfig(3), tcfg,
                    tmake_rays(o, d, 1.0, 4.5), torch.as_tensor(u))
    for k in ('rgb', 'alpha', 'depth'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got['hit'].numpy(), np.asarray(want['hit']))


def test_unported_march_modes_raise():
    """'kernel' with lean stage 1 crashes in the reference and raises here,
    as does a march type the JAX package lacks; the voxel march is ported
    (tests/test_torch_voxel_trace.py)."""
    assert trt.RFTracerConfig(raymarch_type='voxel').raymarch_type == 'voxel'
    with pytest.raises(ValueError):
        trt.RFTracerConfig(raymarch_type='cone')
    with pytest.raises(ValueError, match='crashes in the reference'):
        trt.RFTracerConfig(segment_size=16, max_samples=1024,
                           fine_mode='kernel', lean_stage1=True)
