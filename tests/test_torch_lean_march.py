"""Port parity for lean stage 1, the two-level super-segment cull and
transmittance culling (``term_tau``) against shacira_tpu.tracers.rf_tracer.

Tolerances: the counter hash, the lean seed and the uint32 -> f32 rounding
bit for bit; the lean survivors (rays, validity, fine masks) exactly, their
depths and deltas to 1e-6 relative (f32 on both sides); rendered rgb, alpha
and depth to rtol = atol = 1e-5 (f32 integration, the port's segmented
prefix sum in float64).  The scenes keep every estimated optical depth away
from ``term_tau``: the JAX package takes the culling prefix sum in f32 by an
associative scan, the port by another summation order, so a sum lying on
the threshold could fall either way.
"""
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

S = 512
LEAN = dict(num_steps=S, bg_color='white', max_samples=8192, segment_size=8,
            coarse_level=4, seg_dilation=2, eval_seg_budget=2048,
            group_segs_per_block=4, fine_mode='deferred', lean_stage1=True)
SEED_U = np.asarray([0.25, 0.5], np.float32)


def sphere_states(level=5, radius=0.55, density=20.0):
    """(JAX state, port state, occupancy configs) of a sphere occupancy
    with a uniform decayed-max density inside it."""
    res = 2 ** level
    g = np.linspace(-1, 1, res, endpoint=False) + 1.0 / res
    xx, yy, zz = np.meshgrid(g, g, g, indexing='ij')
    occ = (xx ** 2 + yy ** 2 + zz ** 2) < radius ** 2
    dens = occ.astype(np.float32) * density
    return ({'occ': jnp.asarray(occ), 'density': jnp.asarray(dens)},
            {'occ': torch.as_tensor(occ), 'density': torch.as_tensor(dens)},
            jocc.OccupancyGridConfig(level), tocc.OccupancyGridConfig(level))


def scene_rays(r=48, seed=3):
    """Rays from one point outside the cube towards random interior
    points (numpy)."""
    rng = np.random.RandomState(seed)
    o = np.asarray([[2.0, 0.3, 0.1]], np.float32) + np.zeros((r, 3),
                                                             np.float32)
    d = rng.uniform(-0.8, 0.8, (r, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def split(xp):
    """An analytic 3-way encode split: latents sin(2c) and c^2 on the
    segment rows, a tanh colour and sigmoid density head."""
    if xp is jnp:
        cat, sig, keep = jnp.concatenate, jax.nn.sigmoid, dict(keepdims=True)
    else:
        cat, sig, keep = torch.cat, torch.sigmoid, dict(keepdim=True)

    def zbar_fn(coords, grouping):
        return cat([xp.sin(2.0 * coords), coords ** 2], -1)

    def finish_fn(zbar_c, coords_c):
        return zbar_c

    def head_fn(feats, dirs):
        color = 0.5 + 0.4 * xp.tanh(feats[..., :3] + dirs)
        return color, 3.0 * sig(feats[..., 3:].sum(-1, **keep))

    return zbar_fn, finish_fn, head_fn


def trace_both(jcfg_kw, u, tcfg_kw=None, states=None, rays=None,
               dist=(0.0, 4.0)):
    """The paged trace of one config on both sides (JAX under jit), same
    jitter ``u`` (numpy)."""
    js, ts, jc, tc = states or sphere_states()
    o, d = rays or scene_rays()
    jt = jrt.RFTracerConfig(**jcfg_kw)
    tt = trt.RFTracerConfig(**(tcfg_kw or jcfg_kw))
    want = jax.jit(lambda s, uu: jrt.trace(
        None, s, jc, jt, jmake_rays(o, d, *dist), uu,
        encode_split=split(jnp)))(js, jnp.asarray(u))
    got = trt.trace(None, ts, tc, tt, tmake_rays(o, d, *dist),
                    torch.as_tensor(u), encode_split=split(torch))
    return got, want


def assert_render_close(got, want, tol=1e-5):
    for ch in ('rgb', 'alpha', 'depth'):
        np.testing.assert_allclose(got[ch].numpy(), np.asarray(want[ch]),
                                   rtol=tol, atol=tol, err_msg=ch)
    np.testing.assert_array_equal(got['hit'].numpy(), np.asarray(want['hit']))


@pytest.mark.parametrize('seed', [0, 1, 12345, 2 ** 31, 2 ** 32 - 1,
                                  0xDEADBEEF])
def test_hash01_is_bit_exact(seed):
    rng = np.random.RandomState(seed % 2 ** 31)
    ids = np.concatenate([
        np.arange(0, 4096), np.arange(2 ** 31 - 2048, 2 ** 31 + 2048),
        np.arange(2 ** 32 - 4096, 2 ** 32),
        rng.randint(0, 2 ** 32, size=50_000, dtype=np.uint64)]
    ).astype(np.uint32)
    want = np.asarray(jrt._hash01(jnp.uint32(seed), jnp.asarray(ids)))
    got = trt._hash01(torch.tensor(seed, dtype=torch.int64),
                      torch.as_tensor(ids.astype(np.int64))).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_uint32_to_f32_rounds_like_xla():
    """The hash's last step: values near 2^32 round to 2^32 (so 1.0 after
    the scale) and ties to even, on both sides."""
    x = np.asarray([0, 1, 2 ** 24 + 1, 2 ** 31 - 65, 2 ** 31 + 129,
                    2 ** 32 - 1, 2 ** 32 - 128, 2 ** 32 - 129, 2 ** 32 - 383,
                    2 ** 32 - 384, 2 ** 32 - 385], np.uint32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float32)
                      * jnp.float32(2.0 ** -32))
    got = (torch.as_tensor(x.astype(np.int64)).to(torch.float32)
           * (2.0 ** -32)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[5] == 1.0


def test_lean_seed_is_bit_exact():
    rng = np.random.RandomState(4)
    us = [SEED_U, [0.0, 0.0], [0.99999994, 0.99999994], [0.3125, 0.7812]]
    us += list(rng.rand(20, 2))
    for u in us:
        u = np.asarray(u, np.float32)
        assert int(trt._lean_seed(torch.as_tensor(u))) \
            == int(jrt._lean_seed(jnp.asarray(u)))
    with pytest.raises(ValueError):
        trt._lean_seed(torch.zeros((4, 8)))


def test_lean_jitter_shape_is_the_seed_pair():
    for lean, mode, want in ((True, 'deferred', (2,)),
                             (False, 'deferred', (7, S)),
                             (True, 'exact', (7, S))):
        kw = dict(LEAN, lean_stage1=lean, fine_mode=mode)
        assert trt.march_jitter_shape(trt.RFTracerConfig(**kw), 7) == want \
            == jrt.march_jitter_shape(jrt.RFTracerConfig(**kw), 7)


@pytest.mark.parametrize('term_tau', [0.0, 11.5])
def test_lean_survivors_match_jax(term_tau):
    """One-level lean stage 1: the same k2 survivors (rays, validity, fine
    masks) in (ray, depth) order, their depths and deltas to 1e-6."""
    js, ts, jc, tc = sphere_states()
    o, d = scene_rays()
    kw = dict(LEAN, term_tau=term_tau)
    jt, tt = jrt.RFTracerConfig(**kw), trt.RFTracerConfig(**kw)
    want = jax.jit(lambda s, u: jrt._trace_ray_deferred_lean(
        s, jc, jt, jmake_rays(o, d, 0.0, 4.0), u,
        lambda p: jocc.query(s, jc, p)))(js, jnp.asarray(SEED_U))
    got = trt._trace_ray_deferred_lean(
        ts, tc, tt, tmake_rays(o, d, 0.0, 4.0), torch.as_tensor(SEED_U),
        lambda p: tocc.query(ts, tc, p))
    for k in ('ray', 'valid', 'fine'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ('depth', 'deltas', 'samples'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    n = int(got['valid'].sum())
    assert 100 < n < kw['eval_seg_budget']                  # no truncation
    ray = got['ray'][:n, 0]
    assert bool(torch.all(ray[1:] >= ray[:-1]))                # ray order
    if term_tau:                               # the occluded back is culled
        assert n < int(trt._trace_ray_deferred_lean(
            ts, tc, trt.RFTracerConfig(**dict(kw, term_tau=0.0)),
            tmake_rays(o, d, 0.0, 4.0), torch.as_tensor(SEED_U),
            lambda p: tocc.query(ts, tc, p))['valid'].sum())


@pytest.mark.parametrize('term_tau', [0.0, 11.5])
def test_two_level_survivors_match_jax(term_tau):
    js, ts, jc, tc = sphere_states()
    o, d = scene_rays()
    kw = dict(LEAN, term_tau=term_tau, super_factor=4)
    kw['super_dilation'] = trt.super_dilation_for(
        trt.RFTracerConfig(**kw), tc, 0.0, 4.0)
    assert kw['super_dilation'] == jrt.super_dilation_for(
        jrt.RFTracerConfig(**kw), jc, 0.0, 4.0) == 2
    jt, tt = jrt.RFTracerConfig(**kw), trt.RFTracerConfig(**kw)
    jrt.validate_segment_cover(jt, jc, 0.0, 4.0)
    trt.validate_segment_cover(tt, tc, 0.0, 4.0)

    def jfn(s):
        dmin = jnp.zeros((48, 1))
        return jrt._lean_src2_two_level(
            s, jc, jt, jmake_rays(o, d, 0.0, 4.0), dmin + 4.0, dmin)

    src_j, valid_j = jax.jit(jfn)(js)
    dmin = torch.zeros((48, 1))
    src_t, valid_t = trt._lean_src2_two_level(
        ts, tc, tt, tmake_rays(o, d, 0.0, 4.0), dmin + 4.0, dmin)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    n = int(valid_t.sum())
    assert n > 100
    np.testing.assert_array_equal(src_t[:n].numpy(), np.asarray(src_j)[:n])
    assert bool(torch.all(src_t[1:n] > src_t[:n - 1]))   # (ray, depth) order


def test_validate_segment_cover_checks_the_super_cull():
    _, _, jc, tc = sphere_states()
    kw = dict(LEAN, super_factor=4, super_dilation=1)
    for rt, c in ((trt, tc), (jrt, jc)):
        with pytest.raises(ValueError, match='super_dilation'):
            rt.validate_segment_cover(rt.RFTracerConfig(**kw), c, 0.0, 4.0)
        with pytest.raises(ValueError, match='must divide'):
            rt.validate_segment_cover(rt.RFTracerConfig(
                **dict(kw, super_factor=3, super_dilation=4)), c, 0.0, 4.0)
        with pytest.raises(ValueError, match='lean_stage1'):
            rt.validate_segment_cover(rt.RFTracerConfig(
                **dict(kw, lean_stage1=False, super_dilation=4)), c, 0.0,
                4.0)


@pytest.mark.parametrize('super_factor,term_tau', [
    (0, 0.0), (0, 11.5), (4, 0.0), (4, 11.5)])
def test_lean_trace_matches_jax(super_factor, term_tau):
    kw = dict(LEAN, term_tau=term_tau, super_factor=super_factor,
              super_dilation=2 if super_factor else 0)
    got, want = trace_both(kw, SEED_U)
    assert_render_close(got, want)
    assert float(got['alpha'].max()) > 0.5


def test_lean_matches_deferred_statistically():
    """The lean march renders what the deferred one renders up to jitter
    noise (both stratified estimators of one integral), and its samples
    are a function of its seed pair (the render again up to the order of
    the per-ray float sums, which the port does not fix)."""
    _, ts, _, tc = sphere_states(density=0.0)
    o, d = scene_rays()
    rays = tmake_rays(o, d, 0.0, 4.0)

    def run(lean, u):
        tt = trt.RFTracerConfig(**dict(LEAN, seg_budget=2048,
                                       lean_stage1=lean))
        return trt.trace(None, ts, tc, tt, rays, u,
                         encode_split=split(torch))

    ref = run(False, torch.as_tensor(
        np.random.RandomState(11).rand(48, S).astype(np.float32)))
    lean = run(True, torch.as_tensor(SEED_U))
    diff = (lean['rgb'] - ref['rgb']).abs()
    assert float(diff.mean()) < 0.01 and float(diff.max()) < 0.08
    again = run(True, torch.as_tensor(SEED_U))
    torch.testing.assert_close(again['rgb'], lean['rgb'], rtol=1e-6,
                               atol=1e-6)
    tt = trt.RFTracerConfig(**LEAN)
    a, b = (trt._trace_ray_deferred_lean(
        ts, tc, tt, rays, torch.as_tensor(SEED_U),
        lambda p: tocc.query(ts, tc, p)) for _ in range(2))
    for k in ('samples', 'depth', 'deltas', 'ray', 'valid', 'fine'):
        assert torch.equal(a[k], b[k]), k


def test_lean_budget_truncation_is_graceful():
    state = tocc.occupancy_init(tocc.OccupancyGridConfig(4), 'cpu')
    o = np.zeros((16, 3), np.float32)
    o[:, 2] = -2.0
    d = np.zeros((16, 3), np.float32)
    d[:, 2] = 1.0
    tt = trt.RFTracerConfig(num_steps=128, max_samples=256, segment_size=8,
                            coarse_level=4, seg_dilation=2,
                            eval_seg_budget=32, group_segs_per_block=4,
                            fine_mode='deferred', lean_stage1=True)
    out = trt.trace(None, state, tocc.OccupancyGridConfig(4), tt,
                    tmake_rays(o, d, 0.0, 4.0), torch.as_tensor(SEED_U),
                    encode_split=split(torch))
    assert bool(torch.isfinite(out['rgb']).all())
    assert float(out['alpha'].max()) <= 1.0 + 1e-5


@pytest.mark.parametrize('term_tau', [0.0, 11.5])
def test_super_cull_matches_one_level(term_tau):
    """Two-level == one-level lean march when no budget truncates (the
    super test is conservative; the same hash keys the survivors)."""
    _, ts, _, tc = sphere_states(density=5.0)
    o, d = scene_rays()
    rays = tmake_rays(o, d, 0.0, 4.0)

    def run(superf):
        tt = trt.RFTracerConfig(**dict(
            LEAN, term_tau=term_tau, super_factor=superf,
            super_dilation=2 if superf else 0))
        trt.validate_segment_cover(tt, tc, 0.0, 4.0)
        return trt.trace(None, ts, tc, tt, rays, torch.as_tensor(SEED_U),
                         encode_split=split(torch))

    one, two = run(0), run(4)
    for ch in ('rgb', 'alpha', 'depth'):
        torch.testing.assert_close(two[ch], one[ch], rtol=1e-5, atol=1e-5)


def two_wall_states(level=5):
    """An opaque wall at x in [-0.625, -0.375] in front of a second one at
    x in [0.375, 0.625] (faces on cell boundaries, so the density cache
    equals the field's density), as in the JAX package's tests."""
    res = 2 ** level
    g = np.linspace(-1, 1, res, endpoint=False) + 1.0 / res
    xx, _, _ = np.meshgrid(g, g, g, indexing='ij')
    wall1 = (xx > -0.625) & (xx < -0.375)
    wall2 = (xx > 0.375) & (xx < 0.625)
    dens = (400.0 * wall1 + 300.0 * wall2).astype(np.float32)
    occ = wall1 | wall2
    return ({'occ': jnp.asarray(occ), 'density': jnp.asarray(dens)},
            {'occ': torch.as_tensor(occ), 'density': torch.as_tensor(dens)},
            jocc.OccupancyGridConfig(level), tocc.OccupancyGridConfig(level))


def _wall_field(coords, dirs):
    x = coords[..., 0]
    in1 = ((x > -0.625) & (x < -0.375)).float()
    in2 = ((x > 0.375) & (x < 0.625)).float()
    return (torch.stack([in1, in2, torch.zeros_like(x)], -1),
            (400.0 * in1 + 300.0 * in2)[..., None])


def _axis_rays(r=32, seed=7):
    o = np.asarray([[-2.0, 0.0, 0.0]], np.float32) + np.zeros((r, 3),
                                                              np.float32)
    to = np.random.RandomState(seed).uniform(-0.3, 0.3, (r, 3)).astype(
        np.float32)
    to[:, 0] = 0.0
    d = to - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_term_tau_culls_occluded_ray_segments():
    """Segments behind the opaque wall leave stage 1 while the render
    equals the un-culled one; a zero density cache (before the first
    prune) culls nothing; the packed grid equals the JAX package's and a
    stashed one culls the same."""
    js, ts, jc, tc = two_wall_states()
    o, d = _axis_rays()
    rays = tmake_rays(o, d, 0.0, 4.0)
    u = torch.as_tensor(np.random.RandomState(5).rand(32, 256).astype(
        np.float32))
    base = dict(num_steps=256, max_samples=4096, segment_size=8,
                seg_budget=1024, coarse_level=4, seg_dilation=2)

    def run(state, term_tau):
        tt = trt.RFTracerConfig(**base, term_tau=term_tau)
        out = trt.trace(_wall_field, state, tc, tt, rays, u)
        _, _, mask_c = trt.coarse_segment_live(state, tc, tt, rays, u)
        return out, int(mask_c.sum())

    out0, live0 = run(ts, 0.0)
    out1, live1 = run(ts, 11.0)
    assert live1 < live0
    for ch in ('rgb', 'alpha', 'depth'):
        torch.testing.assert_close(out1[ch], out0[ch], rtol=0, atol=1e-4)
    _, live_z = run({**ts, 'density': torch.zeros_like(ts['density'])}, 11.0)
    assert live_z == live0
    tt = trt.RFTracerConfig(**base, term_tau=11.0)
    packed = trt.coarse_packed_grid(ts, tc, tt)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jrt.coarse_packed_grid(js, jc, jrt.RFTracerConfig(**base,
                                                          term_tau=11.0))))
    _, _, mask_p = trt.coarse_segment_live({**ts, 'coarse2': packed}, tc, tt,
                                           rays, u)
    assert int(mask_p.sum()) == live1
    want = jrt.coarse_segment_live(js, jc, jrt.RFTracerConfig(
        **base, term_tau=11.0), jmake_rays(o, d, 0.0, 4.0),
        jnp.asarray(u.numpy()))[2]
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(want))
