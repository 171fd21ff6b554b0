"""Port parity for the 'voxel' branches of the tracer against
shacira_tpu.tracers.rf_tracer: the transmittance culling of DDA crossings
(``voxel_term_mask``, ``crossing_term_mask``), the dense voxel trace (every
sample, and compacted to ``max_samples``) and the paged fused trace
(``_trace_voxel_fused`` into ``_trace_paged``), on analytic fields with the
same jitter on both sides.

Tolerances: the kept crossings and the fused stage 2's crossings and rays
exactly, its depths and sample points 1e-6; rendered rgb,
alpha and depth to 1e-4 (f32 integration in another summation order, and
sample positions one FMA rounding apart); the paged trace against the
dense one to 1e-4 when the budgets cover every live crossing, as
tests/test_nerf.py holds the JAX package's two paths.
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

LEVEL = 4
R, I, S = 32, 32, 8
BASE = dict(raymarch_type='voxel', num_steps=S, bg_color='white',
            max_intersections=I)
PAGED = dict(BASE, max_samples=4096, eval_seg_budget=512,
             group_segs_per_block=8)


def _scene(density_scale: float = 0.0):
    """A sphere of occupied cells (res 16) with a cached density of
    ``density_scale`` in them, rays from one side (numpy), jitter."""
    res = 2 ** LEVEL
    g = np.linspace(-1, 1, res, endpoint=False) + 1.0 / res
    xx, yy, zz = np.meshgrid(g, g, g, indexing='ij')
    occ_np = (xx ** 2 + yy ** 2 + zz ** 2) < 0.55 ** 2
    dens = occ_np.astype(np.float32) * density_scale
    rng = np.random.RandomState(5)
    o = np.asarray([[2.0, 0.3, 0.1]], np.float32) + np.zeros((R, 3),
                                                             np.float32)
    d = rng.uniform(-0.7, 0.7, (R, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = rng.rand(R, I, S).astype(np.float32)
    jstate = {'occ': jnp.asarray(occ_np), 'density': jnp.asarray(dens)}
    tstate = {'occ': torch.as_tensor(occ_np), 'density': torch.as_tensor(dens)}
    return o, d, u, jstate, tstate


def _split(xp):
    """(zbar_fn, finish_fn, head_fn) of an analytic field in ``xp``."""
    cat = jnp.concatenate if xp is jnp else torch.cat

    def zbar_fn(coords, grouping):
        return xp.sin(2.0 * coords)

    def finish_fn(zbar_c, coords_c):
        return cat([zbar_c, coords_c ** 2], -1)

    def head_fn(feats, dirs):
        color = 0.5 + 0.4 * xp.tanh(feats[..., :3] + dirs)
        s = feats[..., 3:].sum(-1)[..., None]
        return color, 3.0 / (1.0 + xp.exp(-s))
    return zbar_fn, finish_fn, head_fn


def _field(xp):
    zbar_fn, finish_fn, head_fn = _split(xp)

    def field_fn(coords, dirs):
        return head_fn(finish_fn(zbar_fn(coords, None), coords), dirs)
    return field_fn


def _jax_trace(tc, jstate, o, d, u, paged):
    cfg = jocc.OccupancyGridConfig(LEVEL)
    return jax.jit(lambda uu: jrt.trace(
        None if paged else _field(jnp), jstate, cfg, tc,
        jmake_rays(o, d, 0.0, 4.0), uu,
        encode_split=_split(jnp) if paged else None))(jnp.asarray(u))


def _port_trace(tc, tstate, o, d, u, paged):
    return trt.trace(None if paged else _field(torch), tstate,
                     tocc.OccupancyGridConfig(LEVEL), tc,
                     tmake_rays(torch.as_tensor(o), torch.as_tensor(d), 0.0,
                                4.0), torch.as_tensor(u),
                     encode_split=_split(torch) if paged else None)


def _close(got, want, atol=1e-4):
    for ch in ('rgb', 'alpha', 'depth'):
        np.testing.assert_allclose(got[ch].numpy(), np.asarray(want[ch]),
                                   rtol=0, atol=atol, err_msg=ch)
    np.testing.assert_array_equal(got['hit'].numpy(), np.asarray(want['hit']))


def test_jitter_shape_and_config():
    tc = trt.RFTracerConfig(**BASE)
    assert trt.march_jitter_shape(tc, R) == (R, I, S)
    assert trt.march_jitter_shape(
        trt.RFTracerConfig(**BASE, lean_stage1=True, fine_mode='deferred'),
        R) == (R, I, S)
    with pytest.raises(ValueError):
        trt.RFTracerConfig(raymarch_type='cone')


@pytest.mark.parametrize('term_tau', [0.5, 3.0, 11.5])
def test_term_masks_match_jax_and_each_other(term_tau):
    """Both culls keep the same crossings, bit for bit, on each side."""
    o, d, u, jstate, tstate = _scene(density_scale=20.0)
    cfg_j, cfg_t = jocc.OccupancyGridConfig(LEVEL), tocc.OccupancyGridConfig(
        LEVEL)
    jrays = jmake_rays(o, d, 0.0, 4.0)
    trays = tmake_rays(torch.as_tensor(o), torch.as_tensor(d), 0.0, 4.0)
    jm = jocc.raymarch_voxel(jstate, cfg_j, jrays, S, jnp.asarray(u), I)
    jc = jocc.voxel_crossings(jstate, cfg_j, jrays, I)
    want_v = jrt.voxel_term_mask(jstate, cfg_j, jm, R, I, S, term_tau)
    want_c = jrt.crossing_term_mask(jstate, cfg_j, jc['entries'],
                                    jc['exits'], jc['valid'], jrays,
                                    jnp.asarray(u[..., S // 2]), S, term_tau)
    tm = tocc.raymarch_voxel(tstate, cfg_t, trays, S, torch.as_tensor(u), I)
    tc = tocc.voxel_crossings(tstate, cfg_t, trays, I)
    got_v = trt.voxel_term_mask(tstate, cfg_t, tm, R, I, S, term_tau)
    got_c = trt.crossing_term_mask(tstate, cfg_t, tc['entries'], tc['exits'],
                                   tc['valid'], trays,
                                   torch.as_tensor(u[..., S // 2]), S,
                                   term_tau)
    np.testing.assert_array_equal(np.asarray(want_v), np.asarray(want_c))
    np.testing.assert_array_equal(got_v.numpy(), got_c.numpy())
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    live = tc['valid']
    culled = int((live & ~got_v).sum())
    assert culled > 0 and culled < int(live.sum())


@pytest.mark.parametrize('term_tau', [0.0, 11.5])
def test_dense_voxel_trace_matches_jax(term_tau):
    o, d, u, jstate, tstate = _scene(density_scale=30.0)
    jtc = jrt.RFTracerConfig(**BASE, term_tau=term_tau)
    ttc = trt.RFTracerConfig(**BASE, term_tau=term_tau)
    want = _jax_trace(jtc, jstate, o, d, u, paged=False)
    got = _port_trace(ttc, tstate, o, d, u, paged=False)
    _close(got, want)
    assert float(got['alpha'].max()) > 0.5


def test_compact_voxel_trace_matches_jax():
    """``max_samples`` below R * I * S: the occupied samples compacted."""
    o, d, u, jstate, tstate = _scene()
    kw = dict(BASE, max_samples=2048)
    want = _jax_trace(jrt.RFTracerConfig(**kw), jstate, o, d, u, False)
    got = _port_trace(trt.RFTracerConfig(**kw), tstate, o, d, u, False)
    _close(got, want)


@pytest.mark.parametrize('term_tau', [0.0, 11.5])
def test_paged_voxel_trace_matches_jax_and_the_dense_trace(term_tau):
    o, d, u, jstate, tstate = _scene(density_scale=30.0)
    groupings = {}
    zbar_fn, finish_fn, head_fn = _split(torch)

    def recording_zbar(coords, grouping):
        groupings['torch'] = grouping
        return zbar_fn(coords, grouping)

    ttc = trt.RFTracerConfig(**PAGED, term_tau=term_tau)
    got = trt.trace(None, tstate, tocc.OccupancyGridConfig(LEVEL), ttc,
                    tmake_rays(torch.as_tensor(o), torch.as_tensor(d), 0.0,
                               4.0), torch.as_tensor(u),
                    encode_split=(recording_zbar, finish_fn, head_fn))
    want = _jax_trace(jrt.RFTracerConfig(**PAGED, term_tau=term_tau),
                      jstate, o, d, u, paged=True)
    _close(got, want)
    # every live crossing fits the budgets: the dense trace renders the same
    dense = _port_trace(trt.RFTracerConfig(**BASE, term_tau=term_tau),
                        tstate, o, d, u, paged=False)
    _close(got, {k: v.numpy() for k, v in dense.items()})
    assert int(groupings['torch']['cell_used'].sum()) > 2
    assert float(got['alpha'].max()) > 0.5


def test_fused_stage2_rows_match_jax():
    """The fused stage 2's segment rows: same crossings kept (stride
    compaction on the flat (ray, crossing) axis), same rays, depths."""
    o, d, u, jstate, tstate = _scene(density_scale=30.0)
    kw = dict(PAGED, eval_seg_budget=64, term_tau=11.5)   # stride-drops
    want = jrt._trace_voxel_fused(jstate, jocc.OccupancyGridConfig(LEVEL),
                                  jrt.RFTracerConfig(**kw),
                                  jmake_rays(o, d, 0.0, 4.0), jnp.asarray(u))
    got = trt._trace_voxel_fused(tstate, tocc.OccupancyGridConfig(LEVEL),
                                 trt.RFTracerConfig(**kw),
                                 tmake_rays(torch.as_tensor(o),
                                            torch.as_tensor(d), 0.0, 4.0),
                                 torch.as_tensor(u))
    for k in ('valid', 'ray', 'fine'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ('depth', 'deltas', 'samples', 'dirs'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # more live crossings than 64: every second one kept
    assert 32 < int(got['valid'].sum()) < 64
