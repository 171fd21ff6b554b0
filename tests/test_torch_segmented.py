"""Port parity for the segmented ``fine_mode='exact'`` march (coarse segment
cull, fine query of every sample of the live segments) on both layouts
against shacira_tpu.tracers.rf_tracer, and the port's own invariants:
segmented == dense with ample budgets, graceful truncation, deferred ==
exact.

Tolerances: rendered rgb, alpha and depth to rtol = atol = 1e-5 against the
JAX package (f32; the port's segmented prefix sum in float64); against the
port's own dense trace 1e-5 (depth 1e-4 relative, as the JAX package's test
of the same identity); the trainer step as ``tests/test_torch_step.py``
(loss rtol 1e-5, Adam first moments rtol 2e-3 / atol 1e-4 of each leaf's
largest entry, parameters 1e-5 absolute).
"""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays as tmake_rays  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)

from tests.test_torch_lean_march import (  # noqa: E402
    assert_render_close, scene_rays, sphere_states, split, trace_both)
from tests.test_torch_step import (  # noqa: E402
    TINY, _cfgs, _leaves, _scene, _tleaves)

S = 256
SEG = dict(num_steps=S, bg_color='white', segment_size=8, coarse_level=4,
           seg_dilation=2)
PAGED = dict(SEG, max_samples=4096, seg_budget=1024, eval_seg_budget=1024,
             group_segs_per_block=4)


def _fields():
    def jfield(c, d):
        dd = jnp.sum(c ** 2, -1, keepdims=True)
        return 0.5 + 0.4 * jnp.sin(3.0 * c + d), 4.0 * jnp.exp(-2.0 * dd)

    def tfield(c, d):
        dd = torch.sum(c ** 2, -1, keepdim=True)
        return 0.5 + 0.4 * torch.sin(3.0 * c + d), 4.0 * torch.exp(-2.0 * dd)

    return jfield, tfield


def _jitter(r=64, seed=7):
    return np.random.RandomState(seed).rand(r, S).astype(np.float32)


@pytest.mark.parametrize('max_samples,seg_budget', [
    (64 * S, 64 * S // 8), (2048, 512), (600, 96)])
def test_segmented_flat_trace_matches_jax(max_samples, seg_budget):
    """Flat layout (no encode split): ample budgets, then both compactions
    stride-dropping."""
    js, ts, jc, tc = sphere_states(density=0.0)
    o, d = scene_rays(64, seed=0)
    u = _jitter()
    kw = dict(SEG, max_samples=max_samples, seg_budget=seg_budget)
    jfield, tfield = _fields()
    want = jax.jit(lambda s, uu: jrt.trace(
        jfield, s, jc, jrt.RFTracerConfig(**kw), jmake_rays(o, d, 0.0, 4.0),
        uu))(js, jnp.asarray(u))
    got = trt.trace(tfield, ts, tc, trt.RFTracerConfig(**kw),
                    tmake_rays(o, d, 0.0, 4.0), torch.as_tensor(u))
    assert_render_close(got, want)
    assert float(got['alpha'].max()) > 0.25


def test_segmented_trace_matches_dense():
    """With budgets that hold every live sample, the segmented march renders
    what the dense march renders: it skips only samples of zero density."""
    _, ts, _, tc = sphere_states(density=0.0)
    o, d = scene_rays(64, seed=0)
    rays = tmake_rays(o, d, 0.0, 4.0)
    u = torch.as_tensor(_jitter())
    _, tfield = _fields()
    dense = trt.trace(tfield, ts, tc, trt.RFTracerConfig(
        num_steps=S, max_samples=64 * S), rays, u)
    seg = trt.trace(tfield, ts, tc, trt.RFTracerConfig(
        **SEG, max_samples=64 * S, seg_budget=64 * S // 8), rays, u)
    torch.testing.assert_close(seg['rgb'], dense['rgb'], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(seg['alpha'], dense['alpha'], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(seg['depth'], dense['depth'], rtol=1e-4,
                               atol=1e-5)


def test_segmented_trace_truncation_is_graceful():
    tc = tocc.OccupancyGridConfig(4)
    state = tocc.occupancy_init(tc, 'cpu')        # fully occupied
    o = np.zeros((32, 3), np.float32)
    o[:, 0] = 2.5
    d = np.zeros((32, 3), np.float32)
    d[:, 0] = -1.0

    def field(c, dirs):
        return torch.full(c.shape[:-1] + (3,), 0.5), \
            torch.ones(c.shape[:-1] + (1,))

    out = trt.trace(field, state, tc, trt.RFTracerConfig(
        num_steps=128, max_samples=256, segment_size=8, seg_budget=64,
        coarse_level=4, seg_dilation=2), tmake_rays(o, d, 0.0, 5.0),
        torch.as_tensor(np.random.RandomState(0).rand(32, 128).astype(
            np.float32)))
    assert bool(torch.isfinite(out['rgb']).all())
    assert float(out['alpha'].max()) <= 1.0 + 1e-5


@pytest.mark.parametrize('eval_seg_budget,group_seg_size', [
    (1024, 0), (1024, 4), (64, 0)])
def test_paged_exact_trace_matches_jax(eval_seg_budget, group_seg_size):
    """The paged trace over ``_stage2_take``'s segments, with ample and
    truncating second-stage budgets and sub-segment grouping."""
    kw = dict(PAGED, fine_mode='exact', eval_seg_budget=eval_seg_budget,
              group_seg_size=group_seg_size)
    got, want = trace_both(kw, _jitter(48, seed=11),
                           states=sphere_states(density=0.0))
    assert_render_close(got, want)


def test_deferred_matches_exact():
    """'deferred' renders what 'exact' renders when the second-stage budget
    holds the live segments; under truncation both stay composited."""
    _, ts, _, tc = sphere_states(density=0.0)
    o, d = scene_rays()
    rays = tmake_rays(o, d, 0.0, 4.0)
    u = torch.as_tensor(_jitter(48, seed=11))

    def run(mode, k2, gss=0):
        tt = trt.RFTracerConfig(**dict(PAGED, fine_mode=mode,
                                       eval_seg_budget=k2,
                                       group_seg_size=gss))
        return trt.trace(None, ts, tc, tt, rays, u, encode_split=split(torch))

    exact = run('exact', 1024)
    for out in (run('deferred', 1024), run('exact', 1024, gss=4)):
        for ch in ('rgb', 'alpha', 'depth'):
            torch.testing.assert_close(out[ch], exact[ch], rtol=1e-5,
                                       atol=1e-5)
    for mode in ('exact', 'deferred'):
        out = run(mode, 64)
        assert bool(torch.isfinite(out['rgb']).all())
        assert float(out['alpha'].max()) <= 1.0 + 1e-5


def test_two_adam_steps_of_the_flat_exact_march_match_jax():
    """The flat-layout trainer with the segmented 'exact' march: two Adam
    steps against the JAX package's step on the same draws."""
    jdata, tdata = _scene()
    jm, _, jc, tm, _, tc = _cfgs(max_samples=2048)
    kw = dict(num_steps=64, max_samples=2048, segment_size=8, seg_budget=256,
              coarse_level=3, seg_dilation=1)
    jt, tt = jrt.RFTracerConfig(**kw), trt.RFTracerConfig(**kw)
    rays = 64
    jtr = jmt.MultiviewTrainer(jc, jm, jt, jdata, num_rays=rays, seed=0)
    ttr = tmt.MultiviewTrainer(tc, tm, tt, tdata, num_rays=rays, seed=0,
                               device='cpu')
    assert not ttr.use_paged
    np.testing.assert_array_equal(ttr.occ_state['coarse'].numpy(),
                                  np.asarray(jtr.occ_state['coarse']))
    params = jax.tree.map(np.asarray, jtr.params)
    ttr.set_params(params_from_jax(params), adam_state_from_jax(
        jtr.opt_state.mu, jtr.opt_state.nu, jtr.opt_state.count))
    jstep = jax.jit(jtr._raw_step(use_sga=True))
    state = (jtr.params, jtr.opt_state, jtr.noise)
    cb_shape = params['grid']['codebook'].shape
    lod_mask = jnp.ones((jm.grid.num_lods,), jnp.float32)
    ro, rd, gt = jtr._presample(2)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(3), 2)):
        sched = dict(ent_lambda=1e-3, temperature=0.8, lr_ldec=2e-3)
        p, o, n, metrics = jstep(
            *state, jtr.occ_state, None, jnp.asarray(ro[i]),
            jnp.asarray(rd[i]), jnp.asarray(gt[i]), key,
            jnp.float32(sched['ent_lambda']),
            jnp.float32(sched['temperature']),
            jnp.float32(sched['lr_ldec']), jnp.asarray(True), lod_mask)
        state = (p, o, n)
        k_sga, k_noise, k_march = jax.random.split(key, 3)
        draws = tmt.StepDraws(
            march_u=torch.as_tensor(np.array(jax.random.uniform(
                k_march, (rays, jt.num_steps)))),
            sga_u=torch.as_tensor(np.array(jax.random.uniform(
                k_sga, cb_shape, dtype=jnp.float32, minval=TINY,
                maxval=1.0))),
            noise=torch.as_tensor(np.array(
                jax.random.uniform(k_noise, cb_shape) - 0.5)))
        tmet = ttr.step(torch.as_tensor(ro[i]), torch.as_tensor(rd[i]),
                        torch.as_tensor(gt[i]), draws, use_sga=True, **sched)
        np.testing.assert_allclose(float(tmet['loss']),
                                   float(metrics['loss']), rtol=1e-5)
        for got, want in zip(_tleaves(ttr.opt_state['mu']), _leaves(o.mu)):
            np.testing.assert_allclose(got, want, rtol=2e-3,
                                       atol=1e-4 * np.abs(want).max())
        for got, want in zip(_tleaves(ttr.params), _leaves(p)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_paged_exact_trainer_crosses_a_prune_and_evaluates_on_cpu():
    from tests.test_torch_paged_step import TRACE, TRAIN, _model_cfgs
    _, tdata = _scene(num_views=4, res=12)
    _, tm = _model_cfgs()
    tc = tmt.MultiviewTrainerConfig(**{**TRAIN, 'prune_every': 3,
                                       'chunk_size': 4})
    tr = tmt.MultiviewTrainer(tc, tm, trt.RFTracerConfig(
        **dict(TRACE, fine_mode='exact')), tdata, num_rays=64, seed=2,
        device='cpu')
    assert tr.use_paged and tr.tracer_cfg.fine_mode == 'exact'
    log = []
    tr.train(num_iterations=4, log_fn=log.append)
    assert [e['iteration'] for e in log] == [3, 4]
    assert all(np.isfinite(e['loss']) for e in log)
    assert float(tr.occ_state['density'].max()) > 0.0        # prune ran
    assert np.isfinite(tr.evaluate([0])['psnr'])
