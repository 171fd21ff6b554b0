"""Port parity for the trainer's adaptive budgets, its LOD curricula and the
sustained paged step (lean stage 1, two-level cull, ``term_tau``) against
shacira_tpu.trainers.multiview_trainer.

Tolerances: budgets, LOD masks, ray batches and probe fractions exactly
(the probes are means of boolean masks over the same samples); the step
with a LOD mask as ``tests/test_torch_paged_step.py``'s two Adam steps
(loss rtol 1e-5, Adam first moments rtol 2e-3 / atol 1e-4 of each leaf's
largest entry, parameters 5e-5 absolute), with the JAX paged kernels in
interpret mode and in f32.
"""
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.core import schedulers as jsched  # noqa: E402
from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu_torch.core import schedulers as tsched  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)

from tests.test_torch_paged_step import (  # noqa: E402
    TRACE, TRAIN, _model_cfgs, f32_paged_kernels)  # noqa: F401
from tests.test_torch_step import (  # noqa: E402
    TINY, _cfgs, _leaves, _scene, _tleaves)

SUSTAINED = dict(TRACE, lean_stage1=True, super_factor=4, term_tau=11.5)
ADAPT = dict(adaptive_budget=True, min_budget=256)


def _sphere(level, radius):
    res = 2 ** level
    g = np.linspace(-1, 1, res, endpoint=False) + 1.0 / res
    xx, yy, zz = np.meshgrid(g, g, g, indexing='ij')
    return (xx ** 2 + yy ** 2 + zz ** 2) < radius ** 2


def _on_ladder(v: int) -> bool:
    """``v`` is 2^k or 1.5 * 2^k."""
    pow2 = lambda x: x > 0 and x & (x - 1) == 0  # noqa: E731
    return pow2(v) or (v % 3 == 0 and pow2(v // 3))


def _set_occupancy(jtr, ttr, occ, density):
    """The same occupancy and density cache on both trainers, with their
    derived grids refreshed."""
    dens = occ.astype(np.float32) * density
    if jtr is not None:
        jtr.occ_state = {**jtr.occ_state, 'occ': jnp.asarray(occ),
                         'density': jnp.asarray(dens)}
        jtr._refresh_coarse()
    ttr.occ_state = {**ttr.occ_state, 'occ': torch.as_tensor(occ),
                     'density': torch.as_tensor(dens)}
    ttr._refresh_coarse()


@pytest.fixture(scope='module')
def paged_pair():
    """A JAX and a port trainer of the sustained paged config, seed 0."""
    jdata, tdata = _scene(num_views=4, res=16)
    jm, tm = _model_cfgs()
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN, **ADAPT),
        jm, jrt.RFTracerConfig(**SUSTAINED), jdata, num_rays=64, seed=0)
    ttr = tmt.MultiviewTrainer(tmt.MultiviewTrainerConfig(**TRAIN, **ADAPT),
                               tm, trt.RFTracerConfig(**SUSTAINED), tdata,
                               num_rays=64, seed=0, device='cpu')
    return jtr, ttr


def test_sustained_trainer_setup_matches_jax(paged_pair):
    jtr, ttr = paged_pair
    assert ttr.tracer_cfg.super_dilation == jtr.tracer_cfg.super_dilation == 1
    for f in ('coarse', 'coarse2', 'super'):
        np.testing.assert_array_equal(ttr.occ_state[f].numpy(),
                                      np.asarray(jtr.occ_state[f]),
                                      err_msg=f)
    assert ttr.occ_state['coarse2'].shape[-1] == 2
    assert trt.march_jitter_shape(ttr.active_tracer_cfg, 64) == (2,)


@pytest.mark.parametrize('sample_frac,seg_frac', [
    (1.0, 1.0), (0.3, 0.4), (0.05, 0.07), (0.011, 0.02), (0.002, 0.001),
    (0.0, 0.0)])
def test_adapted_budgets_equal_jax(paged_pair, sample_frac, seg_frac):
    """The same probe fractions give the JAX trainer's budgets, on the
    {2^k, 1.5 * 2^k} ladder and capped at the base budgets."""
    jtr, ttr = paged_pair
    for tr in paged_pair:
        tr._occupied_sample_fraction = lambda: sample_frac
        tr._live_segment_fraction = lambda: seg_frac
        tr._adapt_budget()
    fields = ('max_samples', 'seg_budget', 'eval_seg_budget')
    got = [getattr(ttr.active_tracer_cfg, f) for f in fields]
    assert got == [getattr(jtr.active_tracer_cfg, f) for f in fields]
    base = [getattr(ttr.tracer_cfg, f) for f in fields]
    assert all(g <= b for g, b in zip(got, base))
    assert all(_on_ladder(v) for v in got), got


def test_flat_budgets_equal_jax():
    """Without a segmented march only the sample budget adapts."""
    jdata, tdata = _scene(num_views=4, res=8)
    jm, jt, jc, tm, tt, tc = _cfgs(max_samples=4096)
    jtr = jmt.MultiviewTrainer(replace(jc, **ADAPT), jm, jt, jdata,
                               num_rays=64, seed=0)
    ttr = tmt.MultiviewTrainer(replace(tc, **ADAPT), tm, tt, tdata,
                               num_rays=64, seed=0, device='cpu')
    for frac in (0.9, 0.2, 0.031, 0.0):
        for tr in (jtr, ttr):
            tr._occupied_sample_fraction = lambda: frac
            tr._adapt_budget()
        assert ttr.active_tracer_cfg == replace(
            tt, max_samples=jtr.active_tracer_cfg.max_samples)
    assert [tmt.budget_rung(x) for x in (1, 300, 384, 385, 513, 700, 768,
                                         769, 3000, 4096, 4097)] \
        == [1, 384, 384, 512, 768, 768, 768, 1024, 3072, 4096, 6144]


def test_probes_match_jax():
    """Occupied-sample and live-segment (term_tau included) fractions on
    the trainer's next ray batch, with the jitter injected."""
    jdata, tdata = _scene(num_views=4, res=16)
    jm, tm = _model_cfgs()
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN, **ADAPT),
        jm, jrt.RFTracerConfig(**SUSTAINED), jdata, num_rays=64, seed=4)
    ttr = tmt.MultiviewTrainer(tmt.MultiviewTrainerConfig(**TRAIN, **ADAPT),
                               tm, trt.RFTracerConfig(**SUSTAINED), tdata,
                               num_rays=64, seed=4, device='cpu')
    _set_occupancy(jtr, ttr, _sphere(5, 0.6), 40.0)
    u = np.random.RandomState(2).rand(64, TRACE['num_steps']).astype(
        np.float32)
    fracs = [ttr._occupied_sample_fraction(torch.as_tensor(u)),
             ttr._live_segment_fraction(torch.as_tensor(u))]
    # the JAX probes' bodies on the next two ray batches, the same jitter
    def next_rays():
        ro, rd, _ = jtr._presample(1)
        return jmake_rays(ro[0], rd[0], jdata.dist_min, jdata.dist_max)

    mask = jocc.raymarch_ray(jtr.occ_state, jm.occ_cfg, next_rays(),
                             TRACE['num_steps'], jnp.asarray(u))['mask']
    mask_c = jrt.coarse_segment_live(jtr.occ_state, jm.occ_cfg,
                                     jtr.tracer_cfg, next_rays(),
                                     jnp.asarray(u))[2]
    want = [float(jnp.mean(m.astype(jnp.float32))) for m in (mask, mask_c)]
    np.testing.assert_allclose(fracs, want, rtol=1e-6)
    assert 0.0 < fracs[0] < 1.0 and 0.0 < fracs[1] < 1.0
    # transmittance culling lowered the live-segment fraction
    unculled = ttr.tracer_cfg
    ttr.tracer_cfg = replace(unculled, term_tau=0.0)
    assert ttr._live_segment_fraction(torch.as_tensor(u)) > fracs[1]
    ttr.tracer_cfg = unculled


def test_segment_budgets_shrink_after_an_occupancy_collapse():
    """A pruned-down scene shrinks all three budgets on the ladder, with
    max_samples <= eval_seg_budget * segment_size, and the step runs at
    them."""
    _, tdata = _scene(num_views=4, res=16)
    _, tm = _model_cfgs()
    tr = tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**TRAIN, **ADAPT), tm,
        trt.RFTracerConfig(**dict(SUSTAINED, max_samples=8192,
                                  seg_budget=4096, eval_seg_budget=2048)),
        tdata, num_rays=64, seed=0, device='cpu')
    _set_occupancy(None, tr, _sphere(5, 0.2), 40.0)
    tr._adapt_budget()
    act, base = tr.active_tracer_cfg, tr.tracer_cfg
    assert act.eval_seg_budget < base.eval_seg_budget
    assert act.seg_budget < base.seg_budget
    assert act.max_samples < base.max_samples
    assert act.max_samples <= act.eval_seg_budget * act.segment_size
    assert all(_on_ladder(v) for v in (act.max_samples, act.seg_budget,
                                       act.eval_seg_budget))
    assert (act.lean_stage1, act.super_factor, act.term_tau) == (True, 4,
                                                                 11.5)
    log = []
    tr.train(num_iterations=2, log_fn=log.append)
    assert np.isfinite(log[-1]['loss'])


def test_sample_budget_shrinks_after_a_prune():
    """The hook after the prune: a prune threshold just under the field's
    largest density empties ~94 % of the cells, and the step's sample
    budget shrinks with them (the log carries it)."""
    _, tdata = _scene(num_views=4, res=16)
    _, tm = _model_cfgs()
    tr = tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**{**TRAIN, **ADAPT, 'prune_every': 4,
                                      'chunk_size': 4}),
        replace(tm, prune_min_density=0.85),
        trt.RFTracerConfig(**dict(SUSTAINED, max_samples=8192,
                                  seg_budget=4096, eval_seg_budget=2048)),
        tdata, num_rays=64, seed=0, device='cpu')
    log = []
    tr.train(num_iterations=4, log_fn=log.append)
    assert log[-1]['occupancy'] < 0.1
    assert tr.active_tracer_cfg.max_samples < tr.tracer_cfg.max_samples
    assert _on_ladder(tr.active_tracer_cfg.max_samples)
    assert log[-1]['sample_budget'] == tr.active_tracer_cfg.max_samples


def test_flat_sample_budget_shrinks_after_an_occupancy_collapse():
    """The flat march: only ``max_samples`` adapts; it shrinks when the
    occupancy collapses to a small sphere, and training goes on at it."""
    _, tdata = _scene(num_views=4, res=8)
    *_, tm, tt, tc = _cfgs(max_samples=8192)
    tr = tmt.MultiviewTrainer(replace(tc, **ADAPT), tm, tt, tdata,
                              num_rays=64, seed=0, device='cpu')
    tr._adapt_budget()
    full = tr.active_tracer_cfg.max_samples       # rays leave the cube
    _set_occupancy(None, tr, _sphere(3, 0.3), 0.0)
    tr._adapt_budget()
    act = tr.active_tracer_cfg
    assert 256 <= act.max_samples < full <= 8192
    assert _on_ladder(act.max_samples)
    assert act == replace(tt, max_samples=act.max_samples)
    log = []
    tr.train(num_iterations=3, log_fn=log.append)
    assert np.isfinite(log[-1]['loss'])


def test_trainer_with_term_tau_and_adaptive_budgets_trains():
    """Two prunes of the sustained config: the packed and super grids
    follow the pruned occupancy, the logged budget is the active one,
    evaluation renders with the base config."""
    _, tdata = _scene(num_views=4, res=16)
    _, tm = _model_cfgs()
    tr = tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**{**TRAIN, **ADAPT, 'prune_every': 4,
                                      'chunk_size': 4}),
        tm, trt.RFTracerConfig(**SUSTAINED), tdata, num_rays=64, seed=0,
        device='cpu')
    log = []
    tr.train(num_iterations=8, log_fn=log.append)
    assert [e['iteration'] for e in log] == [4, 8]
    assert all(np.isfinite(e['loss']) for e in log)
    assert log[-1]['sample_budget'] == tr.active_tracer_cfg.max_samples
    base = {k: v for k, v in tr.occ_state.items()
            if k in ('occ', 'density')}
    assert torch.equal(tr.occ_state['coarse2'], trt.coarse_packed_grid(
        base, tm.occ_cfg, tr.tracer_cfg))
    assert torch.equal(tr.occ_state['super'], trt.super_grid(
        base, tm.occ_cfg, tr.tracer_cfg))
    assert float(tr.occ_state['density'].max()) > 0.0
    assert np.isfinite(tr.render_view(0)).all()


@pytest.mark.parametrize('strategy', ['onebyone', 'increase', 'shrink',
                                      'finetocoarse', 'onlylast'])
def test_grow_loss_lods_matches_jax(strategy):
    for epoch in range(0, 14):
        assert tsched.grow_loss_lods(epoch, 5, 3, strategy) \
            == jsched.grow_loss_lods(epoch, 5, 3, strategy)
    with pytest.raises(NotImplementedError):
        tsched.grow_loss_lods(1, 5, 3, 'nope')


def test_random_lod_masks_and_ray_batches_follow_the_jax_stream():
    """random_lod draws a chunk's max LODs from the ray stream before its
    ray batches, as the JAX trainer does: the same masks, then the same
    rays."""
    jdata, tdata = _scene(num_views=4, res=8)
    jm, jt, jc, tm, tt, tc = _cfgs(max_samples=4096)
    jtr = jmt.MultiviewTrainer(replace(jc, random_lod=True), jm, jt, jdata,
                               num_rays=32, seed=5)
    ttr = tmt.MultiviewTrainer(replace(tc, random_lod=True), tm, tt, tdata,
                               num_rays=32, seed=5, device='cpu')
    n, num_lods = 12, jm.grid.num_lods
    w = 2.0 ** np.arange(num_lods)
    lods = jtr.np_rng.choice(num_lods, size=n, p=w / w.sum())  # train():737
    want = (np.arange(num_lods)[None, :] <= lods[:, None]).astype(np.float32)
    got = ttr._lod_masks(range(1, n + 1))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    for a, b in zip(ttr._presample(n), jtr._presample(n)):
        np.testing.assert_array_equal(a, b)


def test_grow_curriculum_masks_lods_and_trains():
    """grow_every: LOD masks grow with the epoch; training stays finite and
    renders with a LOD mask."""
    _, tdata = _scene(num_views=4, res=8)
    *_, tm, tt, tc = _cfgs(max_samples=4096)
    tr = tmt.MultiviewTrainer(
        replace(tc, grow_every=1, growth_strategy='increase',
                chunk_size=4), tm, tt, tdata, num_rays=64, seed=0,
        device='cpu')
    masks = tr._lod_masks(range(1, 13))
    # 4 views an epoch: iterations 1-3 epoch 1, 4-7 epoch 2, 8-11 epoch 3
    np.testing.assert_array_equal(masks.sum(-1),
                                  [2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 3])
    log = []
    tr.train(num_iterations=8, log_fn=log.append)
    assert all(np.isfinite(e['loss']) for e in log if 'loss' in e)
    img = tr.render_view(0, lod_mask=np.asarray([1, 0, 0], np.float32))
    full = tr.render_view(0)
    assert np.isfinite(img).all() and not np.array_equal(img, full)


def test_sustained_step_with_a_lod_mask_matches_jax(f32_paged_kernels):
    """One paged step in the sustained setting (lean stage 1, two-level
    cull, term_tau culling a dense sphere) at shrunk budgets, with a fixed
    LOD mask, against the JAX trainer's step."""
    jdata, tdata = _scene(num_views=4, res=16)
    jm, tm = _model_cfgs()
    rays = 64
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN), jm,
        jrt.RFTracerConfig(**SUSTAINED), jdata, num_rays=rays, seed=0)
    ttr = tmt.MultiviewTrainer(tmt.MultiviewTrainerConfig(**TRAIN), tm,
                               trt.RFTracerConfig(**SUSTAINED), tdata,
                               num_rays=rays, seed=0, device='cpu')
    _set_occupancy(jtr, ttr, _sphere(5, 0.6), 40.0)
    budgets = dict(max_samples=1024, seg_budget=512, eval_seg_budget=128)
    jtr.active_tracer_cfg = replace(jtr.tracer_cfg, **budgets)
    ttr.active_tracer_cfg = replace(ttr.tracer_cfg, **budgets)
    params = jax.tree.map(np.asarray, jtr.params)
    ttr.set_params(params_from_jax(params), adam_state_from_jax(
        jtr.opt_state.mu, jtr.opt_state.nu, jtr.opt_state.count))
    lod_mask = np.asarray([1, 1, 0, 1, 0], np.float32)
    ro, rd, gt = jtr._presample(1)
    key = jax.random.PRNGKey(9)
    sched = dict(ent_lambda=1e-3, temperature=0.8, lr_ldec=2e-3)
    p, o, _, metrics = jax.jit(jtr._raw_step(use_sga=True))(
        jtr.params, jtr.opt_state, jtr.noise, jtr.occ_state, None,
        jnp.asarray(ro[0]), jnp.asarray(rd[0]), jnp.asarray(gt[0]), key,
        jnp.float32(sched['ent_lambda']), jnp.float32(sched['temperature']),
        jnp.float32(sched['lr_ldec']), jnp.asarray(True),
        jnp.asarray(lod_mask))
    k_sga, k_noise, k_march = jax.random.split(key, 3)
    cb_shape = params['grid']['codebook'].shape
    draws = tmt.StepDraws(
        march_u=torch.as_tensor(np.array(jax.random.uniform(k_march, (2,)))),
        sga_u=torch.as_tensor(np.array(jax.random.uniform(
            k_sga, cb_shape, dtype=jnp.float32, minval=TINY, maxval=1.0))),
        noise=torch.as_tensor(np.array(
            jax.random.uniform(k_noise, cb_shape) - 0.5)))
    tmet = ttr.step(torch.as_tensor(ro[0]), torch.as_tensor(rd[0]),
                    torch.as_tensor(gt[0]), draws, use_sga=True,
                    lod_mask=torch.as_tensor(lod_mask), **sched)
    np.testing.assert_allclose(float(tmet['loss']), float(metrics['loss']),
                               rtol=1e-5)
    for got, want in zip(_tleaves(ttr.opt_state['mu']), _leaves(o.mu)):
        np.testing.assert_allclose(got, want, rtol=2e-3,
                                   atol=1e-4 * np.abs(want).max())
    for got, want in zip(_tleaves(ttr.params), _leaves(p)):
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # a masked LOD's rows get only the rate loss's gradient, an unmasked
    # one's the rendering loss's too
    first = tm.grid.spec.lod_first_idx
    mu = ttr.opt_state['mu']['grid']['codebook'].abs()
    assert float(mu[first[2]:first[3]].max()) \
        < 1e-2 * float(mu[first[3]:first[4]].max())
