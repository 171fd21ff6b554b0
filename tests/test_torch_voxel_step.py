"""Port parity for the trainer on the 'voxel' march against
shacira_tpu.trainers.multiview_trainer, at V8's latent width (latent_dim
2): two Adam steps on the flat layout (dense integration of every sample)
and on the paged one (the fused crossing compaction, grouping and the
block-local encode, with transmittance culling), the live-crossing probe,
the adapted budgets for injected fractions, and a short paged voxel run.

Tolerances as tests/test_torch_paged_step.py: loss rtol 1e-5, Adam first
moments rtol 2e-3 / atol 1e-4 of each leaf's largest entry, parameters
5e-5 absolute (1e-5 on the flat layout, as tests/test_torch_step.py); the
JAX paged kernels in interpret mode and in f32.  Budgets and the probe
exactly (a mean of boolean masks over the same crossings).
"""
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.nefs import nerf as jnerf  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.nefs import nerf as tnerf  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)

from tests.test_torch_budget import _on_ladder, _sphere  # noqa: E402
from tests.test_torch_paged_step import f32_paged_kernels  # noqa: E402,F401
from tests.test_torch_step import (  # noqa: E402
    TINY, _leaves, _scene, _tleaves)

LDEC = dict(ldec_std=0.1, use_shift=True, use_sga=True, diff_sampling=True)
FLAT_GRID = dict(feature_dim=2, num_lods=3, min_grid_res=4, max_grid_res=24,
                 latent_dim=2, multiscale_type='cat', feature_std=0.3,
                 codebook_bitwidth=9, entropy_enabled=True, num_prob_layers=1)
# 3 direct LODs and 2 paged ones; a crossing spans one cell of the 128^3
# occupancy grid, which the paged cover needs (as tests/test_paged_hash.py)
PAGED_GRID = dict(FLAT_GRID, num_lods=5, min_grid_res=16, max_grid_res=96,
                  codebook_bitwidth=17, hash_layout='paged', page_res=16)
FLAT_TRACE = dict(raymarch_type='voxel', num_steps=4, max_intersections=12)
PAGED_TRACE = dict(raymarch_type='voxel', num_steps=8, max_intersections=24,
                   max_samples=4096, eval_seg_budget=256,
                   group_segs_per_block=4, term_tau=11.5)
TRAIN = dict(epochs=20, prune_every=-1, lr=5e-3, grid_lr=0.02, ldec_lr=0.01,
             scale_grid_lr='div', entropy_reg=1e-3, entropy_reg_end=1e-3)
ADAPT = dict(adaptive_budget=True, min_budget=512)
RAYS = 64


def _model_cfgs(paged: bool):
    grid = PAGED_GRID if paged else FLAT_GRID
    kw = dict(hidden_dim=16, view_embedder='positional',
              blas_level=7 if paged else 4)
    return (jnerf.NeuralRadianceFieldConfig(
                grid=jlg.LatentGridConfig.from_geometric(**grid).with_ldec(
                    LDEC), **kw),
            tnerf.NeuralRadianceFieldConfig(
                grid=tlg.LatentGridConfig.from_geometric(**grid).with_ldec(
                    LDEC), **kw))


def _pair(paged: bool, trace=None, seed=0, **train):
    jdata, tdata = _scene(num_views=4, res=16)
    jm, tm = _model_cfgs(paged)
    trace = trace or (PAGED_TRACE if paged else FLAT_TRACE)
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN, **train),
        jm, jrt.RFTracerConfig(**trace), jdata, num_rays=RAYS, seed=seed)
    ttr = tmt.MultiviewTrainer(tmt.MultiviewTrainerConfig(**TRAIN, **train),
                               tm, trt.RFTracerConfig(**trace), tdata,
                               num_rays=RAYS, seed=seed, device='cpu')
    return jtr, ttr


def _set_occupancy(jtr, ttr, occ, density):
    dens = occ.astype(np.float32) * density
    jtr.occ_state = {**jtr.occ_state, 'occ': jnp.asarray(occ),
                     'density': jnp.asarray(dens)}
    ttr.set_occupancy({'occ': torch.as_tensor(occ),
                       'density': torch.as_tensor(dens)})


def _two_steps(jtr, ttr, param_atol):
    params = jax.tree.map(np.asarray, jtr.params)
    ttr.set_params(params_from_jax(params), adam_state_from_jax(
        jtr.opt_state.mu, jtr.opt_state.nu, jtr.opt_state.count))
    jstep = jax.jit(jtr._raw_step(use_sga=True))
    state = (jtr.params, jtr.opt_state, jtr.noise)
    cb_shape = params['grid']['codebook'].shape
    lod_mask = jnp.ones((jtr.model_cfg.grid.num_lods,), jnp.float32)
    jitter_shape = jrt.march_jitter_shape(jtr.tracer_cfg, RAYS)
    assert jitter_shape == trt.march_jitter_shape(ttr.tracer_cfg, RAYS)
    ro, rd, gt = jtr._presample(2)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(5), 2)):
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
                k_march, jitter_shape))),
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
            np.testing.assert_allclose(got, want, rtol=0, atol=param_atol)


def test_flat_voxel_steps_match_jax():
    """Dense voxel integration (no max_samples) on the flat layout."""
    jtr, ttr = _pair(paged=False)
    assert not ttr.use_paged and ttr.model_cfg.grid.latent_dim == 2
    _two_steps(jtr, ttr, param_atol=1e-5)
    # the step reached the codebook through the DDA's samples
    assert float(ttr.opt_state['mu']['grid']['codebook'].abs().max()) > 0


def test_paged_voxel_steps_match_jax(f32_paged_kernels):
    """The paged voxel step with transmittance culling on a sphere of
    occupied cells carrying a density cache (so crossings are culled)."""
    jtr, ttr = _pair(paged=True)
    assert ttr.use_paged and ttr.voxel
    _set_occupancy(jtr, ttr, _sphere(7, 0.55), 40.0)
    _two_steps(jtr, ttr, param_atol=5e-5)
    spec = ttr.model_cfg.grid.spec
    lo = spec.lod_first_idx[3]            # the paged LODs' rows moved
    assert float(ttr.opt_state['mu']['grid']['codebook'][lo:].abs().max()) > 0


def test_paged_voxel_cover_is_checked():
    """A coarse occupancy grid (res 32) gives crossings longer than the
    paged cover allows: the trainer refuses, as the JAX one does."""
    _, tdata = _scene(num_views=2, res=8)
    _, tm = _model_cfgs(paged=True)
    tm = replace(tm, blas_level=5)
    with pytest.raises(ValueError, match='paged cover'):
        tmt.MultiviewTrainer(tmt.MultiviewTrainerConfig(**TRAIN), tm,
                             trt.RFTracerConfig(**PAGED_TRACE), tdata,
                             num_rays=RAYS, device='cpu')


def test_live_cell_probe_matches_jax():
    """Live crossings per ray (term_tau included) on the trainer's next ray
    batch, the jitter injected; culling lowers it."""
    jtr, ttr = _pair(paged=True, seed=4, **ADAPT)
    _set_occupancy(jtr, ttr, _sphere(7, 0.55), 40.0)
    I, S = PAGED_TRACE['max_intersections'], PAGED_TRACE['num_steps']
    u = np.random.RandomState(2).rand(RAYS, I, S).astype(np.float32)
    ray_stream = ttr.np_rng.get_state()
    got = ttr._live_cell_hits_per_ray(torch.as_tensor(u))
    ro, rd, _ = jtr._presample(1)
    rays = jmake_rays(ro[0], rd[0], jtr.dataset.dist_min,
                      jtr.dataset.dist_max)
    ocfg = jtr.model_cfg.occ_cfg

    @jax.jit
    def jax_probe(state, r, uu):
        m = jocc.raymarch_voxel(state, ocfg, r, S, uu, I)
        keep = jrt.voxel_term_mask(state, ocfg, m, RAYS, I, S, 11.5)
        live = m['mask'].reshape(RAYS, I, S) & keep[..., None]
        return jnp.mean(jnp.sum(live.any(-1).astype(jnp.float32), -1))

    want = float(jax_probe(jtr.occ_state, rays, jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert 1.0 < got < I
    ttr.tracer_cfg = replace(ttr.tracer_cfg, term_tau=0.0)
    ttr.np_rng.set_state(ray_stream)            # the same ray batch
    assert ttr._live_cell_hits_per_ray(torch.as_tensor(u)) > got


@pytest.fixture(scope='module')
def adaptive_pair():
    """A JAX and a port trainer of the paged voxel config with adaptive
    budgets (each test installs its own occupancy)."""
    return _pair(paged=True, **ADAPT)


@pytest.mark.parametrize('occ_cells,hits', [
    (128 ** 3, 24.0), (300_000, 10.5), (40_000, 3.2), (2_000, 0.4), (0, 0.0)])
def test_voxel_budgets_equal_jax(adaptive_pair, occ_cells, hits):
    """The occupied cell fraction (read from the grid) and injected live
    crossings per ray give the JAX trainer's budgets: on the ladder, capped
    at base, ``max_samples <= eval_seg_budget * num_steps``."""
    jtr, ttr = adaptive_pair
    occ = np.zeros(128 ** 3, bool)
    occ[np.random.RandomState(1).permutation(128 ** 3)[:occ_cells]] = True
    _set_occupancy(jtr, ttr, occ.reshape((128,) * 3), 1.0)
    for tr in (jtr, ttr):
        tr._live_cell_hits_per_ray = lambda: hits
        tr._adapt_budget()
    fields = ('max_samples', 'seg_budget', 'eval_seg_budget')
    got = [getattr(ttr.active_tracer_cfg, f) for f in fields]
    assert got == [getattr(jtr.active_tracer_cfg, f) for f in fields]
    act, base = ttr.active_tracer_cfg, ttr.tracer_cfg
    assert act.max_samples <= base.max_samples
    assert act.eval_seg_budget <= base.eval_seg_budget
    assert act.max_samples <= act.eval_seg_budget * base.num_steps
    assert _on_ladder(act.max_samples) and _on_ladder(act.eval_seg_budget)
    assert act.seg_budget == base.seg_budget      # no stage 1 to size


def test_flat_voxel_sample_budget_equals_jax():
    """With max_samples and no paged stage only the sample budget adapts,
    from the occupied cell fraction."""
    trace = dict(FLAT_TRACE, max_samples=2048)
    jtr, ttr = _pair(paged=False, trace=trace, **ADAPT)
    for frac in (1.0, 0.3, 0.02):
        occ = np.zeros(16 ** 3, bool)
        occ[: int(frac * occ.size)] = True
        _set_occupancy(jtr, ttr, occ.reshape((16,) * 3), 1.0)
        jtr._adapt_budget()
        ttr._adapt_budget()
        assert ttr.active_tracer_cfg == replace(
            ttr.tracer_cfg, max_samples=jtr.active_tracer_cfg.max_samples)


def test_paged_voxel_run_trains_and_evaluates():
    """A short paged voxel run on the CPU (the port's counterpart of
    tests/test_paged_hash.py::test_voxel_paged_trainer_trains): finite,
    falling loss, a finite PSNR, the encode through the paged trace."""
    _, tdata = _scene(num_views=6, res=16)
    _, tm = _model_cfgs(paged=True)
    trace = dict(PAGED_TRACE, term_tau=0.0)
    tr = tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**{**TRAIN, 'chunk_size': 10}), tm,
        trt.RFTracerConfig(**trace), tdata, num_rays=128, seed=0,
        device='cpu')
    log = []
    tr.train(num_iterations=30, log_fn=log.append)
    assert all(np.isfinite(e['loss']) for e in log)
    assert log[-1]['loss'] < log[0]['loss']
    m = tr.evaluate(view_indices=[0])
    assert np.isfinite(m['psnr']) and m['psnr'] > 10, m
