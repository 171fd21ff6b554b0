"""Port parity for the paged slice: the deferred paged ``trace()``, the paged
prune density and two Adam steps of the paged trainer against the JAX
package, at a small spec (3 direct + 2 paged LODs, page_res 16).

The JAX paged kernels run in interpret mode.  Their default ``use_bf16``
rounds table values to bf16; these tests switch it off in this process
(``default_static`` patched to ``use_bf16=False``, the JAX file itself
unchanged) so the comparison is f32 against f32.  Tolerances:

* trace: the march, masks and grouping exactly; rgb/alpha/depth to 1e-5
  (f32 integration, float64 prefix sum on the port's side);
* prune density: 1e-4 relative to the largest density (f32 MLP);
* trainer: loss rtol 1e-5 and Adam first moments rtol 2e-3 / atol 1e-4
  of each leaf's largest entry, as ``tests/test_torch_step.py``; the
  parameters to 5e-5 absolute: a codebook entry whose gradient is within
  a few f32 ulps of zero takes Adam's first update ``lr * g / (|g| + eps)``
  (lr about 0.15 here), which turns the two sides' different summation
  orders (per-cell one-hot partials folded into the table against corner
  by corner adds) into differences of up to ~2e-4 lr.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.nefs import nerf as jnerf  # noqa: E402
from shacira_tpu.ops import paged_hash as jph  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu_torch import config as tconfig  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays as tmake_rays  # noqa: E402
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.nefs import nerf as tnerf  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)

from tests.test_torch_step import _leaves, _scene, _tleaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = float(np.finfo(np.float32).tiny)

GRID = dict(feature_dim=2, num_lods=5, min_grid_res=16, max_grid_res=96,
            latent_dim=1, multiscale_type='cat', feature_std=0.3,
            codebook_bitwidth=17, entropy_enabled=True, num_prob_layers=1,
            hash_layout='paged', page_res=16)
LDEC = dict(ldec_std=0.1, use_shift=True, use_sga=True, diff_sampling=True)
NERF = dict(hidden_dim=16, view_embedder='positional', blas_level=5)
TRACE = dict(num_steps=512, max_samples=2048, segment_size=8,
             seg_budget=1024, coarse_level=4, seg_dilation=2,
             eval_seg_budget=256, group_segs_per_block=4,
             fine_mode='deferred')
TRAIN = dict(epochs=20, prune_every=-1, lr=5e-3, grid_lr=0.02, ldec_lr=0.01,
             scale_grid_lr='div', entropy_reg=1e-3, entropy_reg_end=1e-3)


@pytest.fixture
def f32_paged_kernels(monkeypatch):
    """The JAX paged kernels in f32 (``use_bf16=False``) in this process."""
    base = jph.default_static

    def f32_static(spec, interpret=None, use_bf16=True, include_direct=False):
        return base(spec, interpret=True, use_bf16=False,
                    include_direct=include_direct)

    monkeypatch.setattr(jph, 'default_static', f32_static)


def _model_cfgs():
    jm = jnerf.NeuralRadianceFieldConfig(
        grid=jlg.LatentGridConfig.from_geometric(**GRID).with_ldec(LDEC),
        **NERF)
    tm = tnerf.NeuralRadianceFieldConfig(
        grid=tlg.LatentGridConfig.from_geometric(**GRID).with_ldec(LDEC),
        **NERF)
    return jm, tm


def test_spec_has_direct_and_paged_lods():
    _, tm = _model_cfgs()
    rest, direct, pag = trt.ph.blocklocal_lods(tm.grid.spec)
    assert rest == () and len(direct) == 3 and len(pag) == 2


def _sphere_occ(level):
    res = 2 ** level
    g = (np.arange(res) + 0.5) / res * 2 - 1
    xx, yy, zz = np.meshgrid(g, g, g, indexing='ij')
    return (xx ** 2 + yy ** 2 + zz ** 2) < 0.6 ** 2


def test_deferred_paged_trace_matches_jax():
    """Same jitter, same analytic encode/head on both sides: the groupings
    handed to the encode and the integrated buffers agree."""
    occ_np = _sphere_occ(5)
    jcfg, tcfg = jocc.OccupancyGridConfig(5), tocc.OccupancyGridConfig(5)
    jtc = jrt.RFTracerConfig(**TRACE)
    ttc = trt.RFTracerConfig(**TRACE)
    jstate = {'occ': jnp.asarray(occ_np),
              'density': jnp.zeros(occ_np.shape)}
    jstate['coarse'] = jrt.coarse_dilated_occupancy(jstate, jcfg, jtc)
    tstate = {'occ': torch.as_tensor(occ_np),
              'density': torch.zeros(occ_np.shape)}
    tstate['coarse'] = trt.coarse_dilated_occupancy(tstate, tcfg, ttc)
    np.testing.assert_array_equal(tstate['coarse'].numpy(),
                                  np.asarray(jstate['coarse']))

    rng = np.random.RandomState(3)
    R = 48
    o = np.tile(np.asarray([[2.2, 0.3, 0.1]], np.float32), (R, 1))
    d = rng.uniform(-0.7, 0.7, (R, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = rng.rand(R, TRACE['num_steps']).astype(np.float32)
    groupings = {}

    def split(xp, side):
        def zbar_fn(coords, grouping):
            groupings[side] = grouping
            return xp.sin(3.0 * coords)

        def finish_fn(zbar_c, coords_c):
            return xp.concatenate([zbar_c, coords_c ** 2], -1) \
                if xp is jnp else torch.cat([zbar_c, coords_c ** 2], -1)

        def head_fn(feats, dirs):
            color = 0.5 + 0.4 * xp.tanh(feats[..., :3] + dirs)
            dens = 40.0 * (feats[..., 3:].sum(-1, keepdims=True)
                           if xp is jnp
                           else feats[..., 3:].sum(-1, keepdim=True))
            return color, dens
        return zbar_fn, finish_fn, head_fn

    @jax.jit
    def jax_trace(uu):
        out = jrt.trace(None, jstate, jcfg, jtc, jmake_rays(o, d, 0.5, 4.0),
                        uu, encode_split=split(jnp, 'jax'))
        return out, groupings['jax']

    out_j, grp_j = jax_trace(jnp.asarray(u))
    out_t = trt.trace(None, tstate, tcfg, ttc, tmake_rays(o, d, 0.5, 4.0),
                      torch.as_tensor(u), encode_split=split(torch, 'torch'))
    for k, v in grp_j.items():
        np.testing.assert_array_equal(groupings['torch'][k].numpy(),
                                      np.asarray(v), err_msg=k)
    assert np.asarray(grp_j['cell_used']).sum() > 4
    for ch in ('rgb', 'alpha', 'depth'):
        np.testing.assert_allclose(out_t[ch].numpy(), np.asarray(out_j[ch]),
                                   rtol=1e-5, atol=1e-5, err_msg=ch)
    np.testing.assert_array_equal(out_t['hit'].numpy(),
                                  np.asarray(out_j['hit']))
    assert float(out_t['alpha'].max()) > 0.5


def test_paged_prune_density_matches_jax(f32_paged_kernels):
    jm, tm = _model_cfgs()
    assert jnerf._can_prune_paged(jm) and tnerf._can_prune_paged(tm)
    params = jnerf.nerf_init(jax.random.PRNGKey(0), jm)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda pp, k: jnerf._prune_density_paged(
        pp, jm, k))(params, key))
    u = np.array(jax.random.uniform(key, (tm.occ_cfg.num_cells, 3)))
    got = tnerf._prune_density_paged(
        params_from_jax(jax.tree.map(np.asarray, params)), tm,
        torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_two_adam_steps_match_the_jax_paged_step(f32_paged_kernels):
    jdata, tdata = _scene(num_views=4, res=16)
    jm, tm = _model_cfgs()
    jtc, ttc = jrt.RFTracerConfig(**TRACE), trt.RFTracerConfig(**TRACE)
    rays = 64
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN), jm, jtc,
        jdata, num_rays=rays, seed=0)
    ttr = tmt.MultiviewTrainer(tmt.MultiviewTrainerConfig(**TRAIN), tm, ttc,
                               tdata, num_rays=rays, seed=0, device='cpu')
    assert ttr.use_paged and ttr.tracer_cfg.group_res == 8
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
                k_march, (rays, jtc.num_steps)))),
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
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # the paged encode reached the codebook: its rows of the paged LODs moved
    spec = tm.grid.spec
    lo = spec.lod_first_idx[3]
    assert float(ttr.opt_state['mu']['grid']['codebook'][lo:].abs().max()) > 0


def test_paged_trainer_crosses_a_prune_and_evaluates_on_cpu():
    _, tdata = _scene(num_views=4, res=12)
    _, tm = _model_cfgs()
    tc = tmt.MultiviewTrainerConfig(**{**TRAIN, 'prune_every': 3,
                                       'chunk_size': 4})
    tr = tmt.MultiviewTrainer(tc, tm, trt.RFTracerConfig(**TRACE), tdata,
                              num_rays=64, seed=2, device='cpu')
    coarse_before = tr.occ_state['coarse'].clone()
    log = []
    tr.train(num_iterations=4, log_fn=log.append)
    assert [e['iteration'] for e in log] == [3, 4]
    assert all(np.isfinite(e['loss']) for e in log)
    assert float(tr.occ_state['density'].max()) > 0.0        # prune ran
    # the coarse culling grid follows the pruned occupancy
    want = trt.coarse_dilated_occupancy(
        {k: v for k, v in tr.occ_state.items() if k != 'coarse'},
        tm.occ_cfg, tr.tracer_cfg)
    assert torch.equal(tr.occ_state['coarse'], want)
    assert coarse_before.shape == want.shape
    assert np.isfinite(tr.evaluate([0])['psnr'])


def test_paged_finish_with_rest_lods_matches_jax():
    """A hashed LOD that cannot be paged (res 28 at a 2^14 table: fewer than
    the 32 cells per axis a page neighbourhood needs) takes the plain
    affine encode inside ``paged_finish``; forward and gradients agree with
    the JAX package to 1e-5 (f32)."""
    kw = dict(feature_dim=2, latent_dim=1, multiscale_type='cat',
              codebook_bitwidth=14, hash_layout='paged', page_res=16)
    jg = jlg.LatentGridConfig(resolutions=(17, 28, 40), **kw)
    tg = tlg.LatentGridConfig(resolutions=(17, 28, 40), **kw)
    assert trt.ph.blocklocal_lods(tg.spec) == ((1,), (0,), (2,))
    rng = np.random.default_rng(9)
    n = 300
    coords = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    zbar = rng.normal(size=(n, 2, 1)).astype(np.float32)
    z = rng.normal(size=(tg.spec.total_size, 1)).astype(np.float32)
    mat = rng.normal(size=(1, 2)).astype(np.float32)
    shift = rng.normal(size=(1, 2)).astype(np.float32)
    ct = rng.normal(size=(n, 6)).astype(np.float32)

    def jloss(zb, zz, m, sh):
        out = jlg.paged_finish(None, jg, zb, jnp.asarray(coords),
                               affine=(zz, m, sh))
        return jnp.sum(out * ct), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in (zbar, z, mat, shift)))
    targs = [torch.tensor(a, requires_grad=True)
             for a in (zbar, z, mat, shift)]
    got = tlg.paged_finish(tg, targs[0], torch.as_tensor(coords),
                           affine=tuple(targs[1:]))
    tgrads = torch.autograd.grad(torch.sum(got * torch.as_tensor(ct)), targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


PAGED_FLAGS = ['--hash-layout', 'paged', '--page-res', '16',
               '--segment-size', '16', '--coarse-level', '7',
               '--seg-dilation', '2', '--seg-budget', '32768',
               '--eval-seg-budget', '24576', '--group-segs-per-block', '8',
               '--fine-mode', 'deferred', '--max-samples', '262144']


# the JAX bench's headline setting (bench.py's nerf_sustained stage)
SUSTAINED_FLAGS = ['--term-tau', '11.5', '--lean-stage1', 'true',
                   '--super-factor', '4', '--adaptive-budget', 'true',
                   '--min-budget', '8192']


def _jax_and_port_args(argv):
    from shacira_tpu import config as jconfig
    jargs = jconfig.parse_args(
        jconfig.add_nerf_args(jconfig.build_image_parser()), argv)
    return jconfig, jargs, tconfig.parse_args(tconfig.build_nerf_parser(),
                                              argv)


def _assert_same_fields(got, want):
    from dataclasses import fields
    for f in fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_config_reads_the_paged_lego_flags_like_the_jax_package():
    """The paged lego flags, alone and with the sustained ones: the same
    grid, tracer and trainer configs as the JAX package's."""
    lego = ['--config', os.path.join(ROOT, 'configs', 'nerf_lego.yaml')]
    for argv in (lego + PAGED_FLAGS, lego + PAGED_FLAGS + SUSTAINED_FLAGS):
        jconfig, jargs, targs = _jax_and_port_args(argv)
        jm = jconfig.build_nerf_model_config(jargs)
        tm = tconfig.build_nerf_model_config(targs)
        assert tm.grid.spec.total_size == jm.grid.spec.total_size \
            == 7_879_908
        assert (tm.grid.hash_layout, tm.grid.page_res) == ('paged', 16)
        rest, direct, pag = trt.ph.blocklocal_lods(tm.grid.spec)
        assert (rest, direct, pag) == jph.blocklocal_lods(jm.grid.spec)
        assert (len(rest), len(direct), len(pag)) == (0, 11, 13)
        tt = tconfig.build_tracer_config(targs)
        _assert_same_fields(tt, jconfig.build_tracer_config(jargs))
        _assert_same_fields(tconfig.build_nerf_trainer_config(targs),
                            jconfig.build_nerf_trainer_config(jargs))
    tc = tconfig.build_nerf_trainer_config(targs)
    assert (tt.lean_stage1, tt.super_factor, tt.term_tau) == (True, 4, 11.5)
    assert (tc.adaptive_budget, tc.min_budget) == (True, 8192)


@pytest.mark.parametrize('flags,item', [
    (['--fine-mode', 'kernel', '--lean-stage1', 'true'], '9a'),
    (['--fine-mode', 'exact'], '7e'),
    (['--lean-stage1', 'true'], '9a'), (['--super-factor', '2'], '9a'),
    (['--term-tau', '11.5'], '9a')])
def test_unported_paged_modes_raise_naming_their_item(flags, item):
    """The paged modes of ROADMAP items 9a and 7e (``item``), which raised
    before they were ported, build the JAX package's tracer config;
    'kernel' with lean stage 1, which crashes in the reference, raises a
    ValueError that names the crash."""
    jconfig, jargs, targs = _jax_and_port_args(PAGED_FLAGS + flags)
    if flags[:2] == ['--fine-mode', 'kernel']:
        with pytest.raises(ValueError, match='crashes in the reference'):
            tconfig.build_tracer_config(targs)
        return
    assert item in ('9a', '7e')
    _assert_same_fields(tconfig.build_tracer_config(targs),
                        jconfig.build_tracer_config(jargs))
