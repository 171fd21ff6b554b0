"""Port parity for ``fine_mode='kernel'``: the paged trace whose per-sample
fine occupancy query rides the block-local encode (kernel B2's occupancy
row), against the JAX package, at the small spec of
``tests/test_torch_paged_step.py`` (3 direct + 2 paged LODs, page_res 16,
occupancy res 32).

The JAX paged kernels run in interpret mode, in f32 (``use_bf16=False``,
patched in this process only).  Tolerances:

* trace: the grouping (dilated fine test of the sub-segment midpoints)
  exactly; rgb/alpha/depth to 1e-5;
* trainer: as ``test_two_adam_steps_match_the_jax_paged_step``: loss rtol
  1e-5, Adam first moments rtol 2e-3 / atol 1e-4 of each leaf's largest
  entry, parameters to 5e-5 absolute;
* the port's own ``'kernel'`` trajectory against its ``'deferred'`` one
  (as ``tests/test_nerf.py::test_kernel_fine_mode_matches_deferred`` holds
  the JAX package): codebooks to 2e-4 -- the same rows reach the head, but
  the dilated grouping places them in other kernel blocks, which sums the
  table gradient in another order.
"""
import os
from dataclasses import fields

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu_torch import config as tconfig  # noqa: E402
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays as tmake_rays  # noqa: E402
from shacira_tpu_torch.models.nefs import nerf as tnerf  # noqa: E402
from shacira_tpu_torch.ops import paged_hash as tph  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)

from tests.test_torch_paged_step import (  # noqa: E402,F401
    PAGED_FLAGS, ROOT, TINY, TRACE, TRAIN, _model_cfgs, _sphere_occ,
    f32_paged_kernels)
from tests.test_torch_step import _leaves, _scene, _tleaves  # noqa: E402

KTRACE = dict(TRACE, fine_mode='kernel')


def test_kernel_trace_matches_jax():
    """Same jitter and the same analytic encode on both sides, whose
    occupancy row is the grid's occupancy at rows the grouping placed:
    the dilated fine grid, the groupings handed to the encode and the
    integrated buffers agree."""
    occ_np = _sphere_occ(5)
    jcfg, tcfg = jocc.OccupancyGridConfig(5), tocc.OccupancyGridConfig(5)
    jtc, ttc = jrt.RFTracerConfig(**KTRACE), trt.RFTracerConfig(**KTRACE)
    jstate = {'occ': jnp.asarray(occ_np),
              'density': jnp.zeros(occ_np.shape)}
    jstate['coarse'] = jrt.coarse_dilated_occupancy(jstate, jcfg, jtc)
    rad = int(np.ceil(jcfg.res * jph_margin())) + 1
    jstate['fine_dil'] = jrt._coarse_dilated_occupancy(jstate, jcfg,
                                                       jcfg.res, rad)
    tstate = {'occ': torch.as_tensor(occ_np),
              'density': torch.zeros(occ_np.shape)}
    tstate['coarse'] = trt.coarse_dilated_occupancy(tstate, tcfg, ttc)
    tstate['fine_dil'] = trt.fine_dilated_occupancy(tstate, tcfg)
    np.testing.assert_array_equal(tstate['fine_dil'].numpy(),
                                  np.asarray(jstate['fine_dil']))

    rng = np.random.RandomState(3)
    R = 48
    o = np.tile(np.asarray([[2.2, 0.3, 0.1]], np.float32), (R, 1))
    d = rng.uniform(-0.7, 0.7, (R, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = rng.rand(R, TRACE['num_steps']).astype(np.float32)
    groupings = {}

    def split(xp, side, query):
        def zbar_fn(coords, grouping):
            groupings[side] = grouping
            n_sub = grouping['seg_to_slotseg'].shape[0]
            placed = (grouping['seg_to_slotseg']
                      < grouping['slotseg_to_seg'].shape[0])
            gss = coords.shape[0] // n_sub
            if xp is jnp:
                placed = jnp.repeat(placed, gss)
                return xp.sin(3.0 * coords), \
                    (query(coords) & placed).astype(jnp.float32)
            placed = placed[:, None].expand(-1, gss).reshape(-1)
            return xp.sin(3.0 * coords), (query(coords) & placed).float()

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
                        uu, encode_split=split(
                            jnp, 'jax',
                            lambda c: jocc.query(jstate, jcfg, c)))
        return out, groupings['jax']

    out_j, grp_j = jax_trace(jnp.asarray(u))
    out_t = trt.trace(None, tstate, tcfg, ttc, tmake_rays(o, d, 0.5, 4.0),
                      torch.as_tensor(u), encode_split=split(
                          torch, 'torch',
                          lambda c: tocc.query(tstate, tcfg, c)))
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


def jph_margin():
    from shacira_tpu.ops import paged_hash as jph
    return jph.DIRECT_MARGIN


def test_two_adam_steps_match_the_jax_kernel_step(f32_paged_kernels):
    """The trainer's kernel-mode step: B2's occupancy row (plain version)
    gates the compaction; loss, Adam moments and parameters agree with the
    JAX trainer's after each of two steps."""
    jdata, tdata = _scene(num_views=4, res=16)
    jm, tm = _model_cfgs()
    jtc, ttc = jrt.RFTracerConfig(**KTRACE), trt.RFTracerConfig(**KTRACE)
    rays = 64
    jtr = jmt.MultiviewTrainer(
        jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN), jm, jtc,
        jdata, num_rays=rays, seed=0)
    ttr = tmt.MultiviewTrainer(tmt.MultiviewTrainerConfig(**TRAIN), tm, ttc,
                               tdata, num_rays=rays, seed=0, device='cpu')
    assert ttr.use_paged and ttr.tracer_cfg.fine_mode == 'kernel'
    for k in ('coarse', 'fine_dil'):
        np.testing.assert_array_equal(ttr.occ_state[k].numpy(),
                                      np.asarray(jtr.occ_state[k]))
    assert ttr.occ_state['occ_packed'].shape == (32, 32, 5)
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
    lo = tm.grid.spec.lod_first_idx[3]
    assert float(ttr.opt_state['mu']['grid']['codebook'][lo:].abs().max()) > 0


def _trainer(fine_mode, prune_every=4, num_rays=32):
    """A small paged trainer on the CPU whose occupancy starts as a sphere
    (its grids derived from it), so that the fine query culls samples."""
    _, tdata = _scene(num_views=4, res=16)
    _, tm = _model_cfgs()
    tc = tmt.MultiviewTrainerConfig(**{**TRAIN, 'prune_every': prune_every,
                                       'chunk_size': 4})
    tr = tmt.MultiviewTrainer(
        tc, tm, trt.RFTracerConfig(**dict(TRACE, fine_mode=fine_mode)),
        tdata, num_rays=num_rays, seed=0, device='cpu')
    tr.occ_state['occ'] = torch.as_tensor(_sphere_occ(5))
    tr._refresh_coarse()
    return tr


def test_kernel_trajectory_equals_deferred():
    """With the same seed, ``'kernel'`` trains as ``'deferred'`` does
    across two prunes: the occupancy row reproduces the fine query on every
    row that reaches the head."""
    logs = {}
    trainers = {}
    for mode in ('deferred', 'kernel'):
        trainers[mode] = _trainer(mode)
        logs[mode] = []
        trainers[mode].train(num_iterations=9, log_fn=logs[mode].append)
    td, tk = trainers['deferred'], trainers['kernel']
    assert float(tk.occ_state['density'].max()) > 0.0        # pruned
    torch.testing.assert_close(tk.params['grid']['codebook'].detach(),
                               td.params['grid']['codebook'].detach(),
                               rtol=2e-4, atol=2e-4)
    for a, b in zip(logs['kernel'], logs['deferred']):
        if 'loss' in a:
            np.testing.assert_allclose(a['loss'], b['loss'], rtol=1e-4)
            assert a['occupancy'] == b['occupancy'] < 0.5


def test_kernel_grids_follow_the_prune_and_render_defers(monkeypatch):
    """The packed occupancy grid and the dilated fine grid are rebuilt at
    every prune; rendering runs the deferred fine query (no occupancy row)
    and stays finite."""
    tr = _trainer('kernel', prune_every=3)
    # a grid the derived ones were not built from: the prune rebuilds them
    half = _sphere_occ(5)
    half[16:] = False
    tr.occ_state['occ'] = torch.as_tensor(half)
    packed0 = tr.occ_state['occ_packed'].clone()
    tr.train(num_iterations=4)
    base = {k: tr.occ_state[k] for k in ('occ', 'density')}
    assert torch.equal(tr.occ_state['occ_packed'],
                       tph.pack_occupancy(base['occ']))
    assert not torch.equal(tr.occ_state['occ_packed'], packed0)
    assert torch.equal(tr.occ_state['fine_dil'], trt.fine_dilated_occupancy(
        base, tr.model_cfg.occ_cfg))
    seen = []
    zbar = tnerf.nerf_zbar

    def spy(*a, **kw):
        seen.append(kw.get('occ'))
        return zbar(*a, **kw)

    monkeypatch.setattr(tnerf, 'nerf_zbar', spy)
    img = tr.render_view(0)
    assert np.isfinite(img).all() and seen and all(o is None for o in seen)
    assert tr.tracer_cfg.fine_mode == 'kernel'


def test_config_reads_the_kernel_fine_mode_like_the_jax_package():
    """``--fine-mode kernel`` with the paged lego flags gives the JAX
    package's tracer config, and the port's tracer accepts it."""
    from shacira_tpu import config as jconfig
    flags = [f if f != 'deferred' else 'kernel' for f in PAGED_FLAGS]
    argv = ['--config', os.path.join(ROOT, 'configs', 'nerf_lego.yaml'),
            *flags]
    jargs = jconfig.parse_args(
        jconfig.add_nerf_args(jconfig.build_image_parser()), argv)
    targs = tconfig.parse_args(tconfig.build_nerf_parser(), argv)
    jt, tt = (jconfig.build_tracer_config(jargs),
              tconfig.build_tracer_config(targs))
    assert tt.fine_mode == 'kernel'
    for f in fields(tt):
        assert getattr(tt, f.name) == getattr(jt, f.name), f.name
