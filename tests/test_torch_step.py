"""Port parity for the slice as a whole: the training step, optimizer,
schedules and config reader against the JAX package, a CPU training run
across a prune, and the rule that the port never imports JAX.

Step tolerance: the loss agrees to rtol 1e-5 and the Adam first moments
(0.1 x the gradient) to 1e-4 of each leaf's largest entry, or 2e-3
relative: the entropy model's few parameters get gradients summed over the
whole latent table, where cancellation leaves fewer exact digits; the
parameters to 1e-5 absolute -- Adam's update is lr * m / (sqrt(v) + eps),
bounded by lr, so f32 differences in the gradient move it only by
lr x their relative size.  Identical injected draws (SGA uniforms, rate
noise, march jitter) on both sides."""
import ast
import os
from dataclasses import fields

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu import config as jconfig  # noqa: E402
from shacira_tpu import optim as joptim  # noqa: E402
from shacira_tpu.core import schedulers as jsched  # noqa: E402
from shacira_tpu.datasets.nerf_synthetic import (  # noqa: E402
    MultiviewData as JData, pinhole_rays)
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.nefs import nerf as jnerf  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu_torch import config as tconfig  # noqa: E402
from shacira_tpu_torch import optim as toptim  # noqa: E402
from shacira_tpu_torch.core import schedulers as tsched  # noqa: E402
from shacira_tpu_torch.datasets.nerf_synthetic import (  # noqa: E402
    MultiviewData as TData)
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.nefs import nerf as tnerf  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = float(np.finfo(np.float32).tiny)


def _scene(num_views=6, res=16):
    """Analytic sphere seen from a circle of cameras (numpy arrays)."""
    h = w = res
    rgbs, origins, dirs = [], [], []
    for v in range(num_views):
        th = 2 * np.pi * v / num_views
        cam = np.asarray([2.5 * np.cos(th), 0.8, 2.5 * np.sin(th)],
                         np.float32)
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1] = right, np.cross(right, fwd)
        c2w[:3, 2], c2w[:3, 3] = -fwd, cam
        o, d = pinhole_rays(c2w, h, w, res * 1.2, res * 1.2)
        b = np.sum(o * d, -1)
        disc = b * b - (np.sum(o * o, -1) - 0.25)
        t = -b - np.sqrt(np.maximum(disc, 0))
        n = (o + d * t[:, None]) / 0.5
        rgbs.append(np.where((disc > 0)[:, None], 0.5 + 0.5 * n, 1.0
                             ).astype(np.float32))
        origins.append(o)
        dirs.append(d)
    arrays = dict(rgb=np.stack(rgbs), rays_o=np.stack(origins),
                  rays_d=np.stack(dirs),
                  masks=np.ones((num_views, h * w, 1), bool), h=h, w=w,
                  dist_min=1.0, dist_max=4.2)
    return JData(**arrays), TData(**arrays)


GRID = dict(feature_dim=2, num_lods=3, min_grid_res=4, max_grid_res=24,
            latent_dim=1, multiscale_type='cat', feature_std=0.3,
            codebook_bitwidth=9, entropy_enabled=True, num_prob_layers=1)
LDEC = dict(ldec_std=0.1, use_shift=True, use_sga=True, diff_sampling=True)
NERF = dict(hidden_dim=16, view_embedder='positional', blas_level=3)
TRAIN = dict(epochs=20, prune_every=-1, lr=5e-3, grid_lr=0.02, ldec_lr=0.01,
             scale_grid_lr='div', entropy_reg=1e-3, entropy_reg_end=1e-3)


def _cfgs(max_samples, amp=False):
    jm = jnerf.NeuralRadianceFieldConfig(
        grid=jlg.LatentGridConfig.from_geometric(**GRID).with_ldec(LDEC),
        amp=amp, **NERF)
    tm = tnerf.NeuralRadianceFieldConfig(
        grid=tlg.LatentGridConfig.from_geometric(**GRID).with_ldec(LDEC),
        amp=amp, **NERF)
    jt = jrt.RFTracerConfig(num_steps=64, max_samples=max_samples)
    tt = trt.RFTracerConfig(num_steps=64, max_samples=max_samples)
    return (jm, jt, jmt.MultiviewTrainerConfig(rng_impl='threefry', **TRAIN),
            tm, tt, tmt.MultiviewTrainerConfig(**TRAIN))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tleaves(tree):
    return [t.detach().numpy() for _, t in toptim.tree_leaves_with_path(tree)]


def test_two_adam_steps_match_the_jax_step():
    jdata, tdata = _scene()
    jm, jt, jc, tm, tt, tc = _cfgs(max_samples=3000)
    rays = 64
    jtr = jmt.MultiviewTrainer(jc, jm, jt, jdata, num_rays=rays, seed=0)
    ttr = tmt.MultiviewTrainer(tc, tm, tt, tdata, num_rays=rays, seed=0,
                               device='cpu')
    params = jax.tree.map(np.asarray, jtr.params)
    ttr.set_params(params_from_jax(params), adam_state_from_jax(
        jtr.opt_state.mu, jtr.opt_state.nu, jtr.opt_state.count))
    jstep = jax.jit(jtr._raw_step(use_sga=True))
    state = (jtr.params, jtr.opt_state, jtr.noise)
    cb_shape = params['grid']['codebook'].shape
    lod_mask = jnp.ones((jm.grid.num_lods,), jnp.float32)
    ro, rd, gt = jtr._presample(2)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(11), 2)):
        sched = dict(ent_lambda=1e-3, temperature=0.8, lr_ldec=2e-3)
        p, o, n, metrics = jstep(
            *state, jtr.occ_state, None, jnp.asarray(ro[i]), jnp.asarray(rd[i]),
            jnp.asarray(gt[i]), key, jnp.float32(sched['ent_lambda']),
            jnp.float32(sched['temperature']), jnp.float32(sched['lr_ldec']),
            jnp.asarray(True), lod_mask)
        state = (p, o, n)
        # the draws the JAX step makes from its key, handed to the port
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
        np.testing.assert_allclose(float(tmet['psnr']),
                                   float(metrics['psnr']), rtol=1e-5)
        for got, want in zip(_tleaves(ttr.opt_state['mu']), _leaves(o.mu)):
            np.testing.assert_allclose(got, want, rtol=2e-3,
                                       atol=1e-4 * np.abs(want).max())
        for got, want in zip(_tleaves(ttr.params), _leaves(p)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert ttr.opt_state['count'] == int(o.count) == i + 1


def test_train_crosses_a_prune_on_cpu():
    _, tdata = _scene(num_views=4, res=12)
    *_, tm, tt, tc = _cfgs(max_samples=4096)
    tc = tmt.MultiviewTrainerConfig(**{**TRAIN, 'prune_every': 6,
                                       'chunk_size': 4, 'valid_every': 2,
                                       'valid_views': 2})
    tr = tmt.MultiviewTrainer(tc, tm, tt, tdata, num_rays=96, seed=1,
                              device='cpu')
    log = []
    out = tr.train(num_iterations=8, log_fn=log.append)
    assert out['iterations'] == tr.iteration == 8
    steps = [e for e in log if 'iteration' in e]
    # chunks stop at the prune (6) and at the validation epoch (8 = 2 x 4)
    assert [e['iteration'] for e in steps] == [4, 6, 8]
    assert all(np.isfinite(e['loss']) for e in steps)
    assert float(tr.occ_state['density'].max()) > 0.0     # prune ran
    assert any('valid_psnr' in e for e in log)
    assert np.isfinite(tr.evaluate([0])['psnr'])


def test_port_never_imports_jax_or_the_jax_package():
    files = [os.path.join(ROOT, n)
             for n in ('chip_smoke.py', 'compare_kernels.py')]
    for base, _, names in os.walk(os.path.join(ROOT, 'shacira_tpu_torch')):
        files += [os.path.join(base, n) for n in names if n.endswith('.py')]
    assert len(files) > 15

    def banned(mod):
        return any(mod == b or mod.startswith(b + '.')
                   for b in ('jax', 'jaxlib', 'shacira_tpu', 'flax'))

    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and getattr(node.func, 'attr', getattr(
                      node.func, 'id', None)) in ('import_module',
                                                  '__import__')):
                mods = [str(node.args[0].value)]
            bad += [(path, m) for m in mods if banned(m)]
    assert not bad, bad


def _parse_both(argv):
    jparser = jconfig.add_nerf_args(jconfig.build_image_parser())
    jargs = jconfig.parse_args(jparser, argv)
    targs = tconfig.parse_args(tconfig.build_nerf_parser(), argv)
    return jargs, targs


def test_config_reads_lego_yaml_like_the_jax_package():
    argv = ['--config', os.path.join(ROOT, 'configs', 'nerf_lego.yaml')]
    jargs, targs = _parse_both(argv)
    shared = set(vars(jargs)) & set(vars(targs))
    assert len(shared) > 90
    for k in shared - {'platform', 'device'}:
        assert getattr(targs, k) == getattr(jargs, k), k
    jm, tm = (jconfig.build_nerf_model_config(jargs),
              tconfig.build_nerf_model_config(targs))
    assert tm.grid.resolutions == jm.grid.resolutions
    assert tm.grid.spec.total_size == jm.grid.spec.total_size == 7_879_908
    for f in fields(tm):
        if f.name != 'grid':
            assert getattr(tm, f.name) == getattr(jm, f.name), f.name
    assert tm.amp and tm.hidden_dim == 128 and tm.grid.latent_dim == 1
    jt, tt = (jconfig.build_tracer_config(jargs),
              tconfig.build_tracer_config(targs))
    for f in fields(tt):
        assert getattr(tt, f.name) == getattr(jt, f.name), f.name
    jtc, ttc = (jconfig.build_nerf_trainer_config(jargs),
                tconfig.build_nerf_trainer_config(targs))
    for f in fields(ttc):
        assert getattr(ttc, f.name) == getattr(jtc, f.name), f.name


def test_config_rejects_unknown_keys_and_unported_options(tmp_path):
    bad = tmp_path / 'bad.yaml'
    bad.write_text('grid:\n    not_an_option: 3\n')
    with pytest.raises(ValueError):
        tconfig.parse_args(tconfig.build_nerf_parser(), ['--config', str(bad)])
    args = tconfig.parse_args(tconfig.build_nerf_parser(),
                              ['--segment-size', '16'])
    with pytest.raises(NotImplementedError):
        tconfig.build_tracer_config(args)
    args = tconfig.parse_args(tconfig.build_nerf_parser(),
                              ['--adaptive-budget', 'true'])
    with pytest.raises(NotImplementedError):
        tconfig.build_nerf_trainer_config(args)


@pytest.mark.parametrize('name,kw', [
    ('fix', {}), ('linear', {}), ('cosine', {}), ('inv_sqrt', {}),
    ('exp', {'decay_period': 0.9, 'temperature': 0.5})])
def test_schedules_match_jax(name, kw):
    steps = np.arange(0, 40)
    np.testing.assert_allclose(
        tsched.schedule(name, steps, 30, 1.0, 0.1, **kw),
        jsched.schedule(name, steps, 30, 1.0, 0.1, **kw), rtol=1e-12)


@pytest.mark.parametrize('decoupled', [False, True])
def test_adam_update_matches_jax(decoupled):
    rng = np.random.RandomState(12)
    params = {'decoder_x': {'layers': [{'w': rng.randn(3, 2)}]},
              'grid': {'codebook': rng.randn(5, 1),
                       'latent_dec': {'layers': [{'scale': rng.randn(1, 2)}],
                                      'div': np.ones(1)},
                       'prob_model': {'f4': {'h': rng.randn(1, 1)}}}}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    grads = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         params)
    lr = {'decoder': 1e-2, 'grid': 0.1, 'latent_dec': 3e-3,
          'prob_models': 1e-4, 'rest': 1e-2}
    wd = {'decoder': 0.0, 'grid': 0.01, 'latent_dec': 0.1,
          'prob_models': 0.1, 'rest': 0.0}
    labels = joptim.label_params(params, joptim.shacira_label_fn)
    jstate = joptim.adam_init(params)
    jp = params
    tp = params_from_jax(params)
    tstate = toptim.adam_init(tp)
    tlabels = toptim.label_params(tp)
    tgrads = dict(toptim.tree_leaves_with_path(params_from_jax(grads)))
    for _ in range(3):
        jp, jstate = joptim.adam_update(grads, jstate, jp, labels, lr, wd,
                                        decoupled=decoupled)
        toptim.adam_update(tgrads, tstate, tp, tlabels, lr, wd,
                           decoupled=decoupled)
    for got, want in zip(_tleaves(tp), _leaves(jp)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert tlabels[('grid', 'latent_dec', 'div')] == 'frozen'
