"""Checkpoints of the port (``utils/checkpoint.py``): save and restore of a
trainer, model files, and JAX ``'state_dict'`` model files.

A restored trainer equals the saved one exactly (CPU, same operations):
params, Adam state, rate-loss noise, generator state, occupancy, the grids
derived from it, iteration and the best validation params; one more step
from each, on the same batch and draws, gives identical params.  A model
file written by the JAX package with ``model_format='state_dict'`` loads
and renders the view the JAX field renders, within the tolerance of
``tests/test_torch_tracer.py`` (rtol 1e-5, atol 1e-5); its ``'full'``
files and resume states load too, without the JAX package.
"""
import copy
import pickle
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.core.rays import make_rays as jmake_rays  # noqa: E402
from shacira_tpu.models.grids import latent_grid as jlg  # noqa: E402
from shacira_tpu.models.nefs import nerf as jnerf  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu.utils import checkpoint as jckpt  # noqa: E402
from shacira_tpu_torch import optim  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

from tests.test_torch_paged_step import TRACE, TRAIN, _model_cfgs  # noqa: E402
from tests.test_torch_step import _cfgs, _scene  # noqa: E402

SUSTAINED = dict(TRACE, lean_stage1=True, super_factor=4, term_tau=11.5)
DERIVED = ('coarse', 'coarse2', 'super')


def _paged_trainer(seed=0, **cfg):
    _, tdata = _scene(num_views=4, res=16)
    _, tm = _model_cfgs()
    return tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**{**TRAIN, 'prune_every': 4,
                                      'chunk_size': 4, 'valid_every': 1,
                                      'valid_views': 2, **cfg}),
        tm, trt.RFTracerConfig(**SUSTAINED), tdata, num_rays=64, seed=seed,
        device='cpu')


def _equal_trees(a, b):
    la, lb = (list(optim.tree_leaves_with_path(t)) for t in (a, b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), path


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """A paged sustained trainer after 8 steps (two prunes, two
    validations), its resume state saved, and a fresh trainer (another
    seed) restored from it."""
    tr = _paged_trainer()
    tr.train(num_iterations=8)
    # the untrained field keeps every cell occupied: make the occupancy and
    # its derived grids differ from a fresh trainer's
    res = tr.model_cfg.occ_cfg.res
    g = (torch.arange(res) + 0.5) / res * 2 - 1
    xx, yy, zz = torch.meshgrid(g, g, g, indexing='ij')
    occ = xx ** 2 + yy ** 2 + zz ** 2 < 0.6 ** 2
    tr.set_occupancy({'occ': occ, 'density': occ.float() * 5.0})
    path = str(tmp_path_factory.mktemp('ckpt') / 'resume_state.ckpt')
    tckpt.save_trainer(tr, path)
    fresh = _paged_trainer(seed=5)
    tckpt.restore_trainer(fresh, path)
    return tr, fresh, path


def test_restore_reproduces_the_trainer(trained):
    tr, fresh, _ = trained
    assert fresh.iteration == tr.iteration == 8
    _equal_trees(fresh.params, tr.params)
    _equal_trees(fresh.opt_state['mu'], tr.opt_state['mu'])
    _equal_trees(fresh.opt_state['nu'], tr.opt_state['nu'])
    assert fresh.opt_state['count'] == tr.opt_state['count'] == 8
    assert torch.equal(fresh.noise, tr.noise)
    assert torch.equal(fresh.generator.get_state(), tr.generator.get_state())
    assert set(fresh.occ_state) == set(tr.occ_state) >= {'occ', 'density',
                                                         *DERIVED}
    _equal_trees(fresh.occ_state, tr.occ_state)
    assert fresh.best_val_psnr == tr.best_val_psnr > -np.inf
    _equal_trees(fresh.val_best_params, tr.val_best_params)
    assert fresh.labels == tr.labels
    assert all(leaf.requires_grad == (fresh.labels[p] != 'frozen')
               for p, leaf in optim.tree_leaves_with_path(fresh.params))


def test_restore_rebuilds_the_derived_grids(trained):
    """The derived grids come from the restored occupancy, not from the
    file: a state saved without them restores them."""
    tr, _, path = trained
    state = tckpt.load_state(path)
    state['occ_state'] = {k: state['occ_state'][k] for k in ('occ', 'density')}
    stripped = path + '.base'
    tckpt.save_state(stripped, state)
    other = _paged_trainer(seed=7)
    tckpt.restore_trainer(other, stripped)
    for k in DERIVED:
        assert torch.equal(other.occ_state[k], tr.occ_state[k]), k
    assert not torch.equal(other.occ_state['occ'],
                           _paged_trainer(seed=7).occ_state['occ'])


def test_next_step_equals_the_original(trained, tmp_path):
    """One more step of the saved and the restored trainer, same batch and
    the draws of their (equal) generators: identical params."""
    tr, _, _ = trained
    a = copy.deepcopy(tr)
    path = str(tmp_path / 'resume_state.ckpt')
    tckpt.save_trainer(a, path)
    b = _paged_trainer(seed=3)
    tckpt.restore_trainer(b, path)
    b.active_tracer_cfg = a.active_tracer_cfg = a.tracer_cfg
    ro, rd, gt = (torch.as_tensor(x[0]) for x in a._presample(1))
    kw = dict(ent_lambda=1e-3, temperature=0.9, lr_ldec=2e-3, use_sga=True)
    out = [t.step(ro, rd, gt, t.draw_step(use_sga=True), **kw)
           for t in (a, b)]
    assert float(out[0]['loss']) == float(out[1]['loss'])
    _equal_trees(a.params, b.params)
    _equal_trees(a.opt_state['mu'], b.opt_state['mu'])


def test_val_best_params_is_a_snapshot(trained):
    tr, _, _ = trained
    t = copy.deepcopy(tr)
    best = optim.tree_map(lambda x: x.clone(), t.val_best_params)
    assert all(x.device.type == 'cpu' for _, x in
               optim.tree_leaves_with_path(t.val_best_params))
    cb_before = t.params['grid']['codebook'].detach().clone()
    t.train(num_iterations=2)              # inside an epoch: no validation
    assert not torch.equal(t.params['grid']['codebook'], cb_before)
    _equal_trees(t.val_best_params, best)


def test_save_every_writes_the_resume_state(tmp_path):
    """``save_every`` epochs write log_dir/resume_state.ckpt at the epoch
    boundary (chunks stop there)."""
    _, tdata = _scene(num_views=4, res=16)
    *_, tm, tt, tc = _cfgs(max_samples=2048)
    tr = tmt.MultiviewTrainer(replace(tc, save_every=2, chunk_size=100), tm,
                              tt, tdata, num_rays=32, seed=0, device='cpu',
                              log_dir=str(tmp_path))
    log = []
    tr.train(num_iterations=6, log_fn=log.append)
    assert [e['iteration'] for e in log] == [6]
    assert not (tmp_path / 'resume_state.ckpt').exists()
    tr.train(num_iterations=2, log_fn=log.append)
    assert [e['iteration'] for e in log] == [6, 8]
    assert tckpt.load_state(str(tmp_path / 'resume_state.ckpt'))[
        'iteration'] == 8


def test_full_model_file_round_trip(tmp_path):
    tr = _paged_trainer()
    path = str(tmp_path / 'model_best.ckpt')
    configs = {'model': tr.model_cfg, 'tracer': tr.tracer_cfg,
               'trainer': tr.cfg}
    tckpt.save_model(path, tr.params, configs=configs)
    state = tckpt.load_model(path)
    assert state['format'] == 'full' and state['configs'] == configs
    _equal_trees(state['params'], tr.params)
    with pytest.raises(ValueError):
        tckpt.save_model(path, tr.params, model_format='bogus')
    tckpt.check_like(state['params'], tr.params, path)
    state['params']['grid']['codebook'] = state['params']['grid'][
        'codebook'][:-1]
    with pytest.raises(ValueError, match='does not fit'):
        tckpt.check_like(state['params'], tr.params, path)


def _jax_trainer():
    jdata, tdata = _scene(num_views=2, res=16)
    jm, jt, jc, tm, tt, tc = _cfgs(max_samples=3000)
    jtr = jmt.MultiviewTrainer(jc, jm, jt, jdata, num_rays=64, seed=0)
    ttr = tmt.MultiviewTrainer(tc, tm, tt, tdata, num_rays=64, seed=1,
                               device='cpu')
    return jtr, ttr, jdata


def test_jax_state_dict_model_loads_and_renders_the_same_view(tmp_path):
    jtr, ttr, jdata = _jax_trainer()
    path = str(tmp_path / 'jax_model.ckpt')
    jckpt.save_model(path, jtr.params, model_format='state_dict')
    state = tckpt.load_model(path)
    assert state['format'] == 'state_dict'
    tckpt.check_like(state['params'], ttr.params, path)
    ttr.set_params(state['params'])
    npix = jdata.rgb.shape[1]
    got = ttr.render_view(1, ray_batch=npix)
    # the jitter render_view draws, handed to the JAX field's trace
    g = torch.Generator()
    g.manual_seed(0)
    u = torch.rand(trt.march_jitter_shape(ttr.tracer_cfg, npix),
                   generator=g).numpy()
    jm, jt = jtr.model_cfg, jtr.tracer_cfg
    decoded = jlg.decode_codebook(jtr.params['grid'], jm.grid)

    def field_fn(coords, dirs):
        return jnerf.nerf_rgba(jtr.params, jm, coords, dirs, decoded=decoded)

    want = jax.jit(lambda u_: jrt.trace(
        field_fn, jtr.occ_state, jm.occ_cfg, jt,
        jmake_rays(jdata.rays_o[1], jdata.rays_d[1], jdata.dist_min,
                   jdata.dist_max), u_)['rgb'])(jnp.asarray(u))
    np.testing.assert_allclose(got.reshape(-1, 3), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_jax_full_files_and_resume_states_are_refused(tmp_path):
    """JAX ``'full'`` model files and resume states pickle JAX-package
    objects; they are no longer refused: they load without importing the
    JAX package, its objects rebuilt as ``JaxObject``."""
    jtr, ttr, _ = _jax_trainer()
    full = str(tmp_path / 'full.ckpt')
    jckpt.save_model(full, jtr.params, configs={'model': jtr.model_cfg})
    state = tckpt.load_model(full)
    assert state['configs']['model'].jax_class \
        == 'shacira_tpu.models.nefs.nerf.NeuralRadianceFieldConfig'
    _equal_trees(state['params'], jax.tree.map(np.asarray, jtr.params))
    resume = str(tmp_path / 'resume.ckpt')
    jtr.iteration = 3
    jckpt.save_trainer(jtr, resume)
    tckpt.restore_trainer(ttr, resume)
    assert ttr.iteration == 3
    _equal_trees(ttr.params, jax.tree.map(np.asarray, jtr.params))
    _equal_trees(ttr.opt_state['nu'], jax.tree.map(np.asarray,
                                                   jtr.opt_state.nu))
    assert torch.equal(ttr.occ_state['occ'],
                       torch.as_tensor(np.asarray(jtr.occ_state['occ'])))
    assert np.isfinite(ttr.train(num_iterations=1)['iterations'])
