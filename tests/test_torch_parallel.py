"""Data parallelism of the port (``shacira_tpu_torch/parallel``) on the CPU.

Ranks are processes started with ``torch.multiprocessing.spawn`` that join
one gloo process group through a ``file://`` rendezvous in the test's
temporary directory (no port to race for), each with one intra-op thread;
every join has a deadline, so a hung collective fails its test.  This
module imports no JAX at the top: the ranks import it again, and only the
test functions that compare with the JAX package import it.

What is checked:

* ``per_device_cfg`` and ``pad_to_multiple`` against the JAX package's;
* the placements and collectives at 2 ranks, ``adam_update_mesh`` (a
  row-sharded codebook) against ``adam_update`` of the mean gradient, and
  ``scaling_report`` over meshes of the first 1 and 2 ranks;
* the trainers at world size 2 (and 4) against world size 1, on the configs of
  ``tests/test_parallel.py``: one step's gradients within 1e-5 of their
  largest value, and the parameters after that test's step counts
  within its 5e-3 (float sums in another order);
* a resume state written at world size 2 (the moments' rows gathered)
  restoring at world size 1;
* validation and the resume state on their epochs, at world size 2:
  every rank validates, rank 0 alone logs and writes;
* the flat NeRF with ``shard_table_work`` at world size 2 against the JAX
  trainer on ``make_mesh(2)``, its draws carried into the port, within
  5e-3.
"""
import os
import pickle
import tempfile
import time
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from shacira_tpu_torch import optim
from shacira_tpu_torch.datasets.image import ImageDataset
from shacira_tpu_torch.datasets.nerf_synthetic import (MultiviewData,
                                                       pinhole_rays)
from shacira_tpu_torch.models.grids.latent_grid import LatentGridConfig
from shacira_tpu_torch.models.nefs.image import NeuralImageConfig
from shacira_tpu_torch.models.nefs.nerf import NeuralRadianceFieldConfig
from shacira_tpu_torch.parallel import mesh as pmesh
from shacira_tpu_torch.parallel import multihost
from shacira_tpu_torch.tracers import rf_tracer
from shacira_tpu_torch.trainers.image_trainer import (ImageTrainer,
                                                      ImageTrainerConfig)
from shacira_tpu_torch.trainers.multiview_trainer import (
    MultiviewTrainer, MultiviewTrainerConfig, StepDraws)
from shacira_tpu_torch.utils import checkpoint
from shacira_tpu_torch.utils.convert import params_from_jax

JOIN_S = 90               # a rank that has not finished by then has hung
GRAD_TOL = 1e-5           # one step's gradients, of their largest
PARAM_TOL = 5e-3          # tests/test_parallel.py's rtol and atol
CB = ('grid', 'codebook')


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread, as each rank has: the test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, n, tmp, fn, args):
    torch.set_num_threads(1)
    multihost.initialize(f'file://{tmp}/rendezvous', n, rank, backend='gloo',
                         timeout_s=JOIN_S)
    try:
        out = fn(multihost.global_mesh(), *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(out, f)


def run_ranks(tmp_path, n, fn, *args):
    """``fn(mesh, *args)`` on ``n`` gloo ranks; their results in rank
    order.  A rank that raises fails the test with its traceback; ranks
    still running after ``JOIN_S`` seconds are killed."""
    tmp = tempfile.mkdtemp(dir=tmp_path)
    ctx = mp.spawn(_rank_main, args=(n, tmp, fn, args), nprocs=n,
                   join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f'ranks still running after {JOIN_S} s')
    assert not any(p.is_alive() for p in ctx.processes)
    out = []
    for r in range(n):
        with open(os.path.join(tmp, f'rank{r}.pkl'), 'rb') as f:
            out.append(pickle.load(f))
    return out


def _host(tree):
    return optim.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _flat(tree):
    return {'/'.join(p): t for p, t in optim.tree_leaves_with_path(tree)}


def _spy_grads(record):
    """Record the gradient each Adam update applies (after the mesh's
    reduction: the mean gradient, the codebook's as this rank's rows)."""
    update = optim.adam_update

    def spy(grads, *a, **k):
        record.append({'/'.join(p): g.detach().clone().numpy()
                       for p, g in grads.items() if g is not None})
        return update(grads, *a, **k)
    return spy


def assert_grads_close(got, want):
    """Every leaf within ``GRAD_TOL`` of the step's largest gradient entry
    (the prob model's few parameters sum terms over the whole table, which
    cancel, so their own scale is no yardstick)."""
    for k, g in got.items():             # no gradient: zero
        if k not in want:
            np.testing.assert_array_equal(g, 0.0, err_msg=k)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=k)


def assert_replicated(outs):
    """Every rank ends with rank 0's parameters, bit for bit."""
    for o in outs[1:]:
        for k, v in _flat(outs[0]['params']).items():
            np.testing.assert_array_equal(_flat(o['params'])[k], v, err_msg=k)


def assert_params_close(got, want):
    for k, w in _flat(want).items():
        np.testing.assert_allclose(_flat(got)[k], w, rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# direct parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kw, n', [
    (dict(max_samples=4096, segment_size=4, seg_budget=4096,
          eval_seg_budget=2048), 8),
    (dict(max_samples=8192, segment_size=4, seg_budget=4096,
          eval_seg_budget=4096), 2),
    (dict(max_samples=0, seg_budget=-1), 4),
    (dict(max_samples=100), 8)])
def test_per_device_cfg_matches_jax(kw, n):
    from shacira_tpu.tracers import rf_tracer as jrt
    jc, tc = jrt.RFTracerConfig(**kw), rf_tracer.RFTracerConfig(**kw)
    try:
        want = jrt.per_device_cfg(jc, n)
    except ValueError:
        with pytest.raises(ValueError):
            rf_tracer.per_device_cfg(tc, n)
        return
    got = rf_tracer.per_device_cfg(tc, n)
    for f in ('max_samples', 'seg_budget', 'eval_seg_budget', 'num_steps',
              'segment_size', 'max_intersections'):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize('shape, multiple, axis', [
    ((10, 3), 4, 0), ((8, 3), 4, 0), ((2, 5, 3), 3, 1), ((7,), 1, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    from shacira_tpu.parallel import mesh as jmesh
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got, n = pmesh.pad_to_multiple(x, multiple, axis)
    want, m = jmesh.pad_to_multiple(x, multiple, axis)
    assert n == m
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# placement and collectives
# ---------------------------------------------------------------------------

def _placement(mesh):
    r, n = mesh.rank, mesh.size
    x = np.arange(64, dtype=np.float32).reshape(64, 1)
    (xs,) = pmesh.shard_batch(mesh, x)
    (ys,) = pmesh.shard_axis(mesh, 1, np.arange(24).reshape(2, 12, 1))
    rows = pmesh.shard_rows_global(mesh, torch.arange(16.0).reshape(8, 2))
    # rank 0's values everywhere, a bool tensor included
    tree = {'a': torch.full((3,), float(r)), 'b': [torch.tensor([r == 1])]}
    pmesh.replicate(mesh, tree)
    # the mean of a flat buffer of two dtypes
    grads = [torch.full((2, 2), float(r)), torch.full((3,), 2.0 * r),
             torch.full((1,), r, dtype=torch.float64)]
    pmesh.all_reduce_mean_(mesh, grads)
    total = pmesh.all_reduce_sum(mesh, torch.tensor([1.0, float(r)]))
    # the rows joined, and the gradient back to each rank's rows summed
    part = torch.full((2, 3), float(r), requires_grad=True)
    whole = pmesh.all_gather_rows(mesh, part)
    (whole * torch.arange(12.0).reshape(4, 3) * (r + 1)).sum().backward()
    scattered = pmesh.reduce_scatter_rows(mesh, torch.ones(4, 3) * (r + 1))
    return dict(
        rows=(mesh.rank, mesh.size, pmesh.batch_sharding(mesh, 64),
              pmesh.row_sharding(mesh, 8), pmesh.replicated(mesh, 8),
              multihost.host_local_batch_slice(64),
              multihost.host_local_batch_slice(64, mesh)),
        xs=xs.numpy(), ys=ys.numpy(), table=rows.numpy(),
        tree=_host(tree), grads=[g.numpy() for g in grads],
        total=total.numpy(), whole=whole.detach().numpy(),
        part_grad=part.grad.numpy(), scattered=scattered.numpy(),
        device=str(mesh.device))


def test_placement_and_collectives_at_two_ranks(tmp_path):
    outs = run_ranks(tmp_path, 2, _placement)
    for r, o in enumerate(outs):
        lo = 32 * r
        assert o['rows'] == (r, 2, slice(lo, lo + 32), slice(4 * r, 4 * r + 4),
                             slice(0, 8), slice(lo, lo + 32),
                             slice(lo, lo + 32))
        assert o['device'] == 'cpu'
        np.testing.assert_array_equal(o['xs'][:, 0], np.arange(lo, lo + 32))
        assert o['ys'].shape == (2, 6, 1)
        np.testing.assert_array_equal(o['ys'][0, :, 0],
                                      np.arange(6 * r, 6 * r + 6))
        np.testing.assert_array_equal(o['table'],
                                      np.arange(16.0).reshape(8, 2)[4 * r:
                                                                    4 * r + 4])
        np.testing.assert_array_equal(o['tree']['a'], [0.0, 0.0, 0.0])
        assert not o['tree']['b'][0][0]
        np.testing.assert_array_equal(o['grads'][0], np.full((2, 2), 0.5))
        np.testing.assert_array_equal(o['grads'][1], np.full((3,), 1.0))
        np.testing.assert_array_equal(o['grads'][2], [0.5])
        np.testing.assert_array_equal(o['total'], [2.0, 1.0])
        np.testing.assert_array_equal(
            o['whole'], np.repeat([0.0, 1.0], 6).reshape(4, 3))
        # d/d part = rows of arange * (1 + 2), summed over the two ranks
        np.testing.assert_array_equal(
            o['part_grad'], 3 * np.arange(12.0).reshape(4, 3)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o['scattered'], np.full((2, 3), 3.0))


def _adam_case(mesh):
    """Per-rank gradients of a tree with a codebook, a decoder and a
    frozen leaf: the mesh update against adam_update of the mean."""
    rng = np.random.RandomState(0)
    params = {'grid': {'codebook': rng.randn(8, 1), 'latent_dec': {
                  'div': np.ones(1), 'scale': rng.randn(1, 2)}},
              'decoder': {'w': rng.randn(3, 2)}}
    params = optim.tree_map(lambda a: torch.tensor(a, dtype=torch.float32),
                            params)
    labels = optim.label_params(params)
    per_rank = [{p: torch.tensor(np.random.RandomState(10 + r).randn(
                     *t.shape), dtype=torch.float32)
                 for p, t in optim.tree_leaves_with_path(params)
                 if labels[p] != 'frozen'} for r in range(mesh.size)]
    lrs = {'decoder': 1e-2, 'grid': 2e-2, 'latent_dec': 1e-2}
    wd = {'grid': 1e-3}
    want = optim.tree_map(torch.clone, params)
    want_state = optim.adam_init(want)
    got = optim.tree_map(torch.clone, params)
    state = optim.adam_init(got)
    rows = pmesh.row_sharding(mesh, 8)
    for k in ('mu', 'nu'):
        state[k]['grid']['codebook'] = state[k]['grid']['codebook'][rows]
    for step in range(3):
        mean = {p: sum(g[p] for g in per_rank) / mesh.size
                for p in per_rank[0]}
        optim.adam_update(mean, want_state, want, labels, lrs, wd)
        mine = {p: g.clone() for p, g in per_rank[mesh.rank].items()}
        if step == 1:        # the codebook's rows already summed over ranks
            mine[CB] = sum(g[CB] for g in per_rank)[rows]
        optim.adam_update_mesh(mine, state, got, labels, lrs, wd, mesh,
                               row_paths=[CB])
    return dict(got=_host(got), want=_host(want),
                mu_rows=state['mu']['grid']['codebook'].numpy(),
                mu_want=want_state['mu']['grid']['codebook'][rows].numpy())


def test_adam_update_mesh_matches_adam_update_of_the_mean(tmp_path):
    for o in run_ranks(tmp_path, 2, _adam_case):
        assert o['mu_rows'].shape == (4, 1)
        np.testing.assert_allclose(o['mu_rows'], o['mu_want'], rtol=1e-6,
                                   atol=1e-7)
        for k, w in _flat(o['want']).items():
            np.testing.assert_allclose(_flat(o['got'])[k], w, rtol=1e-6,
                                       atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the image trainer (tests/test_parallel.py's configs)
# ---------------------------------------------------------------------------

def image_trainer(mode, mesh=None):
    img = np.random.RandomState(0).rand(16, 16, 3).astype(np.float32)
    full = mode == 'full'
    ds = (ImageDataset(img, sample_mode='full') if full else
          ImageDataset(img, num_samples=64, sample_mode=mode, seed=3))
    grid = LatentGridConfig.from_geometric(
        feature_dim=1, num_lods=4, min_grid_res=4, max_grid_res=16,
        latent_dim=1, multiscale_type='cat', resolution_dim=2,
        feature_std=0.1, codebook_bitwidth=6, init_grid='uniform',
        num_prob_layers=2, entropy_enabled=full,
    ).with_ldec(dict(norm='max' if full else 'none', ldecode_matrix='sq',
                     use_shift=True, ldec_std=0.1))
    mcfg = NeuralImageConfig(grid=grid, hidden_dim=8, num_layers=1)
    tcfg = (ImageTrainerConfig(epochs=60, log_every=-1, entropy_reg=1e-4,
                               entropy_reg_end=1e-4, chunk_size=30,
                               norm='max') if full else
            ImageTrainerConfig(epochs=40, log_every=-1, entropy_reg=0.0,
                               chunk_size=20))
    return ImageTrainer(tcfg, mcfg, ds, seed=0, mesh=mesh,
                        device=None if mesh is not None else 'cpu')


def _image_run(mesh, mode):
    grads = []
    optim.adam_update = _spy_grads(grads)
    tr = image_trainer(mode, mesh)
    tr.train(epochs=1, finalize=False)
    tr.train(epochs=tr.cfg.epochs - 1, finalize=False)
    return dict(grads=grads[0], params=_host(tr.params),
                best_loss=float(tr.best_loss))


@pytest.mark.parametrize('mode, n', [('full', 2), ('woreplace', 2),
                                     ('full', 4)])
def test_image_trainer_n_ranks_match_one(tmp_path, monkeypatch, mode, n):
    grads = []
    monkeypatch.setattr(optim, 'adam_update', _spy_grads(grads))
    tr = image_trainer(mode)
    tr.train(epochs=1, finalize=False)
    tr.train(epochs=tr.cfg.epochs - 1, finalize=False)
    want = _host(tr.params)
    outs = run_ranks(tmp_path, n, _image_run, mode)
    for o in outs:
        assert_grads_close(o['grads'], grads[0])
        assert_params_close(o['params'], want)
        np.testing.assert_allclose(o['best_loss'], float(tr.best_loss),
                                   rtol=PARAM_TOL)
    assert_replicated(outs)


# ---------------------------------------------------------------------------
# the NeRF trainer
# ---------------------------------------------------------------------------

def nerf_scene(num_views, res):
    """``tests/test_nerf.py::synthetic_scene`` with the port's rays."""
    h = w = res
    rgbs, origins, dirs = [], [], []
    for v in range(num_views):
        theta = 2 * np.pi * v / num_views
        cam = np.asarray([2.5 * np.cos(theta), 0.8, 2.5 * np.sin(theta)],
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
    return MultiviewData(rgb=np.stack(rgbs), rays_o=np.stack(origins),
                         rays_d=np.stack(dirs),
                         masks=np.ones((num_views, h * w, 1), bool),
                         h=h, w=w, dist_min=0.0, dist_max=5.0)


LDEC = dict(norm='none', ldecode_matrix='sq', use_shift=True, ldec_std=0.1,
            use_sga=True, diff_sampling=True)
NERF_CASES = {
    # test_nerf_sharded_table_work_matches_single_device, 40 steps
    'flat': dict(views=8, grid=dict(min_grid_res=8, max_grid_res=32,
                                    num_lods=3, codebook_bitwidth=9),
                 blas=4, tracer=dict(num_steps=32),
                 train=dict(epochs=10, chunk_size=10, temperature=0.5),
                 iters=40),
    # test_nerf_paged_shard_map_trace_matches_single_device, 8 steps, on
    # the sphere's occupancy
    'paged': dict(views=4, grid=dict(min_grid_res=16, max_grid_res=64,
                                     num_lods=4, codebook_bitwidth=17,
                                     hash_layout='paged'),
                  blas=7, tracer=dict(num_steps=512, max_samples=8192,
                                      segment_size=4, seg_budget=4096,
                                      coarse_level=5, seg_dilation=1,
                                      eval_seg_budget=4096,
                                      group_segs_per_block=8,
                                      fine_mode='deferred'),
                  train=dict(epochs=20, chunk_size=4, temperature=0.1),
                  iters=8, sphere=True),
    # the flat case with a sample budget that does not divide 2 (ample:
    # 64 rays x 32 steps): every rank traces the whole batch
    'indivisible': dict(views=8, grid=dict(min_grid_res=8, max_grid_res=32,
                                           num_lods=3, codebook_bitwidth=9),
                        blas=4, tracer=dict(num_steps=32, max_samples=2049),
                        train=dict(epochs=10, chunk_size=10,
                                   temperature=0.5),
                        iters=10),
    # a prune at step 4 that keeps about half the cells, and adapted
    # budgets
    'prune': dict(views=8, grid=dict(min_grid_res=8, max_grid_res=32,
                                     num_lods=3, codebook_bitwidth=9,
                                     feature_std=0.3),
                  model=dict(prune_min_density=0.84), blas=4,
                  tracer=dict(num_steps=32, max_samples=2048),
                  train=dict(epochs=10, chunk_size=10, temperature=0.5,
                             prune_every=4, adaptive_budget=True,
                             min_budget=256),
                  iters=6)}


def sphere_occupancy(level):
    res = 2 ** level
    g = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    xx, yy, zz = np.meshgrid(g, g, g, indexing='ij')
    return (xx ** 2 + yy ** 2 + zz ** 2) < (0.5 + 2.0 / res) ** 2


def nerf_trainer(case, mesh=None):
    c = NERF_CASES[case]
    grid = LatentGridConfig.from_geometric(
        feature_dim=2, latent_dim=1, multiscale_type='cat',
        resolution_dim=3, init_grid='normal', num_prob_layers=1,
        entropy_enabled=True, **{'feature_std': 0.02, **c['grid']}
    ).with_ldec(LDEC)
    mcfg = NeuralRadianceFieldConfig(
        grid=grid, hidden_dim=16, num_layers=1, view_embedder='positional',
        view_multires=2, blas_level=c['blas'], **c.get('model', {}))
    tcfg = rf_tracer.RFTracerConfig(raymarch_type='ray', bg_color='white',
                                    **c['tracer'])
    cfg = MultiviewTrainerConfig(**{'prune_every': -1, 'use_sga': True,
                                    'entropy_reg': 1e-4,
                                    'entropy_reg_end': 1e-4, **c['train']})
    tr = MultiviewTrainer(cfg, mcfg, tcfg, nerf_scene(c['views'], 16),
                          num_rays=64, seed=0, mesh=mesh,
                          device=None if mesh is not None else 'cpu')
    if c.get('sphere'):
        # live rows well under the per-rank budgets: nothing truncates
        tr.set_occupancy({**tr.occ_state, 'occ': torch.as_tensor(
            sphere_occupancy(c['blas']), device=tr.device)})
    return tr


def _nerf_run(mesh, case):
    grads = []
    optim.adam_update = _spy_grads(grads)
    tr = nerf_trainer(case, mesh)
    out = dict(shard_table_work=tr.shard_table_work,
               mu_rows=tr.opt_state['mu']['grid']['codebook'].shape[0])
    tr.train(num_iterations=1)
    out['shard_ray_active'] = tr._shard_ray_active
    tr.train(num_iterations=NERF_CASES[case]['iters'] - 1)
    out.update(grads=grads[0], params=_host(tr.params),
               occ=tr.occ_state['occ'].numpy(),
               budgets=[getattr(tr.active_tracer_cfg, f) for f in
                        ('max_samples', 'seg_budget', 'eval_seg_budget')])
    return out


@pytest.mark.parametrize('case, n, ray_sharded', [
    ('flat', 2, True), ('paged', 2, True), ('indivisible', 2, False),
    ('flat', 4, True)])
def test_nerf_trainer_n_ranks_match_one(tmp_path, monkeypatch, case, n,
                                        ray_sharded):
    grads = []
    monkeypatch.setattr(optim, 'adam_update', _spy_grads(grads))
    tr = nerf_trainer(case)
    tr.train(num_iterations=NERF_CASES[case]['iters'])
    outs = run_ranks(tmp_path, n, _nerf_run, case)
    t = tr.params['grid']['codebook'].shape[0]
    for r, o in enumerate(outs):
        assert o['shard_table_work'] and o['mu_rows'] == t // n
        assert o['shard_ray_active'] == ray_sharded
        # the codebook's gradient: this rank's rows
        rows = slice(r * t // n, (r + 1) * t // n)
        want = dict(grads[0], **{'grid/codebook':
                                 grads[0]['grid/codebook'][rows]})
        assert_grads_close(o['grads'], want)
        assert_params_close(o['params'], _host(tr.params))
    assert_replicated(outs)


def test_nerf_prune_agrees_on_every_rank(tmp_path):
    outs = run_ranks(tmp_path, 2, _nerf_run, 'prune')
    a, b = outs
    assert a['occ'].mean() < 1.0                 # the prune took cells
    np.testing.assert_array_equal(a['occ'], b['occ'])
    assert a['budgets'] == b['budgets']
    assert a['budgets'][0] < NERF_CASES['prune']['tracer']['max_samples']
    assert_replicated(outs)


def _nerf_checkpoint(mesh, path):
    tr = nerf_trainer('flat', mesh)
    tr.train(num_iterations=2)
    checkpoint.save_trainer(tr, path)         # every rank; rank 0 writes
    return dict(mu_rows=tr.opt_state['mu']['grid']['codebook'].numpy(),
                params=_host(tr.params))


def test_nerf_checkpoint_of_two_ranks_loads_in_one(tmp_path):
    path = str(tmp_path / 'resume_state.ckpt')
    outs = run_ranks(tmp_path, 2, _nerf_checkpoint, path)
    tr = nerf_trainer('flat')
    checkpoint.restore_trainer(tr, path)
    assert tr.iteration == 2
    np.testing.assert_array_equal(
        tr.opt_state['mu']['grid']['codebook'].numpy(),
        np.concatenate([o['mu_rows'] for o in outs]))
    for k, v in _flat(outs[0]['params']).items():
        np.testing.assert_array_equal(_flat(_host(tr.params))[k], v)


def _cadence(mesh, kind, log_dir):
    """A run across validation and resume-state epochs; ``log_fn``'s
    entries counted."""
    logged = []
    if kind == 'image':
        tr = image_trainer('full', mesh)
        tr.cfg = replace(tr.cfg, valid_every=10, save_every=20)
        tr.log_dir = log_dir
        tr.train(epochs=20, log_fn=logged.append, finalize=False)
    else:
        tr = nerf_trainer('flat', mesh)     # 8 views: 8 steps an epoch
        tr.cfg = replace(tr.cfg, valid_every=1, save_every=2)
        tr.log_dir = log_dir
        tr.train(num_iterations=16, log_fn=logged.append)
    return dict(best=tr.best_val_psnr, val_params=_host(tr.val_best_params),
                params=_host(tr.params), logged=len(logged))


@pytest.mark.parametrize('kind', ['image', 'nerf'])
def test_validation_and_resume_state_on_every_rank(tmp_path, kind):
    one = _cadence(None, kind, str(tmp_path / 'one'))
    two = str(tmp_path / 'two')
    outs = run_ranks(tmp_path, 2, _cadence, kind, two)
    a, b = outs
    assert a['logged'] > 0 and b['logged'] == 0       # rank 0 logs
    assert os.listdir(two) == ['resume_state.ckpt']
    # every rank validated: the same best state on both
    assert a['best'] == b['best']
    np.testing.assert_allclose(a['best'], one['best'], rtol=PARAM_TOL)
    for k, v in _flat(a['val_params']).items():
        np.testing.assert_array_equal(_flat(b['val_params'])[k], v,
                                      err_msg=k)
    assert_replicated(outs)
    tr = image_trainer('full') if kind == 'image' else nerf_trainer('flat')
    checkpoint.restore_trainer(tr, os.path.join(two, 'resume_state.ckpt'))
    for k, v in _flat(a['params']).items():
        np.testing.assert_array_equal(_flat(_host(tr.params))[k], v,
                                      err_msg=k)


def _scaling(mesh):
    def step_builder(m, batch):
        x = torch.ones(batch)
        return lambda: pmesh.all_reduce_mean_(m, [x])
    return multihost.scaling_report(step_builder, batch_per_device=1024,
                                    steps=3)


def test_scaling_report_over_the_first_n_ranks(tmp_path):
    outs = run_ranks(tmp_path, 2, _scaling)
    assert outs[0] == outs[1]                 # rank 0's report everywhere
    assert sorted(outs[0]) == [1, 2]
    assert outs[0][1]['efficiency'] == 1.0
    assert all(v['items_per_s'] > 0 for v in outs[0].values())


# ---------------------------------------------------------------------------
# against the JAX package's trainer on make_mesh(2)
# ---------------------------------------------------------------------------

def _nerf_from_jax(mesh, start, steps):
    """The flat table-work case from the JAX run's parameters, ray batches
    and draws (each step's whole draws, on every rank)."""
    tr = nerf_trainer('flat', mesh)
    tr.set_params(params_from_jax(start))
    queue = list(steps)

    def presample(n):
        taken = queue[:n]
        del queue[:n]
        return tuple(np.stack([s[k] for s in taken]) for k in range(3))

    draws = iter(steps)
    tr._presample = presample
    tr.draw_step = lambda use_sga, refresh_noise=True: StepDraws(
        *(torch.as_tensor(a) for a in next(draws)[3:]))
    tr.train(num_iterations=len(steps))
    assert not queue
    return _host(tr.params)


def test_nerf_table_work_matches_jax_on_two_devices(tmp_path):
    import jax
    from shacira_tpu.accel import occupancy as jocc
    from shacira_tpu.models.grids.latent_grid import LatentGridConfig as JG
    from shacira_tpu.models.nefs.nerf import NeuralRadianceFieldConfig as JN
    from shacira_tpu.parallel.mesh import make_mesh
    from shacira_tpu.tracers import rf_tracer as jrt
    from shacira_tpu.trainers import multiview_trainer as jmt
    from shacira_tpu.utils.rng import step_key
    from tests.test_nerf import synthetic_scene

    c = NERF_CASES['flat']
    data = synthetic_scene(num_views=c['views'], res=16)
    mine = nerf_scene(c['views'], 16)
    for k in ('rgb', 'rays_o', 'rays_d'):
        np.testing.assert_array_equal(getattr(mine, k), getattr(data, k))
    grid = JG.from_geometric(
        feature_dim=2, latent_dim=1, multiscale_type='cat',
        resolution_dim=3, feature_std=0.02, init_grid='normal',
        num_prob_layers=1, entropy_enabled=True, **c['grid']).with_ldec(LDEC)
    mcfg = JN(grid=grid, hidden_dim=16, num_layers=1,
              view_embedder='positional', view_multires=2,
              blas_level=c['blas'])
    tcfg = jrt.RFTracerConfig(raymarch_type='ray', bg_color='white',
                              **c['tracer'])
    cfg = jmt.MultiviewTrainerConfig(prune_every=-1, use_sga=True,
                                     entropy_reg=1e-4, entropy_reg_end=1e-4,
                                     **c['train'])
    jtr = jmt.MultiviewTrainer(cfg, mcfg, tcfg, data, num_rays=64, seed=0,
                               mesh=make_mesh(2))
    assert jtr.shard_table_work
    start = jax.tree.map(np.array, jtr.params)
    chunks, rays = [], []
    presample, chunk_fn = jtr._presample, jtr._get_chunk_fn

    def record_rays(n):
        out = presample(n)
        rays.append(out)
        return out

    def record_chunk(use_sga):
        run = chunk_fn(use_sga)

        def wrapped(params, opt_state, noise, occ_state, tables, xs):
            chunks.append(xs['rng'])
            return run(params, opt_state, noise, occ_state, tables, xs)
        return wrapped

    jtr._presample, jtr._get_chunk_fn = record_rays, record_chunk
    iters = 10
    jtr.train(num_iterations=iters)
    want = jax.tree.map(np.asarray, jtr.params)
    cb_shape = start['grid']['codebook'].shape
    shape = jrt.march_jitter_shape(tcfg, 64)
    tiny = float(np.finfo(np.float32).tiny)
    steps = []
    for keys, (ro, rd, gt) in zip(chunks, rays):
        for i in range(len(ro)):
            k_sga, k_noise, k_march = (
                step_key(k, cfg.rng_impl)
                for k in jax.random.split(keys[i], 3))
            steps.append((
                ro[i], rd[i], gt[i],
                np.array(jocc.march_uniform(k_march, shape)),
                np.array(jax.random.uniform(k_sga, cb_shape, minval=tiny,
                                            maxval=1.0)),
                np.array(jax.random.uniform(k_noise, cb_shape) - 0.5)))
    assert len(steps) == iters
    for o in run_ranks(tmp_path, 2, _nerf_from_jax, start, steps):
        assert_params_close(o, want)

