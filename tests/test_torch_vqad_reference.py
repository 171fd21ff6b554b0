"""The port's VQAD (CodebookOctreeGrid) against the plain reference of
the benchmark, ``perfbench/reference/vqad.py``, on seeded random weights
at a small size on the CPU: the features and their gradients, and the
training step through the normal path (``configs/nerf_codebook.yaml``
frozen in ``perfbench/configs/codebook.json``, at LODs 2-4, D 16, F 5,
64 rays x 32 steps, built by ``apps/train_nerf.build_trainer``), two steps
from the weights and a third from the port's own state.

Tolerances, each over the largest magnitude of what it compares: both
sides compute the grid in float32 with the same operations in another
order (the port's einsum and stacked sum, the reference's matmul; one
scatter over every LOD against one a LOD), so the features and their
gradients agree to a few float32 roundings, 1e-6.  The step runs with a
float32 head, the reference in blocks of 16 rays: the loss to 1e-6, the
gradients to 1e-5, and Adam's updates to 1e-4 (an update divides by the
root of the second moment, which for an element whose gradient is near
Adam's epsilon passes a gradient's rounding on ten times).  With the
configuration's bf16 head the reference runs the batch in one block, so
that the head's matmuls take the port's shapes; a feature that differs in
its last bit may still round a head value to the next bf16 number, 4e-3
of it, so there the loss gets 1e-4 and gradients and updates 1e-2.  The
grid's path in bf16 fails the float32 head's tolerances (the last
test)."""
import ast
import json
import os

import pytest
import torch

from perfbench.harness import bench, program, vqad
from perfbench.reference import common as C
from perfbench.reference.vqad import VqadReference
from shacira_tpu_torch import config as cfg_mod
from shacira_tpu_torch.apps import train_nerf
from shacira_tpu_torch.datasets.nerf_synthetic import MultiviewData
from shacira_tpu_torch.models.grids import octree_grid as og
from shacira_tpu_torch.ops import spc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(base_lod=2, num_lods=3, num_rays_sampled_per_img=64,
             num_steps=32)
VIEWS = dict(kind='multiview_object', views=4, res=16,
             camera_angle_x=0.6911112070083618, radius=3.2,
             elevation=[0.35, 0.8], aabb_scale=3.2, dist=[0.0, 6.0],
             render_batch=2)
STEP_KW = dict(ent_lambda=0.0, temperature=1.0, lr_ldec=0.0, use_sga=False)
FEATURES_TOL = 1e-6     # float32 grid, the same operations reordered
# head precision: settings, rays a reference block, and the tolerances of
# the loss, the first gradients and Adam's updates (the module's text)
HEADS = {'f32': (dict(disable_amp=True), 16, 1e-6, 1e-5, 1e-4),
         'bf16': (dict(disable_amp=False), 64, 1e-4, 1e-2, 1e-2)}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings() -> dict:
    with open(os.path.join(ROOT, 'perfbench', 'configs',
                           'codebook.json')) as f:
        s = json.load(f)['settings']
    return dict(s, **SMALL)


def _trainer(s: dict, seed: int = 3):
    v = bench.kind(ROOT, 'multiview_object').make(VIEWS, seed, 'cpu')
    data = MultiviewData(rgb=v.rgb, rays_o=v.rays_o, rays_d=v.rays_d,
                         masks=v.masks, h=v.h, w=v.w, dist_min=v.dist_min,
                         dist_max=v.dist_max)
    args = program.parse(cfg_mod.build_nerf_parser(), s, seed, 'cpu')
    tr = train_nerf.build_trainer(args, data)
    tr.set_params(vqad.make(s, 2 * seed + 1, 'cpu'))
    return tr


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference over the largest magnitude of ``b``."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _worst(a: dict, b: dict) -> float:
    return max(_gap(a[p], b[p]) for p in b)


def test_features_and_their_gradients_equal_the_reference():
    s = _settings()
    tr = _trainer(s)
    grid = program.clone(tr.params['grid'])
    gen = torch.Generator().manual_seed(0)
    # points inside the box and some past its faces (cells clamped)
    pts = torch.rand((4096, 3), generator=gen) * 2.2 - 1.1
    cot = torch.randn((4096, s['feature_dim']), generator=gen)
    ref = VqadReference(s, 0.0, 6.0)
    # the reference's float32 products are float32 on a card too
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    def value_and_grads(fn):
        g = C.tree_map(lambda t: t.detach().clone().requires_grad_(), grid)
        f = fn(g)
        leaves = [t for _, t in C.leaves(g)]
        return f.detach(), dict(zip(
            [p for p, _ in C.leaves(g)],
            torch.autograd.grad((f * cot).sum(), leaves)))

    f_port, g_port = value_and_grads(lambda g: og.codebook_interpolate(
        g, tr.model_cfg.grid, tr.structure_tables, pts, training=True))
    f_ref, g_ref = value_and_grads(lambda g: ref.features(g, pts))
    assert _gap(f_port, f_ref) <= FEATURES_TOL
    assert _worst(g_port, g_ref) <= FEATURES_TOL


def _batch(tr):
    view = tr.np_rng.randint(tr.dataset.num_views)
    idx = tr.np_rng.randint(0, tr.dataset.rgb.shape[1], size=tr.num_rays)
    return [torch.as_tensor(a[view, idx]) for a in
            (tr.dataset.rays_o, tr.dataset.rays_d, tr.dataset.rgb)]


def _steps(tr, s, block_rays: int) -> list:
    """The port's and the reference's loss, first gradients and each
    step's update: steps 1-2 from the weights, step 3 from the port's
    state after step 2; [(name, port, reference)]."""
    ref = VqadReference(s, tr.dataset.dist_min, tr.dataset.dist_max,
                        block_rays=block_rays)
    p0 = program.clone(tr.params)
    state = dict(C.zero_moments(p0), params=p0)
    out = []
    for it in (1, 2, 3):
        rays = _batch(tr)
        draws = tr.draw_step(use_sga=False)
        if it == 3:              # teacher-forced from the port's state
            state = {'params': program.clone(tr.params),
                     'mu': program.clone(tr.opt_state['mu']),
                     'nu': program.clone(tr.opt_state['nu']),
                     'count': tr.opt_state['count']}
        before = program.clone(tr.params)
        loss = float(tr.step(*rays, draws, **STEP_KW)['loss'])
        r = ref.step(state, *rays, {'march_u': draws.march_u})
        out.append((f'loss {it}', loss, r['loss']))
        if it == 1:
            # Adam's first moment after one step is (1 - b1) g
            mu = dict(C.leaves(tr.opt_state['mu']))
            out.append(('grad 1', {p: mu[p] / (1 - C.B1)
                                   for p in r['opt_grads']},
                        r['opt_grads']))
        new, old = dict(C.leaves(tr.params)), dict(C.leaves(before))
        ref_new, ref_old = (dict(C.leaves(r['state']['params'])),
                            dict(C.leaves(state['params'])))
        out.append((f'update {it}',
                    {p: (new[p] - old[p]).detach() for p in ref_new},
                    {p: ref_new[p] - ref_old[p] for p in ref_new}))
        state = r['state']
    return out


def _misses(rows, loss_tol: float, grad_tol: float,
            update_tol: float) -> list:
    bad = []
    for name, port, ref in rows:
        if name.startswith('loss'):
            gap, tol = abs(port - ref) / abs(ref), loss_tol
        else:
            gap = _worst(port, ref)
            tol = grad_tol if name.startswith('grad') else update_tol
        if not gap <= tol:
            bad.append((name, gap))
    return bad


@pytest.mark.parametrize('head', sorted(HEADS))
def test_the_step_equals_the_reference(head):
    over, block, *tols = HEADS[head]
    s = dict(_settings(), **over)
    rows = _steps(_trainer(s), s, block)
    assert [r[0] for r in rows] == ['loss 1', 'grad 1', 'update 1',
                                    'loss 2', 'update 2', 'loss 3',
                                    'update 3']
    assert _misses(rows, *tols) == []
    # the steps moved every table
    for name, port, _ in rows:
        if name.startswith('update'):
            assert all(float(port[p].abs().max()) > 0 for p in port
                       if p[0] == 'grid'), name


def test_the_grid_in_bf16_fails_the_tolerances(monkeypatch):
    """A planted fault: the codebook mix fed logits and dictionaries
    rounded to bf16."""
    mix = og.codebook_mix

    def bf16(logits, dictionaries, weights, valid):
        return mix([l.bfloat16().float() for l in logits],
                   [d.bfloat16().float() for d in dictionaries], weights,
                   valid)

    monkeypatch.setattr(og, 'codebook_mix', bf16)
    over, block, *tols = HEADS['f32']
    s = dict(_settings(), **over)
    tr = _trainer(s)
    ref = VqadReference(s, 0.0, 6.0)
    pts = torch.rand((4096, 3), generator=torch.Generator().manual_seed(0)
                     ) * 2 - 1
    grid = tr.params['grid']
    with torch.no_grad():
        f = og.codebook_interpolate(grid, tr.model_cfg.grid,
                                    tr.structure_tables, pts)
        assert _gap(f, ref.features(grid, pts)) > 100 * FEATURES_TOL
    assert len(_misses(_steps(tr, s, block), *tols)) >= 1


def test_the_references_import_nothing_of_the_program_or_jax():
    ref = os.path.join(ROOT, 'perfbench', 'reference')
    names = sorted(n for n in os.listdir(ref) if n.endswith('.py'))
    assert 'vqad.py' in names
    for name in names:
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split('.')[0] not in (
                    'shacira_tpu_torch', 'shacira_tpu', 'jax', 'jaxlib',
                    'flax'), (name, m)


def test_the_reference_finds_every_corner_of_the_dense_octree():
    """Its corner rows, found by searching the lattice's codes, are the
    rows of the program's dual octree (the trinkets) for every cell."""
    s = _settings()
    tr = _trainer(s)
    ref = VqadReference(s, 0.0, 6.0)
    tables = tr.structure_tables
    for i, lod in enumerate(range(s['base_lod'],
                                  s['base_lod'] + s['num_lods'])):
        res = 2 ** lod
        ar = torch.arange(res)
        cells = torch.stack(torch.meshgrid(ar, ar, ar, indexing='ij'),
                            -1).reshape(-1, 3)
        centres = (cells.float() + 0.5) / res * 2 - 1
        rows, w = ref.corners(lod, centres)
        pidx = spc.query_cells(tables['codes'][i], cells)
        assert bool((pidx >= 0).all())
        assert torch.equal(rows, tables['trinkets'][i][pidx].long())
        assert torch.allclose(w, torch.full_like(w, 0.125))
