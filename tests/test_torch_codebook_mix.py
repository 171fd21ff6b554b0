"""VQAD's straight-through codebook mix and blend (``ops/codebook.py``):
the plain twin against the expression it replaced in the octree grid, ties,
masked rows, what the wrapper refuses, and the grid's route through it on
the CPU; on the card, kernels M1 and M1(b) against the plain twin at the
``codebook.object`` cell's shapes from the benchmark's seed weights, their
argmax against PyTorch's, and their launches a training step.

No JAX import: the ``cuda`` tests run on the card's machine with
``python -m pytest --noconftest -m cuda tests/test_torch_codebook_mix.py``.

Tolerances on the card, each over the largest magnitude of what it
compares: the features and the logits' gradients 1e-5 (the kernels
compute the softmax, its argmax, the keys and the blend in PyTorch's own
orders, so the features agree to the last bit; the gradient of the keys
sums over F in another order than the GEMM, and the softmax's inner sum
in another order than PyTorch's warp), the dictionaries' gradients 1e-4
(over four million samples a LOD, summed per sample, per lane, per block
and then with atomics in an order that changes from run to run)."""
import os

import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.kernels import launch  # noqa: E402
from shacira_tpu_torch.models.grids import octree_grid as og  # noqa: E402
from shacira_tpu_torch.ops import codebook  # noqa: E402
from shacira_tpu_torch.utils import perf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALUE_TOL = 1e-5        # the features and the logits' gradients
DICT_TOL = 1e-4         # the dictionaries' gradients (atomics' order)


@pytest.fixture(params=['cpu', pytest.param('cuda', marks=pytest.mark.cuda)])
def device(request):
    if request.param == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.device(request.param)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.device('cuda')


def _inputs(n, d, f, lods, seed, device, std=1.0):
    """Random logits [n, 8, d], dictionaries [d, f], trilinear weights
    (rows summing to 1) and masks (about a quarter false) per LOD."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    logits = [torch.randn((n, 8, d), generator=gen, device=device) * std
              for _ in range(lods)]
    dicts = [torch.randn((d, f), generator=gen, device=device)
             for _ in range(lods)]
    weights = []
    for _ in range(lods):
        w = torch.rand((n, 8), generator=gen, device=device)
        weights.append(w / w.sum(-1, keepdim=True))
    valid = [torch.rand((n,), generator=gen, device=device) > 0.25
             for _ in range(lods)]
    return logits, dicts, weights, valid


def _before(l, dictionary, w, v):
    """The octree grid's training lookup before the mix had a module of
    its own, then its blend."""
    y_soft = torch.softmax(l, dim=-1)
    hard = torch.zeros_like(y_soft).scatter_(
        -1, torch.argmax(y_soft, dim=-1, keepdim=True), 1.0)
    keys = y_soft + (hard - y_soft).detach()
    return og._blend(torch.einsum('...d,df->...f', keys, dictionary), w, v)


def _grads(fn, logits, dicts, cot):
    """fn's outputs and the gradients of sum(out * cot) to the logits and
    the dictionaries."""
    ls = [t.detach().clone().requires_grad_() for t in logits]
    ds = [t.detach().clone().requires_grad_() for t in dicts]
    outs = fn(ls, ds)
    gl = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)),
                             ls + ds)
    return ([o.detach() for o in outs], list(gl[:len(ls)]),
            list(gl[len(ls):]))


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference over the largest magnitude of ``b``."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize('d,f', [(16, 5), (4, 2)])
def test_the_plain_twin_is_the_lookup_it_replaced(d, f):
    logits, dicts, weights, valid = _inputs(300, d, f, 3, 0, 'cpu')
    cot = [torch.randn((300, f)) for _ in range(3)]
    got = _grads(lambda ls, ds: codebook.codebook_mix_plain(
        ls, ds, weights, valid), logits, dicts, cot)
    want = _grads(lambda ls, ds: [_before(*a) for a in zip(
        ls, ds, weights, valid)], logits, dicts, cot)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_exact_ties_take_the_first_maximum(device):
    logits = torch.zeros((4, 8, 16), device=device)
    logits[:, :, 3] = logits[:, :, 7] = 2.0          # a tie at 3 and 7
    logits[1, :, 0] = 2.0                            # ... and 0 for one
    dictionary = torch.arange(16 * 5, dtype=torch.float32,
                              device=device).reshape(16, 5)
    w = torch.zeros((4, 8), device=device)
    w[:, 2] = 1.0
    valid = torch.ones((4,), dtype=torch.bool, device=device)
    out, = codebook.codebook_mix([logits], [dictionary], [w], [valid])
    y = torch.softmax(logits[:, 2], -1).amax(-1, keepdim=True)
    want = (y + (1 - y)) * dictionary[[3, 0, 3, 3]]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_rows_outside_the_octree_give_zeros_and_no_gradient(device):
    logits, dicts, weights, valid = _inputs(257, 16, 5, 2, 1, device)
    valid[1][::2] = False
    cot = [torch.randn((257, 5), device=device) for _ in range(2)]
    outs, gl, gd = _grads(lambda ls, ds: codebook.codebook_mix(
        ls, ds, weights, valid), logits, dicts, cot)
    for o, g, v in zip(outs, gl, valid):
        assert bool((o[~v] == 0).all()) and bool((g[~v] == 0).all())
        assert bool((o[v] != 0).any()) and bool((g[v] != 0).any())
    # masked rows add nothing to the dictionaries' gradients
    every = [torch.ones_like(v) for v in valid]
    cot_in = [c * v[:, None] for c, v in zip(cot, valid)]
    _, _, gd_in = _grads(lambda ls, ds: codebook.codebook_mix(
        ls, ds, weights, every), logits, dicts, cot_in)
    for a, b in zip(gd, gd_in):
        assert _gap(a, b) <= DICT_TOL


def test_weights_that_require_a_gradient_are_refused():
    logits, dicts, weights, valid = _inputs(8, 16, 5, 1, 2, 'cpu')
    weights[0].requires_grad_(True)
    with pytest.raises(ValueError, match='no gradient flows to the '
                       'trilinear weights'):
        codebook.codebook_mix(logits, dicts, weights, valid)


@pytest.mark.parametrize('d,f,lods', [(12, 5, 1), (128, 5, 1), (16, 17, 1),
                                      (16, 5, 17)])
def test_unsupported_widths_raise_on_the_card(monkeypatch, d, f, lods):
    """On a CUDA device (the choice stubbed: the kernel path runs for CPU
    tensors here) the wrapper refuses what M1 is not built for before it
    launches anything."""
    def kernel_path(name, device, plain, kernel):
        return kernel()[0]

    monkeypatch.setattr(launch, 'dispatch', kernel_path)
    monkeypatch.setattr(codebook, '_CodebookMix', None)   # never reached
    logits, dicts, weights, valid = _inputs(4, d, f, lods, 3, 'cpu')
    with pytest.raises(ValueError, match='^codebook_mix: unsupported'):
        codebook.codebook_mix(logits, dicts, weights, valid)


@pytest.mark.parametrize('training', [True, False])
def test_the_grid_mixes_through_codebook_mix_in_training(monkeypatch,
                                                         training):
    calls = []
    mix = og.codebook_mix

    def counting(*args):
        calls.append(len(args[0]))
        return mix(*args)

    monkeypatch.setattr(og, 'codebook_mix', counting)
    gen = torch.Generator().manual_seed(0)
    cfg = og.CodebookOctreeGridConfig(feature_dim=3, base_lod=1, num_lods=3,
                                      feature_std=0.5, codebook_bitwidth=3)
    st = og.OctreeStructure.make_dense(cfg)
    params = og.codebook_grid_init(gen, cfg, st, 'cpu')
    coords = torch.rand((50, 3), generator=gen) * 2 - 1
    out = og.codebook_interpolate(params, cfg, st, coords, training=training)
    assert out.shape == (50, 3)
    assert calls == ([3] if training else [])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _cell_inputs(dev, seed=7):
    """The mix's inputs at the ``codebook.object`` cell's shapes: the
    benchmark's seed weights (LODs 5-8, D 16, F 5) gathered at the corners
    of 4,194,304 points in the cube (4096 rays x 1024 steps)."""
    import json
    from perfbench.harness import vqad
    with open(os.path.join(ROOT, 'perfbench', 'configs',
                           'codebook.json')) as f:
        s = json.load(f)['settings']
    grid = vqad.make(s, seed, dev)['grid']
    cfg = og.CodebookOctreeGridConfig(
        feature_dim=s['feature_dim'], base_lod=s['base_lod'],
        num_lods=s['num_lods'], codebook_bitwidth=s['codebook_bitwidth'])
    st = og.OctreeStructure.make_dense(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = s['num_rays_sampled_per_img'] * s['num_steps']
    pts = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
    parts = og._corners(cfg, st, pts)
    del pts, st
    logits = og._gather(grid['logits'], parts)
    return (logits, grid['dictionary'], [w for _, w, _ in parts],
            [v for _, _, v in parts])


@pytest.mark.cuda
def test_kernels_equal_the_plain_twin_at_the_cells_shapes(cuda_device):
    logits, dicts, weights, valid = _cell_inputs(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    cot = [torch.randn((l.shape[0], dicts[0].shape[1]), generator=gen,
                       device=cuda_device) for l in logits]
    got = _grads(lambda ls, ds: codebook.codebook_mix(ls, ds, weights,
                                                      valid),
                 logits, dicts, cot)
    for k in range(len(logits)):          # the plain twin a LOD at a time
        want = _grads(lambda ls, ds: codebook.codebook_mix_plain(
            ls, ds, weights[k:k + 1], valid[k:k + 1]), logits[k:k + 1],
            dicts[k:k + 1], cot[k:k + 1])
        assert _gap(got[0][k], want[0][0]) <= VALUE_TOL, k
        assert _gap(got[1][k], want[1][0]) <= VALUE_TOL, k
        assert _gap(got[2][k], want[2][0]) <= DICT_TOL, k
        del want
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize('d,f', [(4, 1), (4, 4), (8, 3), (16, 5), (16, 12),
                                 (32, 8), (64, 16), (64, 5)])
def test_kernels_equal_the_plain_twin_at_every_width(cuda_device, d, f):
    """Every dictionary size the kernels are built for and each padded
    feature width (4, 8, 16), three LODs of unequal sample counts (one of
    them a single sample), a quarter of the rows masked."""
    inputs = [_inputs(n, d, f, 1, n, cuda_device) for n in (5000, 1, 777)]
    logits, dicts, weights, valid = (sum((x[i] for x in inputs), [])
                                     for i in range(4))
    gen = torch.Generator(device=cuda_device).manual_seed(d * f)
    cot = [torch.randn((l.shape[0], f), generator=gen, device=cuda_device)
           for l in logits]
    got = _grads(lambda ls, ds: codebook.codebook_mix(ls, ds, weights,
                                                      valid),
                 logits, dicts, cot)
    want = _grads(lambda ls, ds: codebook.codebook_mix_plain(
        ls, ds, weights, valid), logits, dicts, cot)
    for k in range(3):
        assert _gap(got[0][k], want[0][k]) <= VALUE_TOL, k
        assert _gap(got[1][k], want[1][k]) <= VALUE_TOL, k
        assert _gap(got[2][k], want[2][k]) <= DICT_TOL, k


def test_the_mix_backward_reader_reads_its_range():
    """The benchmark's ``codebook_mix_backward_ms`` reads the range around
    M1(b); a program that opens no such range gives nothing."""
    from perfbench.harness import bench, profile
    read = bench.reader(ROOT, 'codebook_mix_backward_ms.codebook')
    ranges = {'backward/encode': 8.0, 'backward/codebook_mix': 6.5}
    t = profile.Trace(steps=2, wall_s=1.0, busy_s=0.9, device_ops=100,
                      ranges_ms=ranges, kernels_s={}, gaps_s={})
    assert read(t) == 6.5
    del ranges['backward/codebook_mix']
    assert read(t) is None


@pytest.mark.cuda
def test_the_backward_range_holds_its_kernel(cuda_device):
    """In a profile, M1(b) belongs to ``backward/codebook_mix`` (the range
    ``codebook_mix_backward_ms`` reads), as M1 to ``field/codebook_mix``'s
    op."""
    from perfbench.harness import profile
    logits, dicts, weights, valid = _inputs(20000, 16, 5, 2, 4, cuda_device)
    cot = [torch.randn((20000, 5), device=cuda_device) for _ in logits]
    _grads(lambda ls, ds: codebook.codebook_mix(ls, ds, weights, valid),
           logits, dicts, cot)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function('field/codebook_mix'):
            ls = [t.detach().clone().requires_grad_() for t in logits]
            outs = codebook.codebook_mix(ls, dicts, weights, valid)
        torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)),
                            ls)
        torch.cuda.synchronize()
    t = profile.reduce(prof.events(), 1, 1.0)
    back = t.kernel_ms('mix_backward_kernel')
    fwd = t.kernel_ms('mix_forward_kernel')
    assert back and fwd
    assert t.range_ms('backward/codebook_mix') >= back
    assert t.range_ms('field/codebook_mix') >= fwd


@pytest.mark.cuda
def test_the_kernels_argmax_is_pytorchs_but_at_near_ties(cuda_device):
    """M1's argmax, read through a probe dictionary (entry d is d + 1 in
    column 0) one corner at a time, against torch.argmax of the softmax:
    rows that differ are under 1e-4 of all, each a near tie (the two
    entries' y within 4 ulp)."""
    logits, _, weights, valid = _cell_inputs(cuda_device)
    probe = torch.zeros((16, 5), device=cuda_device)
    probe[:, 0] = torch.arange(1, 17, dtype=torch.float32,
                               device=cuda_device)
    every = [torch.ones_like(v) for v in valid]
    rows = differ = 0
    for k, l in enumerate(logits):
        y = torch.softmax(l, -1)
        want = torch.argmax(y, -1)
        for c in range(8):
            w = torch.zeros_like(weights[k])
            w[:, c] = 1.0
            out, = codebook.codebook_mix([l], [probe], [w], [every[k]])
            got = torch.round(out[:, 0]).long() - 1
            bad = got != want[:, c]
            rows += int(bad.numel())
            if bool(bad.any()):
                yc = y[:, c][bad]
                ya = yc.gather(-1, got[bad, None])[:, 0]
                yb = yc.gather(-1, want[bad, c, None])[:, 0]
                ulp = torch.finfo(torch.float32).eps * yb.abs()
                assert bool(((ya - yb).abs() <= 4 * ulp).all()), (k, c)
                differ += int(bad.sum())
    assert differ / rows < 1e-4


@pytest.mark.cuda
def test_one_launch_each_way_a_training_step(cuda_device):
    """The VQAD trainer at small LODs on the card (the benchmark's
    settings, the configuration's D 16 and F 5): M1 once in a training
    step's forward, M1(b) once in its backward."""
    import json
    from perfbench.harness import bench, program
    from shacira_tpu_torch import config as cfg_mod
    from shacira_tpu_torch.apps import train_nerf
    from shacira_tpu_torch.datasets.nerf_synthetic import MultiviewData
    with open(os.path.join(ROOT, 'perfbench', 'configs',
                           'codebook.json')) as f:
        s = dict(json.load(f)['settings'], base_lod=2, num_lods=3,
                 num_rays_sampled_per_img=64, num_steps=32)
    v = bench.kind(ROOT, 'multiview_object').make(
        dict(kind='multiview_object', views=4, res=16,
             camera_angle_x=0.6911112070083618, radius=3.2,
             elevation=[0.35, 0.8], aabb_scale=3.2, dist=[0.0, 6.0],
             render_batch=2), 3, 'cpu')
    data = MultiviewData(rgb=v.rgb, rays_o=v.rays_o, rays_d=v.rays_d,
                         masks=v.masks, h=v.h, w=v.w, dist_min=v.dist_min,
                         dist_max=v.dist_max)
    args = program.parse(cfg_mod.build_nerf_parser(), s, 3, 'cuda')
    tr = train_nerf.build_trainer(args, data)
    for _ in range(2):
        perf.reset_counts()
        tr.train(num_iterations=1)
        torch.cuda.synchronize()
        assert perf.counted('launches/codebook_mix') == 1
        assert perf.counted('launches/codebook_mix_backward') == 1
    perf.reset_counts()
