"""Kernel E1(b) (``hash_encode_backward`` in ``csrc/hash_encode.cu``): the
flat hash encode's backward up to the scatter, one launch over every LOD,
and its plain PyTorch twins ``hashgrid.backward_updates_plain`` (the rows
the scatter adds and the affine path's scale and shift gradients) and
``hashgrid.encode_backward_plain`` (with the scatter).

On the CPU: the plain twin against autograd through ``encode_plain`` and
against the JAX package's VJP, on 2D and 3D grids, latent widths 1 and 2,
the plain (non-affine) encode, rows of an all-zero gradient and a point
count that is no multiple of the kernel's 32-point tile; the Functions
take the twin and launch nothing; shapes the kernel does not take raise.

On the card (``cuda``; no JAX is imported at module level, so
``python -m pytest --noconftest -m cuda tests/test_torch_encode_backward.py``
runs there): the kernel against the twin at the same cases, at lego's and
V8's widths and at widths only its run-time column loops take, one launch
a backward, its scale and shift gradients the same bits on every run, and
its time inside ``backward/encode`` in a profile.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.ops import hashgrid  # noqa: E402
from shacira_tpu_torch.ops.hashgrid import (  # noqa: E402
    HashGridSpec, geometric_resolutions)
from shacira_tpu_torch.utils import perf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-4         # f32 sums over every point in another order

# name -> (spec, feature width F, latent width ld (0: the plain encode of a
# [T, F] table), points N, share of (point, LOD) gradient rows set to zero)
CASES = {
    'dim3_ld1': (HashGridSpec((4, 9, 40), 10, 3), 4, 1, 300, 0.0),
    'dim3_ld2': (HashGridSpec((5, 13, 50), 10, 3), 4, 2, 300, 0.0),
    'dim2_ld1': (HashGridSpec((6, 21, 90), 9, 2), 1, 1, 300, 0.0),
    'dim2_ld2': (HashGridSpec((6, 21, 90), 9, 2), 4, 2, 300, 0.0),
    'plain_dim3': (HashGridSpec((4, 11, 40), 9, 3), 4, 0, 300, 0.0),
    'plain_dim2': (HashGridSpec((6, 21, 90), 9, 2), 2, 0, 300, 0.0),
    'zero_rows': (HashGridSpec((5, 13, 50), 10, 3), 4, 2, 320, 0.6),
    'ragged_n': (HashGridSpec((5, 13, 50), 10, 3), 4, 1, 77, 0.3),
}


def _inputs(name, seed=0, device='cpu', n=None):
    """(coords [N, dim], leaves: (z, scale, shift) or (table,), cotangent
    g [N, L, F]) of a case; a share of g's (point, LOD) rows zeroed."""
    spec, f, ld, n_case, zero = CASES[name]
    n = n_case if n is None else n
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-1.1, 1.1, (n, spec.dim)).astype(np.float32)
    if ld:
        leaves = (rng.randn(spec.total_size, ld), rng.randn(ld, f),
                  rng.randn(1, f))
    else:
        leaves = (rng.randn(spec.total_size, f),)
    g = rng.randn(n, spec.num_lods, f).astype(np.float32)
    g *= rng.uniform(size=(n, spec.num_lods, 1)) >= zero
    return (torch.as_tensor(coords, device=device),
            [torch.as_tensor(a.astype(np.float32), device=device)
             for a in leaves],
            torch.as_tensor(g, device=device))


def _saved(coords, leaves, spec):
    """What the forward saves for the backward: gidx, w, zbar (None on the
    plain encode)."""
    if len(leaves) == 3:
        z, scale, shift = leaves
        _, zbar, gidx, w = hashgrid.encode_plain(coords, z @ scale + shift,
                                                 spec, None, z)
        return gidx, w, zbar
    _, _, gidx, w = hashgrid.encode_plain(coords, leaves[0], spec)
    return gidx, w, None


def _twin(coords, leaves, g, spec):
    gidx, w, zbar = _saved(coords, leaves, spec)
    scale = leaves[1] if len(leaves) == 3 else None
    return hashgrid.encode_backward_plain(g, gidx, w, zbar, scale,
                                          spec.total_size)


def _close(got, want, tol=GRAD_TOL):
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()))


@pytest.mark.parametrize('name', list(CASES))
def test_plain_twin_is_autograd_through_encode_plain(name):
    spec = CASES[name][0]
    coords, leaves, g = _inputs(name)
    xs = [t.clone().requires_grad_(True) for t in leaves]
    table = xs[0] @ xs[1] + xs[2] if len(xs) == 3 else xs[0]
    zt = xs[0] if len(xs) == 3 else None
    feats = hashgrid.encode_plain(coords, table, spec, None, zt)[0]
    want = torch.autograd.grad(torch.sum(feats * g), xs)
    got = _twin(coords, leaves, g, spec)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize('name', list(CASES))
def test_plain_twin_matches_the_jax_vjp(name):
    jax = pytest.importorskip('jax')
    jnp = pytest.importorskip('jax.numpy')
    from shacira_tpu.ops import hashgrid as jhg
    spec = CASES[name][0]
    jspec = jhg.HashGridSpec(spec.resolutions, spec.codebook_bitwidth,
                             spec.dim)
    coords, leaves, g = _inputs(name, seed=1)
    jc = jnp.asarray(coords.numpy())
    if len(leaves) == 3:
        def fn(z, s, b):
            return jhg.hash_encode_affine(jc, z, s, b, jspec)
    else:
        def fn(t):
            return jhg.hash_encode(jc, t, jspec)
    _, vjp = jax.vjp(fn, *[jnp.asarray(t.numpy()) for t in leaves])
    want = vjp(jnp.asarray(g.numpy()))
    got = _twin(coords, leaves, g, spec)
    for a, b in zip(got, want):
        _close(a, torch.as_tensor(np.array(b)))


@pytest.mark.parametrize('name', ['zero_rows', 'plain_dim3'])
def test_zero_gradient_rows_give_zero_updates(name):
    spec = CASES[name][0]
    coords, leaves, g = _inputs(name, seed=2)
    gidx, w, zbar = _saved(coords, leaves, spec)
    scale = leaves[1] if len(leaves) == 3 else None
    upd = hashgrid.backward_updates_plain(g, w, zbar, scale)[0]
    zero = (g == 0).all(-1).t()                       # [L, N]
    assert upd.shape == (*w.shape, scale.shape[0] if scale is not None
                         else g.shape[-1])
    assert torch.equal(upd[zero], torch.zeros_like(upd[zero]))


@pytest.mark.parametrize('affine', [False, True])
def test_functions_take_the_twin_on_the_cpu_and_launch_nothing(affine):
    name = 'dim3_ld2' if affine else 'plain_dim3'
    spec = CASES[name][0]
    coords, leaves, g = _inputs(name, seed=3)
    xs = [t.clone().requires_grad_(True) for t in leaves]
    before = perf.counted('launches/hash_encode_backward')
    if affine:
        out = hashgrid.hash_encode_affine(coords, *xs, spec)
    else:
        out = hashgrid.hash_encode(coords, xs[0], spec)
    got = torch.autograd.grad(torch.sum(out * g), xs)
    want = _twin(coords, leaves, g, spec)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert perf.counted('launches/hash_encode_backward') == before


def test_mismatched_shapes_raise():
    spec = CASES['dim3_ld2'][0]
    coords, leaves, g = _inputs('dim3_ld2')
    gidx, w, zbar = _saved(coords, leaves, spec)
    with pytest.raises(ValueError, match='^encode_backward'):
        hashgrid.encode_backward(g[:-1], gidx, w, zbar, leaves[1],
                                 spec.total_size)
    with pytest.raises(ValueError, match='^encode_backward'):
        hashgrid.encode_backward(g, gidx, w, None, leaves[1],
                                 spec.total_size)
    with pytest.raises(ValueError, match='^encode_backward'):
        hashgrid.encode_backward(g, gidx, w, zbar, leaves[1][:, :2],
                                 spec.total_size)


@pytest.mark.parametrize('c, lods, f, ld', [
    (2, 3, 4, 1), (8, hashgrid.MAX_LODS + 1, 4, 1),
    (8, 3, hashgrid.MAX_WIDTH + 1, 0), (4, 3, 4, hashgrid.MAX_WIDTH + 1)])
def test_widths_the_kernel_does_not_take_raise_before_a_launch(c, lods, f,
                                                               ld):
    n = 5
    g = torch.zeros((n, lods, f))
    w = torch.zeros((lods, n, c))
    zbar = torch.zeros((lods, n, ld)) if ld else None
    scale = torch.zeros((ld, f)) if ld else None
    with pytest.raises(ValueError, match='^kernel E1\\(b\\) takes'):
        hashgrid._launch_encode_backward(g, w, zbar, scale)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _max_rel(got, want) -> float:
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _check_kernel(g, w, zbar, scale):
    """E1(b) against ``backward_updates_plain`` on the same card tensors:
    every row within 1e-6 of the largest (gz's F products summed in another
    order), rows of a zero gradient exactly zero, the two sums within
    ``GRAD_TOL``."""
    got = hashgrid._launch_encode_backward(g, w, zbar, scale)
    want = hashgrid.backward_updates_plain(g, w, zbar, scale)
    torch.cuda.synchronize()
    assert got[0].shape == want[0].shape and got[0].is_contiguous()
    assert _max_rel(got[0], want[0]) <= 1e-6
    zero = (g == 0).all(-1).t()
    assert not got[0][zero].any()
    for a, b in zip(got[1:], want[1:]):
        assert (a is None) == (b is None)
        if b is not None:
            _close(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(CASES))
def test_kernel_matches_the_twin(cuda_device, name):
    spec = CASES[name][0]
    coords, leaves, g = _inputs(name, seed=4, device=cuda_device)
    gidx, w, zbar = _saved(coords, leaves, spec)
    scale = leaves[1] if len(leaves) == 3 else None
    _check_kernel(g, w, zbar, scale)
    got = hashgrid.encode_backward(g, gidx, w, zbar, scale, spec.total_size)
    want = hashgrid.encode_backward_plain(g, gidx, w, zbar, scale,
                                          spec.total_size)
    for a, b in zip(got, want):
        if b is not None:
            _close(a, b)


def _step_like(dev, n, lods, c, f, ld, zero, seed):
    """Backward inputs at a step's widths, ``n`` points: weights that sum
    to one over the corners, g with a share ``zero`` of its rows zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((lods, n, c), generator=gen, device=dev)
    w /= w.sum(-1, keepdim=True)
    g = torch.randn((n, lods, f), generator=gen, device=dev)
    g *= torch.rand((n, lods, 1), generator=gen, device=dev) >= zero
    zbar = torch.randn((lods, n, ld), generator=gen, device=dev) if ld \
        else None
    scale = torch.randn((ld, f), generator=gen, device=dev) if ld else None
    return g, w, zbar, scale


# (points, LODs, corners, F, ld, share of zero rows): lego's step (24 LODs,
# ld 1, ~89 % padding rows), V8's (20 LODs, ld 2, ~36 % masked slots), and
# widths only the run-time column loops take
WIDTHS = {
    'lego': (100_003, 24, 8, 4, 1, 0.89),
    'v8': (100_003, 20, 8, 4, 2, 0.36),
    'image_2d': (40_000, 24, 4, 1, 1, 0.0),
    'hashgrid': (50_000, 16, 8, 2, 0, 0.5),
    'runtime_affine': (33_333, 7, 8, 3, 5, 0.2),
    'runtime_affine_2d': (33_333, 5, 4, 8, 8, 0.2),
    'runtime_plain': (33_333, 64, 8, 5, 0, 0.2),
    'one_point': (1, 3, 8, 4, 2, 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(WIDTHS))
def test_kernel_at_the_step_widths(cuda_device, name):
    _check_kernel(*_step_like(cuda_device, *WIDTHS[name], seed=5))


@pytest.mark.cuda
def test_scale_and_shift_gradients_are_the_same_bits_every_run(cuda_device):
    inputs = _step_like(cuda_device, *WIDTHS['v8'], seed=6)
    first = hashgrid._launch_encode_backward(*inputs)
    for _ in range(3):
        again = hashgrid._launch_encode_backward(*inputs)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_no_points_give_zero_gradients(cuda_device):
    g, w, zbar, scale = _step_like(cuda_device, 0, 3, 8, 4, 2, 0.0, seed=7)
    upd, gs, gsh = hashgrid._launch_encode_backward(g, w, zbar, scale)
    torch.cuda.synchronize()
    assert upd.shape == (3, 0, 8, 2)
    assert not gs.any() and not gsh.any()


@pytest.mark.cuda
def test_one_launch_a_backward(cuda_device):
    spec = CASES['dim3_ld2'][0]
    coords, leaves, g = _inputs('dim3_ld2', seed=8, device=cuda_device)
    xs = [t.clone().requires_grad_(True) for t in leaves]
    table = torch.randn((spec.total_size, 4), device=cuda_device,
                        requires_grad=True)
    perf.reset_counts()
    out = hashgrid.hash_encode_affine(coords, *xs, spec)
    torch.autograd.grad(torch.sum(out * g), xs)
    assert perf.counted('launches/hash_encode_backward') == 1
    out = hashgrid.hash_encode(coords, table, spec)
    torch.autograd.grad(torch.sum(out * g), table)
    assert perf.counted('launches/hash_encode_backward') == 2
    assert perf.counted('launches/scatter_add') == 2
    perf.reset_counts()


@pytest.mark.cuda
def test_the_backward_range_holds_the_kernel(cuda_device):
    """In a profile, E1(b) belongs to ``backward/encode`` (the range
    ``encode_backward_ms`` reads) through its own op record."""
    from perfbench.harness import profile
    spec = HashGridSpec(geometric_resolutions(16, 512, 20), 17, 3)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    coords = torch.rand((200_000, 3), generator=gen, device=cuda_device) \
        * 2 - 1
    z = torch.randn((spec.total_size, 2), device=cuda_device,
                    requires_grad=True)
    scale = torch.randn((2, 4), device=cuda_device, requires_grad=True)
    shift = torch.randn((1, 4), device=cuda_device, requires_grad=True)
    cot = torch.randn((200_000, spec.num_lods, 4), device=cuda_device)

    def step():
        out = hashgrid.hash_encode_affine(coords, z, scale, shift, spec)
        torch.autograd.grad(torch.sum(out * cot), (z, scale, shift))

    step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    t = profile.reduce(prof.events(), 1, 1.0)
    kernel = t.kernel_ms('hash_encode_backward_kernel')
    assert kernel
    assert t.range_ms('backward/encode') >= kernel
    assert not any('hash_encode_backward' in k and
                   ('scatter_add_rows_kernel' in k or 'voxel_dda' in k)
                   for k in t.kernels_s)


@pytest.mark.cuda
def test_one_launch_a_flat_training_step(cuda_device):
    """The lego configuration's flat trainer at small widths on the card:
    one E1(b) launch in each training step's backward."""
    import json
    from perfbench.harness import bench, program
    from shacira_tpu_torch import config as cfg_mod
    from shacira_tpu_torch.apps import train_nerf
    from shacira_tpu_torch.datasets.nerf_synthetic import MultiviewData
    with open(os.path.join(ROOT, 'perfbench', 'configs', 'lego.json')) as f:
        s = dict(json.load(f)['settings'], num_lods=4, codebook_bitwidth=12,
                 num_rays_sampled_per_img=64, num_steps=64,
                 max_samples=4096)
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
        assert perf.counted('launches/hash_encode_backward') == 1
    perf.reset_counts()
