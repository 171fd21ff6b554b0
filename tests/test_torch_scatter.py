"""Port parity: the scatter-add and segment sum of shacira_tpu_torch.ops.scatter
against shacira_tpu.ops.pallas_scatter (XLA path and the Pallas kernel in
interpret mode), and the CUDA kernel against its plain version on a card.

Tolerance: 1e-6 absolute on sums of O(1) values in f32 where both sides add
in input order (the plain version and XLA on the CPU); the one-hot matmul of
the Pallas kernel adds in another order, so there 1e-6 of the largest sum
(a few f32 ulps)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.kernels import build  # noqa: E402
from shacira_tpu_torch.ops import scatter  # noqa: E402

try:        # the card's machine has no JAX: only the kernel tests run there
    import jax
    import jax.numpy as jnp
    from shacira_tpu.ops import pallas_scatter as jps
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None,
                               reason='needs the JAX package (the reference)')

ATOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _inputs(seed, n, t, f):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, t, size=n).astype(np.int32)
    vals = rng.randn(n, f).astype(np.float32)
    return idx, vals


@needs_jax
@pytest.mark.parametrize('n,t,f', [(500, 37, 1), (700, 300, 5), (64, 1, 3)])
def test_scatter_add_matches_jax(n, t, f):
    idx, vals = _inputs(0, n, t, f)
    got = scatter.scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), t)
    want = np.asarray(jps.scatter_add(jnp.asarray(idx), jnp.asarray(vals), t))
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, f)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@needs_jax
@pytest.mark.parametrize('t,f', [(37, 1), (64, 5)])
def test_scatter_add_matches_pallas_kernel_interpret(t, f):
    idx, vals = _inputs(1, 2048, t, f)
    got = scatter.scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), t)
    want = np.asarray(jps.onehot_scatter_add(
        jnp.asarray(idx), jnp.asarray(vals), t, block=2048, sub_block=1024,
        interpret=True, compute_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=ATOL * np.abs(want).max(), rtol=0)


def _with_out_of_range(idx, t):
    idx = idx.copy()
    idx[::7] = -1
    idx[3::11] = t
    idx[5::13] = t + 1000
    return idx


@needs_jax
def test_out_of_range_indices_dropped_like_pallas_kernel():
    t, f = 37, 2
    idx, vals = _inputs(5, 2048, t, f)
    idx = _with_out_of_range(idx, t)
    got = scatter.scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), t)
    want = np.asarray(jps.onehot_scatter_add(
        jnp.asarray(idx), jnp.asarray(vals), t, block=2048, sub_block=1024,
        interpret=True, compute_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=ATOL * np.abs(want).max(), rtol=0)


@needs_jax
def test_segment_sum_and_grad_match_jax():
    rng = np.random.RandomState(2)
    rays = 16
    ids = np.sort(rng.randint(0, rays, size=300)).astype(np.int32)
    ids = np.concatenate([ids, np.zeros(40, np.int32)])  # zero-filled tail
    vals = rng.randn(ids.shape[0], 5).astype(np.float32)
    ct = rng.randn(rays, 5).astype(np.float32)

    want = np.asarray(jps.segment_sum(jnp.asarray(ids), jnp.asarray(vals),
                                      rays))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jps.segment_sum(jnp.asarray(ids), v, rays) * ct))(jnp.asarray(vals)))

    v = torch.tensor(vals, requires_grad=True)
    got = scatter.segment_sum(torch.as_tensor(ids), v, rays)
    (got_g,) = torch.autograd.grad(torch.sum(got * torch.as_tensor(ct)), v)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=ATOL, rtol=0)


def test_plain_versions_do_not_count_launches():
    scatter.reset_launches()
    idx, vals = _inputs(3, 50, 9, 2)
    scatter.scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), 9)
    scatter.segment_sum(torch.as_tensor(idx), torch.as_tensor(vals), 9)
    assert scatter.scatter_add.launches == 0
    assert scatter.segment_sum.launches == 0


def test_non_cpu_tensor_without_kernel_raises():
    """A tensor off the CPU never takes the plain version."""
    idx = torch.zeros(4, dtype=torch.int32, device='meta')
    vals = torch.zeros((4, 1), device='meta')
    with pytest.raises(RuntimeError):
        scatter.scatter_add(idx, vals, 3)
    with pytest.raises(RuntimeError):
        scatter.segment_sum(idx, vals, 3)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(build.os.path, 'exists', lambda p: False)
    with pytest.raises(RuntimeError, match='nvcc'):
        build.build('scatter')


def test_shape_checks():
    with pytest.raises(ValueError):
        scatter.scatter_add(torch.zeros(3, dtype=torch.int32),
                            torch.zeros((4, 1)), 2)


@pytest.mark.cuda
@pytest.mark.parametrize('n,t,f', [(1 << 20, 1 << 19, 1), (1 << 18, 4096, 5)])
def test_scatter_kernel_matches_plain_on_card(cuda_device, n, t, f):
    idx, vals = _inputs(4, n, t, f)
    idx_t = torch.as_tensor(idx, device=cuda_device)
    vals_t = torch.as_tensor(vals, device=cuda_device)
    before = scatter.scatter_add.launches
    got = scatter.scatter_add(idx_t, vals_t, t)
    torch.cuda.synchronize()
    assert scatter.scatter_add.launches == before + 1
    want = scatter.scatter_add_plain(idx_t, vals_t, t)
    # float atomics add in another order: 1e-5 of the largest sum
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_scatter_kernel_drops_out_of_range_on_card(cuda_device):
    t = 300
    idx, vals = _inputs(6, 4096, t, 3)
    idx_t = torch.as_tensor(_with_out_of_range(idx, t), device=cuda_device)
    vals_t = torch.as_tensor(vals, device=cuda_device)
    got = scatter.scatter_add(idx_t, vals_t, t)
    want = scatter.scatter_add_plain(idx_t, vals_t, t)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


def _ray_ordered_corners(n_rays=128, steps=1024, budget=1 << 15, seed=7):
    """Hash-grid corner indices [L * N * 8] of samples along rays in
    (ray, depth) order after the stride compaction, as the flat lego step
    hands them to the kernel (24 LODs, 2^19 rows a LOD)."""
    from shacira_tpu_torch.ops import hashgrid
    from shacira_tpu_torch.tracers.rf_tracer import _stride_compact
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n_rays, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(0.8, 4.4, steps)
    pts = torch.as_tensor((o[:, None] + d[:, None] * t[None, :, None]
                           ).reshape(-1, 3).astype(np.float32))
    inside = torch.all(pts.abs() <= 1.0, dim=-1)
    src, valid, _ = _stride_compact(inside, budget)
    spec = hashgrid.HashGridSpec(hashgrid.geometric_resolutions(16, 512, 24),
                                 19, 3)
    gidx, _ = hashgrid._all_corners(pts[src[valid]], spec)
    return gidx.reshape(-1).numpy(), spec.total_size


def _card_case(name):
    """(idx, vals, table rows) of one merge case of the kernel."""
    rng = np.random.default_rng(8)
    if name == 'every index equal':
        return np.full(10_000, 7), rng.normal(size=(10_000, 1)), 20
    if name == 'sorted runs F5, zero tail at 0':
        ids = np.sort(rng.integers(0, 4096, 300_000))
        ids = np.concatenate([ids, np.zeros(60_000, np.int64)])
        vals = rng.normal(size=(ids.shape[0], 5))
        vals[300_000:] = 0.0
        return ids, vals, 4096
    if name == 'ray-ordered hash corners':
        idx, t = _ray_ordered_corners()
        return idx, rng.normal(size=(idx.shape[0], 1)), t
    if name.startswith('ragged'):     # n not a multiple of the chunk
        f = int(name[-1])
        return (rng.integers(0, 500, 100_003), rng.normal(size=(100_003, f)),
                500)
    # 40 keys in turn, offset every 640 rows: no lane's row repeats the
    # key of its row before, so every row is one atomic
    n = 1 << 22
    keys = np.arange(n) % 40 + 40 * (np.arange(n) // 640 % 1000)
    return keys, rng.normal(size=(n, 1)), 40_000


@pytest.mark.cuda
@pytest.mark.parametrize('name', [
    'every index equal', 'sorted runs F5, zero tail at 0',
    'ray-ordered hash corners', 'ragged F1', 'ragged F5',
    'nothing to merge'])
def test_scatter_kernel_merge_cases_on_card(cuda_device, name):
    idx, vals, t = _card_case(name)
    idx_t = torch.as_tensor(idx.astype(np.int32), device=cuda_device)
    vals_t = torch.as_tensor(vals.astype(np.float32), device=cuda_device)
    got = scatter.scatter_add(idx_t, vals_t, t)
    want = scatter.scatter_add_plain(idx_t, vals_t, t)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


def _mirror_merge(idx, v, t):
    """(keys, sums) that the kernel's plain mirror issues for one column
    ``v`` [N] f32 of the scatter of ``idx`` [N] into ``t`` rows."""
    chunk = scatter.merge_chunk_rows(idx.shape[0])
    idx = torch.as_tensor(idx, dtype=torch.long)
    keys = torch.where((v != 0) & (idx >= 0) & (idx < t), idx, -1)
    return scatter.run_merge(scatter.lane_walks(keys, chunk),
                             scatter.lane_walks(v, chunk, fill=0.0))


@pytest.mark.parametrize('name', ['ray-ordered hash corners',
                                  'sorted runs F5, zero tail at 0',
                                  'nothing to merge'])
def test_run_merge_mirror_on_the_card_cases(name):
    """The kernel's merge, mirrored in plain PyTorch on the card cases:
    the issued sums give the plain scatter; ray-ordered corners and
    sorted runs merge, 40 keys in turn do not."""
    idx, vals, t = _card_case(name)
    v = torch.as_tensor(vals[:, 0], dtype=torch.float32)
    k, s = _mirror_merge(idx, v, t)
    got = scatter.scatter_add_plain(k, s[:, None], t)
    want = scatter.scatter_add_plain(torch.as_tensor(idx), v[:, None], t)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    updates = int(np.count_nonzero(vals[:, 0]))
    if name == 'nothing to merge':
        assert k.numel() == updates
    else:
        assert k.numel() < 0.7 * updates


@pytest.mark.cuda
@pytest.mark.parametrize('name', [
    'every index equal', 'sorted runs F5, zero tail at 0',
    'ray-ordered hash corners', 'ragged F5', 'nothing to merge'])
def test_run_merge_mirror_counts_the_kernels_atomics_on_card(cuda_device,
                                                             name):
    """The plain mirror issues exactly the global atomics that the kernel,
    built to count them, issues on the card: the mirror's walk (chunk
    rule, runs of rows 8 apart) is the kernel's."""
    from shacira_tpu_torch.kernels.build import load, take_global_atomics
    idx, vals, t = _card_case(name)
    vals = vals.astype(np.float32)
    lib = load('scatter', count_atomics=True)
    take_global_atomics(lib)
    got = scatter._launch_scatter(
        torch.as_tensor(idx.astype(np.int32), device=cuda_device),
        torch.as_tensor(vals, device=cuda_device), t, lib=lib)
    counted = take_global_atomics(lib)
    mirrored = sum(_mirror_merge(idx, torch.as_tensor(vals[:, c]), t)[0]
                   .numel() for c in range(vals.shape[1]))
    assert counted == mirrored
    want = scatter.scatter_add_plain(torch.as_tensor(idx),
                                     torch.as_tensor(vals), t)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
