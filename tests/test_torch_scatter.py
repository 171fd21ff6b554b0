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
from shacira_tpu_torch.utils import perf  # noqa: E402

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
@pytest.mark.parametrize('n,t,f', [(500, 37, 1), (700, 300, 5), (64, 1, 3),
                                   (600, 50, 16), (333, 70, 4)])
def test_scatter_add_matches_jax(n, t, f):
    idx, vals = _inputs(0, n, t, f)
    got = scatter.scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), t)
    want = np.asarray(jps.scatter_add(jnp.asarray(idx), jnp.asarray(vals), t))
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, f)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@needs_jax
@pytest.mark.parametrize('t,f', [(37, 1), (64, 5), (40, 16), (64, 4)])
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
    perf.reset_counts()
    idx, vals = _inputs(3, 50, 9, 2)
    scatter.scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), 9)
    scatter.segment_sum(torch.as_tensor(idx), torch.as_tensor(vals), 9)
    assert perf.counted('launches/scatter_add') == 0
    assert perf.counted('launches/segment_sum') == 0


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
    before = perf.counted('launches/scatter_add')
    got = scatter.scatter_add(idx_t, vals_t, t)
    torch.cuda.synchronize()
    assert perf.counted('launches/scatter_add') == before + 1
    want = scatter.scatter_add_plain(idx_t, vals_t, t)
    # float atomics add in another order: 1e-5 of the largest sum
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_segment_sum_at_the_extras_width_on_card(cuda_device):
    """B1(b) with the tracer's extra channels: per-ray sums of 5 + 3
    columns, 1,048,576 rows into 4096 rays, ids sorted over the valid
    prefix and a zero-weight tail on ray 0 (as the compact trace gives
    them); one launch, within 1e-5 of the largest sum."""
    rng = np.random.RandomState(8)
    n, rays, valid = 1 << 20, 4096, 900_000
    ids = np.zeros(n, np.int32)
    ids[:valid] = np.sort(rng.randint(0, rays, valid))
    vals = rng.randn(n, 8).astype(np.float32)
    vals[valid:] = 0.0
    idx_t = torch.as_tensor(ids, device=cuda_device)
    vals_t = torch.as_tensor(vals, device=cuda_device)
    before = perf.counted('launches/segment_sum')
    got = scatter.segment_sum(idx_t, vals_t, rays)
    torch.cuda.synchronize()
    assert perf.counted('launches/segment_sum') == before + 1
    want = scatter.scatter_add_plain(idx_t, vals_t, rays)
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


def _sorted_rows_with_zeros(rng, n, t, f):
    """Sorted runs of ``n`` rows of ``f`` columns into ``t`` rows: a
    zero-weight tail on row 0, every 7th row all zero, every 3rd row zero
    in its first half of columns, and every 11th index out of range."""
    ids = np.sort(rng.integers(0, t, n))
    ids = np.concatenate([ids, np.zeros(n // 5, np.int64)])
    vals = rng.normal(size=(ids.shape[0], f))
    vals[n:] = 0.0
    vals[::7] = 0.0
    vals[::3, :(f + 1) // 2] = 0.0
    ids[::11] = np.where(np.arange(ids[::11].shape[0]) % 2, -1, t)
    return ids, vals, t


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
        f = int(name.split('F')[-1])
        return (rng.integers(0, 500, 100_003), rng.normal(size=(100_003, f)),
                500)
    if name.startswith('sorted runs F'):    # wide rows, some of them zero
        f = int(name.split()[2][1:])
        return _sorted_rows_with_zeros(rng, 300_000, 4096, f)
    # 40 keys in turn, offset every 640 rows: no lane's row repeats the
    # key of its row before, so every row is one atomic
    n = 1 << 22
    keys = np.arange(n) % 40 + 40 * (np.arange(n) // 640 % 1000)
    return keys, rng.normal(size=(n, 1)), 40_000


CARD_CASES = ['every index equal', 'sorted runs F5, zero tail at 0',
              'ray-ordered hash corners', 'ragged F1', 'ragged F5',
              'nothing to merge', 'ragged F2', 'ragged F4', 'ragged F8',
              'ragged F16', 'ragged F3', 'ragged F12',
              'sorted runs F16 with zero rows',
              'sorted runs F8 with zero rows',
              'sorted runs F2 with zero rows']


@pytest.mark.cuda
@pytest.mark.parametrize('name', CARD_CASES)
def test_scatter_kernel_merge_cases_on_card(cuda_device, name):
    idx, vals, t = _card_case(name)
    idx_t = torch.as_tensor(idx.astype(np.int32), device=cuda_device)
    vals_t = torch.as_tensor(vals.astype(np.float32), device=cuda_device)
    got = scatter.scatter_add(idx_t, vals_t, t)
    want = scatter.scatter_add_plain(idx_t, vals_t, t)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


def _mirror_merge(idx, vals, t):
    """(keys, sums [M, F], atomics) that the kernel's plain mirror issues
    for the scatter of ``idx`` [N] and ``vals`` [N, F] into ``t`` rows."""
    return scatter.merge_plain(torch.as_tensor(idx),
                               torch.as_tensor(vals, dtype=torch.float32), t)


def _unmerged_atomics(idx, vals, t):
    """Atomics of a walk that merges nothing: one for each group of
    ``vector_width`` columns holding a non-zero, in each live row."""
    v = scatter.vector_width(vals.shape[1])
    groups = (vals.reshape(vals.shape[0], -1, v) != 0).any(2)
    live = (idx >= 0) & (idx < t) & (vals != 0).any(1)
    return int(groups[live].sum())


@pytest.mark.parametrize('f', [1, 2, 4, 5, 8, 16])
def test_merge_mirror_matches_plain_at_every_width(f):
    """The mirror of the kernel's walk (per-row liveness, one atomic per
    group of ``vector_width(f)`` columns) sums to the plain scatter on a
    ragged n with all-zero rows, rows with some zeros and out-of-range
    indices; sorted runs merge, and where no index repeats every live row
    issues one atomic per group of its columns that holds a non-zero."""
    assert scatter.vector_width(f) == {1: 1, 2: 2, 4: 4, 5: 1, 8: 4,
                                       16: 4}[f]
    rng = np.random.default_rng(f)
    idx, vals, t = _sorted_rows_with_zeros(rng, 5_003, 97, f)
    k, s, atomics = _mirror_merge(idx, vals, t)
    want = scatter.scatter_add_plain(torch.as_tensor(idx),
                                     torch.as_tensor(vals).float(), t)
    got = scatter.scatter_add_plain(k, s, t)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert atomics < 0.8 * _unmerged_atomics(idx, vals, t)

    distinct = rng.permutation(idx.shape[0] + 200)[:idx.shape[0]] - 100
    _, _, atomics = _mirror_merge(distinct, vals, idx.shape[0])
    assert atomics == _unmerged_atomics(distinct, vals, idx.shape[0])


@pytest.mark.parametrize('name', ['ray-ordered hash corners',
                                  'sorted runs F5, zero tail at 0',
                                  'nothing to merge'])
def test_run_merge_mirror_on_the_card_cases(name):
    """The kernel's merge, mirrored in plain PyTorch on the card cases:
    the issued sums give the plain scatter; ray-ordered corners and
    sorted runs merge, 40 keys in turn do not."""
    idx, vals, t = _card_case(name)
    v = torch.as_tensor(vals[:, :1], dtype=torch.float32)
    k, s, atomics = _mirror_merge(idx, v, t)
    assert atomics == k.numel()
    got = scatter.scatter_add_plain(k, s, t)
    want = scatter.scatter_add_plain(torch.as_tensor(idx), v, t)
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
    'ray-ordered hash corners', 'ragged F5', 'nothing to merge',
    'ragged F4', 'ragged F16', 'sorted runs F16 with zero rows',
    'ragged F2', 'ragged F8', 'ragged F3', 'ragged F12'])
def test_run_merge_mirror_counts_the_kernels_atomics_on_card(cuda_device,
                                                             name):
    """The plain mirror issues exactly the global atomics that the kernel,
    built to count them, issues on the card: the mirror's walk (chunk
    rule, runs of rows 8 apart, row liveness, one atomic per group of
    ``vector_width`` columns) is the kernel's, at every width."""
    from shacira_tpu_torch.kernels.build import load, take_global_atomics
    idx, vals, t = _card_case(name)
    vals = vals.astype(np.float32)
    lib = load('scatter', count_atomics=True)
    take_global_atomics(lib)
    got = scatter._launch_scatter(
        torch.as_tensor(idx.astype(np.int32), device=cuda_device),
        torch.as_tensor(vals, device=cuda_device), t, lib=lib)
    counted = take_global_atomics(lib)
    assert counted == _mirror_merge(idx, vals, t)[2]
    want = scatter.scatter_add_plain(torch.as_tensor(idx),
                                     torch.as_tensor(vals), t)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
