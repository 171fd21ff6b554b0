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
