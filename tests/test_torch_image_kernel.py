"""Kernel B1 (``csrc/scatter.cu``) as the image path feeds it: the 2D hash
backward of kodak's grid (24 LODs 16..512, 2^11 rows a LOD, 4 corners a
sample) on the pixel lattice in row-major order, as the full-image step
hands it over, and in the shuffled order of ``ImageDataset('full')``; and
pearl's grid (16 LODs to 10725, 2^23 rows a LOD) on uniformly random
pixels.  On the card (``cuda`` tests) the kernel is held to its plain
version (1e-5 of the largest sum) and its counted atomics to the plain
mirror of its merge; on the CPU the mirror's sums are held to the plain
scatter.  This file imports no JAX, so the card's machine runs it."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.datasets.image import pixel_coords  # noqa: E402
from shacira_tpu_torch.ops import hashgrid, scatter  # noqa: E402

KODAK = hashgrid.HashGridSpec(hashgrid.geometric_resolutions(16, 512, 24),
                              11, 2)
PEARL = hashgrid.HashGridSpec(hashgrid.geometric_resolutions(16, 10725, 16),
                              23, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def image_corners(order: str, h=64, w=96, n_random=1 << 14, device='cpu'):
    """(idx [L * N * 4] int32, table rows) of the image hash backward:
    'row-major' and 'shuffled' pixel lattices on kodak's grid, 'random'
    pixels of a 2048^2 image on pearl's."""
    if order == 'random':
        rng = np.random.RandomState(0)
        idx = rng.randint(0, 2048 * 2048, n_random)
        coords = np.stack([(idx // 2048 / 2048 - 0.5) * 2,
                           (idx % 2048 / 2048 - 0.5) * 2], -1)
        spec = PEARL
    else:
        coords = pixel_coords(h, w)
        if order == 'shuffled':
            coords = coords[np.random.RandomState(0).permutation(h * w)]
        spec = KODAK
    gidx, _ = hashgrid._all_corners(
        torch.as_tensor(coords.astype(np.float32), device=device), spec)
    return gidx.reshape(-1), spec.total_size


def test_kodak_and_pearl_table_sizes():
    assert KODAK.total_size == 40_282
    assert PEARL.total_size == 39_727_145


def _mirror(idx, v, t):
    return scatter.merge_plain(idx, v[:, None], t)


@pytest.mark.parametrize('order', ['row-major', 'shuffled'])
def test_mirror_of_the_merge_sums_the_image_backward(order):
    """The merge's plain mirror gives the plain scatter's sums; in
    row-major order it merges, in shuffled order it barely does (rows 8
    apart are then corners of unrelated pixels)."""
    idx, t = image_corners(order)
    v = torch.randn(idx.shape[0], generator=torch.Generator().manual_seed(1))
    k, s, _ = _mirror(idx, v, t)
    got = scatter.scatter_add_plain(k, s, t)
    want = scatter.scatter_add_plain(idx, v[:, None], t)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    share = k.numel() / idx.numel()
    if order == 'row-major':
        assert share < 0.9
    else:
        assert share > 0.95


@pytest.mark.cuda
@pytest.mark.parametrize('order', ['row-major', 'shuffled', 'random'])
def test_kernel_matches_plain_on_the_image_backward(cuda_device, order):
    idx, t = image_corners(order, device=cuda_device)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(2)
    vals = torch.randn((idx.shape[0], 1), generator=g, device=cuda_device)
    got = scatter.scatter_add(idx, vals, t)
    want = scatter.scatter_add_plain(idx, vals, t)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('order', ['row-major', 'shuffled'])
def test_mirror_counts_the_kernels_atomics_on_the_image_backward(
        cuda_device, order):
    from shacira_tpu_torch.kernels.build import load, take_global_atomics
    idx, t = image_corners(order)
    v = torch.randn(idx.shape[0], generator=torch.Generator().manual_seed(1))
    lib = load('scatter', count_atomics=True)
    take_global_atomics(lib)
    scatter._launch_scatter(idx.to(cuda_device), v[:, None].to(cuda_device),
                            t, lib=lib)
    assert take_global_atomics(lib) == _mirror(idx, v, t)[2]
