"""Kernel E1 (``csrc/hash_encode.cu``): the flat hash-grid encode's forward
in one launch over all LODs, against its plain PyTorch version
(``hashgrid.encode_plain``).

No JAX import: the ``cuda`` tests run on the card's machine with
``python -m pytest --noconftest -m cuda tests/test_torch_encode_kernel.py``.
On the CPU: the per-LOD parameters the wrapper packs for the kernel agree
with the spec's own layout functions, and a CPU tensor takes the plain
version and launches nothing.  On the card, on every spec the port's
configs build (lego's flat and paged layouts, a ``lods`` subset, kodak's
2D grid, HashGrid, the SDF demo's grid, and a width only the run-time
column loop takes), against the plain version on the card: ``gidx``
bit-identical, ``w`` within one ulp, features and ``zbar`` within 1e-6 of
the largest value (the kernel takes the orders of PyTorch's CUDA product
and sum, so both come out bit-identical there; the CPU's product order
differs by up to 2 ulps), every gradient of
``hash_encode`` and ``hash_encode_affine`` within rtol 1e-4 (f32 sums in
another order, ``test_torch_hashgrid.py``'s tolerance), and a call that
needs no gradient writes no saved tensors."""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.ops import hashgrid  # noqa: E402
from shacira_tpu_torch.ops.hashgrid import (  # noqa: E402
    HashGridSpec, geometric_resolutions)
from shacira_tpu_torch.utils import perf  # noqa: E402

LEGO = HashGridSpec(geometric_resolutions(16, 512, 24), 19, 3)
LEGO_PAGED = HashGridSpec(geometric_resolutions(16, 512, 24), 19, 3,
                          hash_layout='paged', page_res=16)

# name -> (spec, lods, feature width F, latent width ld: 0 = the plain
# encode of a [T, F] table, else the affine encode of z [T, ld])
CASES = {
    'lego': (LEGO, None, 4, 1),
    'lego_paged': (LEGO_PAGED, None, 4, 1),
    'lods_subset': (LEGO_PAGED, (23, 2, 11, 17), 4, 1),
    'lego_decoded': (LEGO, None, 4, 0),
    'kodak_2d': (HashGridSpec(geometric_resolutions(16, 512, 24), 11, 2),
                 None, 1, 1),
    'hashgrid': (HashGridSpec(geometric_resolutions(16, 2048, 16), 19, 3),
                 None, 2, 0),
    'sdf': (HashGridSpec(geometric_resolutions(8, 64, 5), 12, 3), None, 4, 0),
    'v8_width': (HashGridSpec(geometric_resolutions(16, 512, 20), 17, 3),
                 None, 4, 2),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _coords(spec: HashGridSpec, n: int, seed: int) -> torch.Tensor:
    """``n`` uniform points in [-1, 1]^dim, then every corner of the cube,
    points outside it, and points on the cell edges of several LODs."""
    rng = np.random.RandomState(seed)
    dim = spec.dim
    parts = [rng.uniform(-1, 1, (n, dim))]
    corners = (np.arange(2 ** dim)[:, None] >> np.arange(dim)) & 1
    parts.append(corners * 2.0 - 1.0)
    parts.append(rng.choice([-3.0, -1.5, -1.0 - 1e-6, 1.0 + 1e-6, 1.5, 3.0],
                            (64, dim)))
    for res in spec.resolutions[::max(1, spec.num_lods // 6)]:
        k = rng.randint(0, res + 1, (64, dim))
        parts.append(2.0 * k / res - 1.0)
    return torch.as_tensor(np.concatenate(parts).astype(np.float32))


def _inputs(name, n=4096, seed=0):
    """(coords, table [T, F], zt [T, ld] or None, spec, lods) of a case;
    an affine case's tables are ``z @ scale + shift`` and ``z``, as the
    encode builds them."""
    spec, lods, f, ld = CASES[name]
    gen = torch.Generator().manual_seed(seed)
    coords = _coords(spec, n, seed)
    if not ld:
        return coords, torch.randn((spec.total_size, f), generator=gen), \
            None, spec, lods
    z, scale, shift = _affine_params(spec, f, ld, gen)
    return coords, z @ scale + shift, z, spec, lods


def _affine_params(spec, f, ld, gen):
    return (torch.randn((spec.total_size, ld), generator=gen),
            torch.randn((ld, f), generator=gen),
            torch.randn((1, f), generator=gen))


@pytest.mark.parametrize('name', list(CASES))
def test_lod_params_agree_with_the_spec(name):
    spec, lods, _, _ = CASES[name]
    params = hashgrid.lod_params(spec, lods)
    order = range(spec.num_lods) if lods is None else lods
    assert ctypes.sizeof(hashgrid._Lod) == 28     # the kernel's struct Lod
    assert len(params) == len(order)
    for p, lod in zip(params, order):
        res, cs = spec.resolutions[lod], spec.codebook_size
        assert (p.res, p.first, p.size) == (
            res, spec.lod_first_idx[lod], spec.lod_sizes[lod])
        assert p.hi == np.float32(res - 1 - 1e-5)
        assert p.cell_max == max(res - 2, 0)
        paged = hashgrid.paged_params(res, cs, spec.dim, spec.page_res)
        if hashgrid.use_direct_index(res, cs, spec.dim):
            assert (p.mode, p.entries) == (hashgrid.LOD_DIRECT, 0)
        elif spec.hash_layout == 'paged' and paged is not None:
            assert (p.mode, p.entries) == (hashgrid.LOD_PAGED, paged[1])
        else:
            # the kernel masks a hashed LOD with size - 1
            assert (p.mode, p.entries) == (hashgrid.LOD_XOR, 0)
            assert p.size == cs
    modes = {p.mode for p in params}
    if spec.hash_layout == 'paged':
        assert hashgrid.LOD_PAGED in modes
    elif spec.resolutions[-1] ** spec.dim > spec.codebook_size:
        assert hashgrid.LOD_XOR in modes


def test_lod_params_refuse_more_lods_than_the_kernel_holds():
    spec = HashGridSpec(tuple(range(4, 4 + hashgrid.MAX_LODS + 1)), 10, 2)
    with pytest.raises(ValueError, match='LODs'):
        hashgrid.lod_params(spec)


@pytest.mark.parametrize('affine', [False, True])
def test_cpu_tensor_takes_the_plain_version_and_launches_nothing(affine):
    spec = CASES['sdf'][0]
    gen = torch.Generator().manual_seed(1)
    coords = _coords(spec, 256, 1)
    before = perf.counted('launches/hash_encode')
    if affine:
        z, scale, shift = _affine_params(spec, 4, 1, gen)
        got = hashgrid.hash_encode_affine(coords, z, scale, shift, spec)
        want = hashgrid.encode_plain(coords, z @ scale + shift, spec, None,
                                     z)[0]
    else:
        table = torch.randn((spec.total_size, 4), generator=gen)
        got = hashgrid.hash_encode(coords, table, spec)
        want = hashgrid.encode_plain(coords, table, spec)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert perf.counted('launches/hash_encode') == before


def test_unsupported_device_raises():
    spec = CASES['sdf'][0]
    with pytest.raises(RuntimeError, match='unsupported device'):
        hashgrid.encode_forward(torch.zeros((4, 3), device='meta'),
                                torch.zeros((spec.total_size, 4),
                                            device='meta'), spec)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double().numpy(), want.double().numpy()
    ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float32))
    return float(np.max(np.abs(g - w) / ulp)) if g.size else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(CASES))
def test_kernel_matches_the_plain_version(cuda_device, name):
    args = [None if t is None else t.to(cuda_device)
            for t in _inputs(name)[:3]]
    spec, lods = CASES[name][:2]
    want = hashgrid.encode_plain(args[0], args[1], spec, lods, args[2])
    got = hashgrid.encode_forward(args[0], args[1], spec, lods, args[2])
    torch.cuda.synchronize()
    feats, zbar, gidx, w = (None if t is None else t.cpu() for t in got)
    want = [None if t is None else t.cpu() for t in want]
    assert torch.equal(gidx, want[2])
    assert _ulps(w, want[3]) <= 1.0
    for g, t in ((feats, want[0]), (zbar, want[1])):
        assert (g is None) == (t is None)
        if t is not None:
            assert g.shape == t.shape
            assert float((g - t).abs().max()) <= 1e-6 * float(t.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(CASES))
def test_kernel_grads_match_the_plain_version(cuda_device, name):
    spec, lods, f, ld = CASES[name]
    coords = _coords(spec, 4096, 2)
    gen = torch.Generator().manual_seed(2)
    if ld:
        leaves = _affine_params(spec, f, ld, gen)
    else:
        leaves = (torch.randn((spec.total_size, f), generator=gen),)
    n_lods = spec.num_lods if lods is None else len(lods)
    cot = torch.randn((coords.shape[0], n_lods, f), generator=gen)

    def grads(device):
        xs = [t.to(device).requires_grad_(True) for t in leaves]
        c = coords.to(device)
        if ld:
            out = hashgrid.hash_encode_affine(c, *xs, spec, lods)
        else:
            out = hashgrid.hash_encode(c, xs[0], spec)
        torch.sum(torch.sin(out) * cot.to(device)).backward()
        return [x.grad.cpu() for x in xs]

    for g, w in zip(grads(cuda_device), grads('cpu')):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
def test_no_grad_call_writes_no_saved_tensors(cuda_device):
    coords, table, _, spec, _ = _inputs('lego_decoded', n=65536)
    coords = coords.to(cuda_device)
    table = table.to(cuda_device).requires_grad_(True)
    out = hashgrid.hash_encode(coords, table, spec)
    saved = [t for t in out.grad_fn.saved_tensors if t is not None]
    shape = (spec.num_lods, coords.shape[0], 8)
    assert [t.shape for t in saved] == [shape, shape]
    del out, saved
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = hashgrid.hash_encode(coords, table, spec)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    assert out.grad_fn is None
    assert peak <= out.numel() * 4 + 512      # the features alone
    feats, zbar, gidx, w = hashgrid.encode_forward(
        coords, table.detach(), spec, None, table[:, :1].detach(),
        save=False)
    assert (zbar, gidx, w) == (None, None, None)
    assert feats.shape == (coords.shape[0], spec.num_lods, 4)


@pytest.mark.cuda
def test_one_launch_a_forward(cuda_device):
    coords, table, zt, spec, lods = _inputs('lods_subset', n=1024)
    coords, zt = coords.to(cuda_device), zt.to(cuda_device)
    before = perf.counted('launches/hash_encode')
    hashgrid.hash_encode(coords, table.to(cuda_device), spec)
    hashgrid.hash_encode_affine(coords, zt, torch.ones(
        (1, 4), device=cuda_device), torch.zeros((1, 4), device=cuda_device),
        spec, lods)
    assert perf.counted('launches/hash_encode') == before + 2
