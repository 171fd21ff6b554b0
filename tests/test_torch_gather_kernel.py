"""Kernel R1, the forward of ``ops.scatter.gather_rows``: one launch over
every table, a copy of rows equal to ``t[i.long()]`` bit for bit.

No JAX import: the ``cuda`` tests run on the card's machine with
``python -m pytest --noconftest -m cuda tests/test_torch_gather_kernel.py``.
On the CPU the wrapper's checks and its dispatch (a CPU tensor takes the
plain twin and counts no launch) are tested; on the card R1 is held to
``t[i.long()]`` at the shapes of VQAD's corner logits (F = 16, int32
[N, 8] rows), NGLOD's corner features (F = 5) and the triplanar texels
(F = 4, int64 [N, 4] rows), on an output past 2^31 bytes, on rows of
other dtypes and alignments, and on empty and non-contiguous indices."""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.models.grids import octree_grid as og  # noqa: E402
from shacira_tpu_torch.models.grids import triplanar_grid as tg  # noqa: E402
from shacira_tpu_torch.ops import scatter  # noqa: E402
from shacira_tpu_torch.utils import perf  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.fixture
def counts():
    perf.reset_counts()
    yield lambda: perf.counted('launches/gather_rows')
    perf.reset_counts()


def _random_case(device, rows, shapes, width, idx_dtype, seed=0):
    """Tables [r, width] f32 and indices of ``shapes`` in them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tables = [torch.randn((r, width), generator=gen, device=device)
              for r in rows]
    idxs = [torch.randint(0, r, s, generator=gen, device=device,
                          dtype=idx_dtype) for r, s in zip(rows, shapes)]
    return tables, idxs


def _assert_identical(outs, tables, idxs):
    assert len(outs) == len(tables)
    for o, t, i in zip(outs, tables, idxs):
        want = t[i.long()]
        assert o.shape == want.shape and o.dtype == want.dtype
        assert torch.equal(o, want)


# -------------------------------------------------------------- CPU ----

@pytest.mark.parametrize('idx_dtype', [torch.int32, torch.int64])
def test_cpu_takes_plain_twin_and_counts_no_launch(monkeypatch, counts,
                                                   idx_dtype):
    def refuse(*a, **k):
        raise AssertionError('kernel R1 launched for CPU tensors')

    monkeypatch.setattr(scatter, '_launch_gather', refuse)
    tables, idxs = _random_case('cpu', [23, 9, 71], [(40, 8), (17, 8),
                                                     (3, 8)], 16, idx_dtype)
    _assert_identical(scatter.gather_rows(tables, idxs), tables, idxs)
    assert counts() == 0


def test_plain_twin_wraps_negative_and_keeps_index_shape():
    tables, _ = _random_case('cpu', [7, 5], [(1,), (1,)], 3, torch.int32)
    idxs = [torch.tensor([[-1, 0], [6, -7]], dtype=torch.int32),
            torch.zeros((0, 4), dtype=torch.int64)]
    outs = scatter.gather_rows_plain(tables, idxs)
    assert outs[0].shape == (2, 2, 3) and outs[1].shape == (0, 4, 3)
    assert torch.equal(outs[0][0, 0], tables[0][6])
    assert torch.equal(outs[0][1, 1], tables[0][0])


@pytest.mark.parametrize('tables,idxs,match', [
    ([], [], '0 tables'),
    ([torch.zeros(3, 2)], [], '1 tables and 0 index'),
    ([torch.zeros(3, 2), torch.zeros(3, 4)],
     [torch.zeros(1, dtype=torch.long)] * 2, 'one width'),
    ([torch.zeros(3, 2), torch.zeros(3, 2, dtype=torch.float64)],
     [torch.zeros(1, dtype=torch.long)] * 2, 'dtype'),
    ([torch.zeros(3, 2, 2)], [torch.zeros(1, dtype=torch.long)], r'\[T, F\]'),
    ([torch.zeros(3, 2)], [torch.zeros(1, dtype=torch.long, device='meta')],
     'one device')])
def test_gather_rows_checks_its_arguments(tables, idxs, match):
    with pytest.raises(ValueError, match=match):
        scatter.gather_rows(tables, idxs)


def test_gather_rows_refuses_other_devices():
    t = torch.zeros((3, 2), device='meta')
    with pytest.raises(RuntimeError, match='unsupported device'):
        scatter.gather_rows([t], [torch.zeros(4, dtype=torch.long,
                                              device='meta')])


def test_gather_table_struct_matches_the_kernel():
    # struct GatherTable of csrc/scatter.cu: three pointers, three int64
    assert ctypes.sizeof(scatter._GatherTable) == 48
    assert scatter.MAX_GATHER_TABLES * 48 + 8 <= 4096    # a launch's params


# ------------------------------------------------------------- card ----

def _backbone_case(dev, kind, n_points):
    """(tables, idxs) of a backbone's forward gather on ``n_points`` random
    points: VQAD / NGLOD's int32 [N, 8] corner rows on the dense octree of
    LODs 5-8 (F = 16 / 5), the triplanar grid's int64 [N, 4] texel rows of
    12 planes (F = 4)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    coords = torch.rand((n_points, 3), generator=gen, device=dev) * 2 - 1
    if kind == 'triplanar':
        tables, idxs = [], []
        for lod in range(5, 9):
            s = 2 ** lod + 1
            for _, axes in tg.PLANES:
                idxs.append(tg._plane_texels(s, coords[:, list(axes)])[0])
                tables.append(torch.randn((s * s, 4), generator=gen,
                                          device=dev))
        return tables, idxs
    cfg = og.OctreeGridConfig(feature_dim=5, base_lod=5, num_lods=4)
    st = og.OctreeStructure.make_dense(cfg, device=dev)
    idxs = [ci for ci, _, _ in og._corners(cfg, st, coords)]
    width = 16 if kind == 'codebook' else 5
    tables = [torch.randn((st.num_corners[lod], width), generator=gen,
                          device=dev) for lod in cfg.active_lods]
    return tables, idxs


@pytest.mark.cuda
@pytest.mark.parametrize('kind,width,idx_dtype,count', [
    ('codebook', 16, torch.int32, 4), ('octree', 5, torch.int32, 4),
    ('triplanar', 4, torch.int64, 12)])
def test_r1_bit_identical_at_backbone_shapes(cuda_device, counts, kind,
                                             width, idx_dtype, count):
    tables, idxs = _backbone_case(cuda_device, kind, 1 << 16)
    assert len(tables) == count and tables[0].shape[1] == width
    assert all(i.dtype == idx_dtype for i in idxs)
    outs = scatter.gather_rows(tables, idxs)
    torch.cuda.synchronize()
    _assert_identical(outs, tables, idxs)
    assert counts() == 1


@pytest.mark.cuda
def test_r1_output_past_int32_byte_offsets(cuda_device):
    # one LOD's logits at VQAD's step: [4.2 M, 8] rows of 16 f32 from the
    # finest LOD's 16,974,593 corners, 2.15e9 bytes of output
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    rows, n = 16_974_593, 4_200_000
    table = torch.randn((rows, 16), generator=gen, device=cuda_device)
    idx = torch.randint(0, rows, (n, 8), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    (out,) = scatter.gather_rows([table], [idx])
    assert out.numel() * out.element_size() > 2 ** 31
    torch.cuda.synchronize()
    assert torch.equal(out[-1], table[idx[-1].long()])
    assert torch.equal(out, table[idx.long()])


@pytest.mark.cuda
def test_r1_one_table_empty_and_noncontiguous_indices(cuda_device, counts):
    tables, idxs = _random_case(cuda_device, [1000, 300, 50],
                                [(4096, 8), (2, 8), (64, 8)], 16,
                                torch.int32)
    idxs[1] = idxs[1][:0]                             # empty
    idxs[2] = idxs[2].t()                             # [8, 64], strided
    idxs[0] = idxs[0][::3, 1:7]                       # strided rows, cols
    idxs[0][0, 0] = -1                                # counts from the end
    assert not idxs[0].is_contiguous() and not idxs[2].is_contiguous()
    _assert_identical(scatter.gather_rows(tables, idxs), tables, idxs)
    assert counts() == 1
    (one,) = scatter.gather_rows(tables[:1], idxs[:1])
    _assert_identical([one], tables[:1], idxs[:1])
    assert counts() == 2
    (empty,) = scatter.gather_rows(tables[1:2], idxs[1:2])
    assert empty.shape == (0, 8, 16)
    assert counts() == 2                              # no rows, no launch


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,width,offset', [
    (torch.float32, 16, 1), (torch.float32, 3, 0), (torch.float32, 2, 0),
    (torch.bfloat16, 5, 0), (torch.float64, 4, 0), (torch.uint8, 3, 0)])
def test_r1_other_dtypes_widths_and_alignments(cuda_device, dtype, width,
                                               offset):
    # each picks another vector: a table one element off its 16-byte
    # alignment, 12- and 8-byte rows, 10-byte, 32-byte and 3-byte rows
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    rows = 777
    flat = torch.randint(0, 250, (rows * width + offset,), generator=gen,
                         device=cuda_device).to(dtype)
    table = flat[offset:].view(rows, width)
    idx = torch.randint(-rows, rows, (3001, 8), generator=gen,
                        device=cuda_device)
    (out,) = scatter.gather_rows([table], [idx])
    _assert_identical([out], [table], [idx])


@pytest.mark.cuda
def test_r1_more_tables_than_one_launch_takes(cuda_device, counts):
    n = scatter.MAX_GATHER_TABLES + 3
    tables, idxs = _random_case(cuda_device, [5 + k for k in range(n)],
                                [(33, 4)] * n, 4, torch.int64)
    _assert_identical(scatter.gather_rows(tables, idxs), tables, idxs)
    assert counts() == 2


@pytest.mark.cuda
@pytest.mark.parametrize('width,idx_dtype,shapes', [
    (16, np.int32, [(4096, 8), (4096, 8), (1000, 8), (77, 8)]),
    (5, np.int32, [(4096, 8), (300, 8)]),
    (4, np.int64, [(4096, 4)] * 6)])
def test_gather_rows_grads_on_card_equal_cpu(cuda_device, width, idx_dtype,
                                             shapes):
    rng = np.random.RandomState(width)
    rows = [1000, 5000, 20, 300, 7, 64][:len(shapes)]
    idx = [rng.randint(0, r, s).astype(idx_dtype)
           for r, s in zip(rows, shapes)]
    cots = [rng.randn(*(s + (width,))).astype(np.float32) for s in shapes]
    base = [rng.randn(r, width).astype(np.float32) for r in rows]
    outs, grads = {}, {}
    for dev in ('cpu', cuda_device):
        tables = [torch.tensor(b, device=dev, requires_grad=True)
                  for b in base]
        got = scatter.gather_rows(tables, [torch.as_tensor(i, device=dev)
                                           for i in idx])
        sum(torch.sum(o * torch.as_tensor(c, device=dev))
            for o, c in zip(got, cots)).backward()
        outs[str(dev)] = [o.detach().cpu() for o in got]
        grads[str(dev)] = [t.grad.cpu() for t in tables]
    for got, want in zip(outs[str(cuda_device)], outs['cpu']):
        assert torch.equal(got, want)
    for got, want in zip(grads[str(cuda_device)], grads['cpu']):
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
