"""The feature-table gather of the alternative backbones
(``ops.scatter.gather_rows``) and kernel B1 at their backward's shapes.

No JAX import: the ``cuda`` tests run on the card's machine with
``python -m pytest --noconftest -m cuda tests/test_torch_backbone_kernel.py``.
On the CPU the gather's gradient is held to plain autograd indexing
(exact: both add the same f32 values into zeroed rows); on the card B1 is
held to its plain version within 1e-5 of the largest sum, at the shapes of
NGLOD's corner features (F = 5, the rows of four LODs in one row space),
VQAD's corner logits (F = 16) and the triplanar texels (F = 4, 12 planes in
one table of 264,012 rows under heavy contention)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.models.grids import octree_grid as og  # noqa: E402
from shacira_tpu_torch.models.grids import triplanar_grid as tg  # noqa: E402
from shacira_tpu_torch.ops import scatter  # noqa: E402

REL_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _tables(rows, width, seed, device='cpu'):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn((r, width), generator=gen, device=device)
            .requires_grad_(True) for r in rows]


@pytest.mark.parametrize('width,shapes', [
    (5, [(40, 8), (17, 8), (300, 8)]),     # NGLOD: [N, 8] corners per LOD
    (16, [(64, 8)]),                       # VQAD: one LOD's logits
    (4, [(50, 4)] * 6)])                   # triplanar: [N, 4] texels
def test_gather_rows_grad_equals_plain_indexing(width, shapes):
    rows = [23, 9, 71, 5, 30, 12][:len(shapes)]
    rng = np.random.RandomState(width)
    idx = [torch.as_tensor(rng.randint(0, r, s).astype(np.int32))
           for r, s in zip(rows, shapes)]
    tables = _tables(rows, width, 0)
    ref = [t.detach().clone().requires_grad_(True) for t in tables]
    cots = [torch.randn(s + (width,)) for s in shapes]
    outs = scatter.gather_rows(tables, idx)
    for o, r, i in zip(outs, ref, idx):
        torch.testing.assert_close(o, r[i.long()], rtol=0, atol=0)
    sum(torch.sum(o * c) for o, c in zip(outs, cots)).backward()
    sum(torch.sum(r[i.long()] * c) for r, i, c
        in zip(ref, idx, cots)).backward()
    for t, r in zip(tables, ref):
        torch.testing.assert_close(t.grad, r.grad, rtol=0, atol=1e-6)


def test_gather_rows_backward_is_one_scatter(monkeypatch):
    calls = []
    plain = scatter.scatter_add

    def counting(idx, vals, table_size):
        calls.append((idx.shape[0], vals.shape[1], table_size))
        return plain(idx, vals, table_size)

    monkeypatch.setattr(scatter, 'scatter_add', counting)
    tables = _tables([10, 20, 30], 3, 1)
    idx = [torch.randint(0, r, (7, 8)) for r in (10, 20, 30)]
    outs = scatter.gather_rows(tables, idx)
    # an output that takes no part in the loss adds nothing
    (outs[0].sum() + outs[2].sum()).backward()
    assert calls == [(2 * 7 * 8, 3, 60)]
    assert tables[1].grad is None or float(tables[1].grad.abs().sum()) == 0
    assert float(tables[0].grad.sum()) == pytest.approx(7 * 8 * 3)


def test_gather_rows_refuses_mixed_widths():
    with pytest.raises(ValueError, match='one width'):
        scatter.gather_rows([torch.zeros(3, 2), torch.zeros(3, 4)],
                            [torch.zeros(1, dtype=torch.long)] * 2)


def test_backbones_launch_one_scatter_per_backward(monkeypatch):
    calls = []
    plain = scatter.scatter_add
    monkeypatch.setattr(scatter, 'scatter_add', lambda i, v, t: (
        calls.append(t), plain(i, v, t))[1])
    gen = torch.Generator()
    gen.manual_seed(0)
    coords = torch.rand((64, 3), generator=gen) * 2 - 1
    cfg = og.CodebookOctreeGridConfig(feature_dim=2, base_lod=1, num_lods=3,
                                      feature_std=0.3, codebook_bitwidth=2)
    st = og.OctreeStructure.make_dense(cfg)
    for p in (og.octree_grid_init(gen, og.OctreeGridConfig(
            feature_dim=2, base_lod=1, num_lods=3), st, 'cpu'),
              og.codebook_grid_init(gen, cfg, st, 'cpu')):
        for t in p.values():
            for leaf in t:
                leaf.requires_grad_(True)
        fn = og.codebook_interpolate if 'logits' in p else og.interpolate
        fn(p, cfg, st, coords).sum().backward()
    tcfg = tg.TriplanarGridConfig(feature_dim=2, base_lod=1, num_lods=2)
    tp = tg.triplanar_grid_init(gen, tcfg, 'cpu')
    for planes in tp['planes']:
        for v in planes.values():
            v.requires_grad_(True)
    tg.interpolate(tp, tcfg, coords).sum().backward()
    corners = sum(st.num_corners.values())
    assert calls == [corners, corners, 3 * 9 + 3 * 25]


def _backbone_scatter_inputs(dev, kind, n_points):
    """(idx int32, vals f32, table rows) of a backbone's backward on
    ``n_points`` random points: NGLOD / VQAD on the dense octree of LODs
    5-8 (19,431,844 corner rows), the triplanar grid's 12 planes of LODs
    5-8 (264,012 texel rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    coords = torch.rand((n_points, 3), generator=gen, device=dev) * 2 - 1
    if kind == 'triplanar':
        cfg = tg.TriplanarGridConfig(feature_dim=4, base_lod=5, num_lods=4)
        rows, idx = [], []
        for lod in cfg.active_lods:
            s = 2 ** lod + 1
            for _, axes in tg.PLANES:
                r, _, _ = tg._plane_texels(s, coords[:, list(axes)])
                idx.append(r.reshape(-1) + sum(rows))
                rows.append(s * s)
        width = 4
    else:
        cfg = og.OctreeGridConfig(feature_dim=5, base_lod=5, num_lods=4)
        st = og.OctreeStructure.make_dense(cfg, device=dev)
        rows, idx = [], []
        for i, (ci, _, _) in enumerate(og._corners(cfg, st, coords)):
            idx.append(ci.reshape(-1).long() + sum(rows))
            rows.append(st.num_corners[cfg.active_lods[i]])
        width = 5 if kind == 'octree' else 16
    idx = torch.cat(idx).to(torch.int32)
    vals = torch.randn((idx.shape[0], width), generator=gen, device=dev)
    return idx, vals, sum(rows)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['octree', 'codebook', 'triplanar'])
def test_scatter_kernel_matches_plain_at_backbone_shapes(cuda_device, kind):
    idx, vals, rows = _backbone_scatter_inputs(cuda_device, kind, 1 << 16)
    if kind == 'triplanar':
        assert rows == 264_012
    else:
        assert rows == 19_431_844
    got = scatter.scatter_add(idx, vals, rows)
    want = scatter.scatter_add_plain(idx, vals, rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= REL_TOL * float(want.abs().max()), err


@pytest.mark.cuda
def test_gather_rows_backward_on_card_matches_cpu(cuda_device):
    rng = np.random.RandomState(3)
    rows, shapes = [1000, 5000, 20], [(4096, 8), (4096, 8), (4096, 4)]
    idx = [rng.randint(0, r, s).astype(np.int32)
           for r, s in zip(rows, shapes)]
    cots = [rng.randn(*(s + (4,))).astype(np.float32) for s in shapes]
    grads = {}
    for dev in ('cpu', cuda_device):
        tables = _tables(rows, 4, 0, 'cpu')
        tables = [t.detach().to(dev).requires_grad_(True) for t in tables]
        outs = scatter.gather_rows(tables, [torch.as_tensor(i, device=dev)
                                            for i in idx])
        sum(torch.sum(o * torch.as_tensor(c, device=dev))
            for o, c in zip(outs, cots)).backward()
        grads[str(dev)] = [t.grad.cpu() for t in tables]
    for got, want in zip(grads[str(cuda_device)], grads['cpu']):
        assert float((got - want).abs().max()) <= \
            REL_TOL * float(want.abs().max())
