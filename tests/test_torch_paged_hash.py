"""Port parity: the paged hash layout and the block-local encode of
shacira_tpu_torch.ops.paged_hash against shacira_tpu.ops.paged_hash (the
Pallas kernels B2/B3 in interpret mode), and the CUDA kernels against their
plain versions on a card.

* paged corner entries and weights: bit-identical to the JAX hashgrid;
* ``group_segments`` and ``permute_rows``: exact;
* plain B2/B3 against the f32 Pallas kernels (``use_bf16=False``): outputs
  and table gradients to 1e-5 absolute (values O(1), f32 sums in another
  order);
* against the default bf16 Pallas kernels: 3e-2 absolute on outputs and
  gradients -- the TPU kernels round table values (and, for direct LODs,
  weight products) to bf16, a relative error of up to 2^-8 on each of
  eight terms of size up to ~4 here;
* on a card (``cuda`` marker): kernels against plain versions to 1e-5 of
  the largest value (float atomics reorder B3's sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.ops import hashgrid as thg  # noqa: E402
from shacira_tpu_torch.ops import paged_hash as tph  # noqa: E402

try:        # the card's machine has no JAX: only the kernel tests run there
    import jax
    import jax.numpy as jnp
    from shacira_tpu.ops import hashgrid as jhg
    from shacira_tpu.ops import paged_hash as jph
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None,
                               reason='needs the JAX package (the reference)')

RES = (17, 48, 81, 128)
BW = 17


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.device('cuda')


def _tspec(page_res, res=RES, bw=BW):
    return thg.HashGridSpec(res, bw, 3, hash_layout='paged',
                            page_res=page_res)


def _specs(page_res, res=RES, bw=BW):
    return (jhg.HashGridSpec(res, bw, 3, hash_layout='paged',
                             page_res=page_res), _tspec(page_res, res, bw))


def _fake_segments(rng, k_seg, g, live_frac=0.8, seg_half=0.004):
    """Spatially tight segments: coords [k_seg, g, 3] in [-1, 1], centers
    [k_seg, 3] in [0, 1], live [k_seg] (as tests/test_paged_hash.py)."""
    centers = rng.uniform(0.02, 0.98, (k_seg, 3))
    d = rng.normal(size=(k_seg, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(-seg_half, seg_half, g)
    pts01 = np.clip(centers[:, None, :] + d[:, None, :] * t[None, :, None],
                    0.0, 1.0)
    live = rng.uniform(size=(k_seg,)) < live_frac
    return ((pts01 * 2.0 - 1.0).astype(np.float32),
            centers.astype(np.float32), live)


@needs_jax
@pytest.mark.parametrize('page_res', [16, 32])
def test_paged_corner_entries_bit_identical(page_res):
    jspec, tspec = _specs(page_res)
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1.05, 1.05, (3000, 3)).astype(np.float32)
    for res in RES:
        ij, wj = jhg._lod_corner_indices_and_weights(jnp.asarray(coords),
                                                     res, jspec)
        it, wt = thg._lod_corner_indices_and_weights(torch.as_tensor(coords),
                                                     res, tspec)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert tph.blocklocal_lods(tspec) == jph.blocklocal_lods(jspec)
    for e in (4, 8, 32, 128):
        for acc in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
            assert thg.fold_hash(acc, e) == int(jhg.fold_hash(
                np.uint32(acc), e))


@needs_jax
@pytest.mark.parametrize('page_res', [16, 32])
def test_geometry_helpers_match(page_res):
    g = tph.group_res_of(page_res)
    np.testing.assert_array_equal(tph._neighbor_pages_np(3, page_res),
                                  jph._neighbor_pages_np(3, page_res))
    for res in RES:
        s_t, w_t = tph._slab_starts_np(res, g)
        s_j, w_j = jph._slab_starts_np(res, jph.DIRECT_MARGIN, g)
        assert w_t == w_j
        np.testing.assert_array_equal(s_t, s_j)
    _, tspec = _specs(page_res, res=(32, 128))
    tph.validate_paged_cover(tspec, seg_half01=0.01)
    with pytest.raises(ValueError):
        tph.validate_paged_cover(tspec, seg_half01=0.1)


def _slots(seed, page_res, k_seg=200, g=4, spb=4):
    """Fake segments grouped by the port: (rng, grouping inputs, grouping,
    slot coords [NS, 3], slot validity [NS]).  The block capacity is
    ``ceil(K / spb)`` plus the cells actually used, a bound that never
    overflows and keeps the interpret-mode grid short."""
    rng = np.random.default_rng(seed)
    coords, centers, live = _fake_segments(rng, k_seg, g)
    gr = tph.group_res_of(page_res)
    c = np.clip(np.floor(centers * gr), 0, gr - 1).astype(int)
    used = len(np.unique(((c[:, 0] * gr + c[:, 1]) * gr + c[:, 2])[live]))
    args = (centers, live, spb, -(-k_seg // spb) + used, gr)
    tg = tph.group_segments(torch.as_tensor(centers), torch.as_tensor(live),
                            *args[2:])
    s2s = tg['slotseg_to_seg'].numpy()
    sv = s2s < k_seg
    coords_s = np.where(sv[:, None], coords.reshape(k_seg, g * 3)[
        np.minimum(s2s, k_seg - 1)], 0.0).reshape(-1, 3).astype(np.float32)
    return rng, args, tg, coords_s, np.repeat(sv, g)


def _grouped(seed, page_res, **kw):
    """:func:`_slots` plus the JAX package's grouping of the same segments."""
    rng, args, tg, coords_s, slot_valid = _slots(seed, page_res, **kw)
    centers, live = args[:2]
    jg = jph.group_segments(jnp.asarray(centers), jnp.asarray(live),
                            *args[2:])
    return rng, jg, tg, coords_s, slot_valid


@needs_jax
@pytest.mark.parametrize('page_res', [16, 32])
def test_group_segments_matches_jax(page_res):
    _, jg, tg, _, _ = _grouped(2, page_res, k_seg=300)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]),
                                      err_msg=k)
    assert int(np.sum(np.asarray(jg['cell_used']))) > 50


@needs_jax
def test_permute_rows_forward_and_grad_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    perm = np.asarray([3, 1, 10, 0, 2, 10])            # 10 = sentinel
    inv = np.asarray([3, 1, 4, 0, 6, 6, 6, 6, 6, 6])
    w = np.arange(24.0, dtype=np.float32).reshape(6, 4)
    jy, jvjp = jax.vjp(lambda a: jph.permute_rows(
        a, jnp.asarray(perm), jnp.asarray(inv), 6), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    ty = tph.permute_rows(xt, torch.as_tensor(perm), torch.as_tensor(inv))
    (tgrad,) = torch.autograd.grad(ty, xt, torch.as_tensor(w))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tgrad.numpy(),
                                  np.asarray(jvjp(jnp.asarray(w))[0]))


def _both(ld, page_res, use_bf16, seed=4):
    """Forward and table gradient of JAX's paged_interp_lods (interpret
    mode) and of the port's plain path on the same grouped slots."""
    jspec, tspec = _specs(page_res)
    rng, jg, tg, coords_s, slot_valid = _grouped(seed, page_res)
    _, direct, pag = jph.blocklocal_lods(jspec)
    assert len(direct) >= 2 and len(pag) == 2
    z = rng.normal(size=(jspec.total_size, ld)).astype(np.float32)
    static = jph.PagedStatic(spec=jspec, lods=pag, direct_lods=direct,
                             interpret=True, use_bf16=use_bf16)
    args = (jnp.asarray(coords_s), jnp.asarray(slot_valid),
            jg['block_cell'], jg['cell_used'])
    r = rng.normal(size=(coords_s.shape[0], len(static.all_lods), ld)
                   ).astype(np.float32)

    @jax.jit        # interpret mode runs far faster compiled than eagerly
    def fwd_bwd(zz, rr):
        out, vjp = jax.vjp(
            lambda a: jph.paged_interp_lods(*args, a, None, static), zz)
        return out, vjp(rr)[0]

    out_j, grad_j = (np.asarray(a) for a in fwd_bwd(jnp.asarray(z),
                                                     jnp.asarray(r)))

    tstatic = tph.default_static(tspec)
    assert tstatic.all_lods == static.all_lods
    zt = torch.as_tensor(z).requires_grad_(True)
    out_t = tph.paged_interp_lods(torch.as_tensor(coords_s),
                                  torch.as_tensor(slot_valid),
                                  tg['block_cell'], zt, tstatic)
    (grad_t,) = torch.autograd.grad(out_t, zt, torch.as_tensor(r))
    return out_j, out_t.detach().numpy(), grad_j, grad_t.numpy()


@needs_jax
@pytest.mark.parametrize('ld,page_res', [(1, 16), (2, 16), (1, 32), (2, 32)])
def test_plain_paged_encode_matches_pallas_f32(ld, page_res):
    out_j, out_t, grad_j, grad_t = _both(ld, page_res, use_bf16=False)
    assert out_t.shape == out_j.shape and np.abs(out_j).max() > 0.5
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-5)
    assert np.abs(grad_j).max() > 0.5
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=1e-5)


@needs_jax
def test_plain_paged_encode_matches_pallas_bf16():
    out_j, out_t, grad_j, grad_t = _both(1, 16, use_bf16=True, seed=5)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=3e-2)
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=3e-2)
    assert np.abs(out_t - out_j).max() > 0       # bf16 really rounds


def test_plain_encode_equals_flat_encode_of_the_paged_spec():
    """Under the cover condition the clips never bind: the block-local
    encode equals the plain gather encode of the paged spec."""
    tspec = _tspec(16)
    _, _, tg, coords_s, slot_valid = _slots(6, 16)
    z = torch.as_tensor(np.random.default_rng(6).normal(
        size=(tspec.total_size, 1)).astype(np.float32))
    static = tph.default_static(tspec)
    got = tph.paged_gather(torch.as_tensor(coords_s),
                           torch.as_tensor(slot_valid), tg['block_cell'], z,
                           static)
    want = thg.hash_encode(torch.as_tensor(coords_s), z, tspec)[
        :, list(static.all_lods)] * torch.as_tensor(slot_valid)[:, None, None]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _card_inputs(dev, page_res, ld):
    tspec = _tspec(page_res)
    rng, _, tg, coords_s, slot_valid = _slots(7, page_res)
    static = tph.default_static(tspec)
    z = torch.as_tensor(rng.normal(size=(tspec.total_size, ld)).astype(
        np.float32), device=dev)
    g = torch.as_tensor(rng.normal(size=(coords_s.shape[0], 4, ld)).astype(
        np.float32), device=dev)
    return (torch.as_tensor(coords_s, device=dev),
            torch.as_tensor(slot_valid, device=dev),
            tg['block_cell'].to(dev), z, g, static)


@pytest.mark.cuda
@pytest.mark.parametrize('ld,page_res', [(1, 16), (2, 32)])
def test_gather_kernel_matches_plain_on_card(cuda_device, ld, page_res):
    coords, valid, bc, z, _, static = _card_inputs(cuda_device, page_res, ld)
    before = tph.paged_gather.launches
    got = tph.paged_gather(coords, valid, bc, z, static)
    want = tph.paged_gather_plain(coords, valid, bc, z, static)
    torch.cuda.synchronize()
    assert tph.paged_gather.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('ld,page_res', [(1, 16), (2, 32)])
def test_scatter_kernel_matches_plain_on_card(cuda_device, ld, page_res):
    coords, valid, bc, _, g, static = _card_inputs(cuda_device, page_res, ld)
    before = tph.paged_scatter.launches
    got = tph.paged_scatter(coords, valid, bc, g, static)
    want = tph.paged_scatter_plain(coords, valid, bc, g, static)
    torch.cuda.synchronize()
    assert tph.paged_scatter.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def _lego_tspec():
    """The lego config's paged spec: 24 LODs 17..512, 2^19 rows a LOD,
    page_res 16 (11 direct LODs, 13 paged with E = 128)."""
    return thg.HashGridSpec(thg.geometric_resolutions(16, 512, 24), 19, 3,
                            hash_layout='paged', page_res=16)


def _chain_merged_gradient(coords, valid, bc, g, static):
    """The table gradient as B3's threads build it, in plain PyTorch: each
    chain's updates merged by the mirror of its merge, the issued sums
    scattered; and (updates, issued atomics)."""
    from shacira_tpu_torch.ops.scatter import scatter_add_plain
    t, ld = static.spec.total_size, g.shape[-1]
    grad = torch.zeros((t, ld))
    updates = flushes = 0
    for li, lod in enumerate(static.all_lods):
        for d in range(ld):
            keys, vals = tph.chain_updates(coords, valid, bc, g, static, li,
                                           d)
            k, v = tph.group_merge(keys, vals)
            updates += int(((keys >= 0) & (vals != 0)).sum())
            flushes += k.numel()
            grad[:, d] += scatter_add_plain(
                k + static.spec.lod_first_idx[lod], v[:, None], t)[:, 0]
    return grad, updates, flushes


@pytest.mark.parametrize('which', ['small16', 'small32', 'lego'])
def test_chain_mirror_merges_to_the_plain_gradient(which):
    """B3's walk, mirrored in plain PyTorch: chains of consecutive slots at
    one LOD, each slot's corners merged into the next's, give the plain
    version's table
    gradient, with fewer global atomics than updates; on the lego geometry
    blocks hold 8 segments of 16 samples, as the lego step groups them."""
    *args, g, static = _mirror_case(which, 1)
    assert static.direct_lods and static.lods
    got, updates, flushes = _chain_merged_gradient(*args, g, static)
    want = tph.paged_scatter_plain(*args, g, static)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert flushes < updates / 2


def test_chain_mirror_at_the_cube_edge():
    """The same at two latent columns on blocks of 128 slots in one cell:
    the corner cells of the cube (slots on its faces, where the page clamp
    binds), a middle cell, and a pad block."""
    coords, valid, bc, g, static = _mirror_case('edge', 2)
    got, updates, flushes = _chain_merged_gradient(coords, valid, bc, g,
                                                   static)
    want = tph.paged_scatter_plain(coords, valid, bc, g, static)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert flushes < updates     # uniform points in a cell repeat less


def _block_cases(dev, static, ld, seed=9):
    """Blocks of 128 slots, each inside one grouping cell: the corner cells
    of the cube (with slots on its faces), a middle cell and a pad block;
    ~10 % of the slots invalid."""
    rng = np.random.default_rng(seed)
    g = static.group_res
    cells = [0, g ** 3 - 1, (g // 2) * (g * g + g + 1), g ** 3]
    pts = []
    for c in cells:
        c3 = np.array([c // (g * g), (c // g) % g, c % g]) % g
        pts.append(rng.uniform(c3 / g, (c3 + 1) / g, (128, 3)))
    pts01 = np.concatenate(pts)
    pts01[:20] = 0.0
    pts01[128:148] = 1.0
    n = pts01.shape[0]
    coords = torch.as_tensor(pts01 * 2 - 1, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev)
    gout = torch.as_tensor(rng.normal(size=(n, len(static.all_lods), ld)
                                      ).astype(np.float32), device=dev)
    return coords, valid, torch.tensor(cells, dtype=torch.int32,
                                       device=dev), gout


@pytest.mark.cuda
@pytest.mark.parametrize('which,ld', [('small16', 1), ('small16', 2),
                                      ('small32', 2), ('lego', 1),
                                      ('lego', 2)])
def test_scatter_kernel_one_cell_blocks_on_card(cuda_device, which, ld):
    """B3 on blocks whose 128 slots sit in one cell, at the cube's edge
    (the page clamp) and in the middle, with a pad block; on the lego
    geometry the block takes several passes over its LODs."""
    tspec = _lego_tspec() if which == 'lego' else _tspec(int(which[5:]))
    static = tph.default_static(tspec)
    coords, valid, bc, g = _block_cases(cuda_device, static, ld)
    got = tph.paged_scatter(coords, valid, bc, g, static)
    want = tph.paged_scatter_plain(coords, valid, bc, g, static)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 1.0
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def _mirror_case(which, ld):
    """CPU inputs (coords, valid, block_cell, g, static) of B3: grouped
    segments on the small spec (page_res 16 or 32) or the lego geometry,
    or one-cell blocks at the cube's edge (``edge``)."""
    if which == 'edge':
        static = tph.default_static(_tspec(16))
        return (*_block_cases('cpu', static, ld), static)
    if which == 'lego':
        tspec, kw = _lego_tspec(), dict(k_seg=96, g=16, spb=8)
    else:
        tspec, kw = _tspec(int(which[5:])), {}
    static = tph.default_static(tspec)
    rng, _, tg, coords_s, slot_valid = _slots(8, tspec.page_res, **kw)
    g = torch.as_tensor(rng.normal(size=(coords_s.shape[0],
                                         len(static.all_lods), ld)
                                   ).astype(np.float32))
    return (torch.as_tensor(coords_s), torch.as_tensor(slot_valid),
            tg['block_cell'], g, static)


@pytest.mark.cuda
@pytest.mark.parametrize('which,ld', [('small16', 1), ('small32', 2),
                                      ('lego', 1), ('edge', 2)])
def test_chain_mirror_counts_the_kernels_atomics_on_card(cuda_device, which,
                                                         ld):
    """B3's plain mirror (:func:`chain_updates`, :func:`group_merge`)
    issues exactly the global atomics that the kernel, built to count
    them, issues on the card: the mirror's walk (``CHAIN`` slots of
    ``GROUP`` corners) is the kernel's."""
    from shacira_tpu_torch.kernels.build import load, take_global_atomics
    coords, valid, bc, g, static = _mirror_case(which, ld)
    lib = load('paged_hash', count_atomics=True)
    take_global_atomics(lib)
    got = tph._launch_scatter(*(t.to(cuda_device) for t in (coords, valid,
                                                             bc, g)),
                              static, lib=lib)
    counted = take_global_atomics(lib)
    want, _, mirrored = _chain_merged_gradient(coords, valid, bc, g, static)
    assert counted == mirrored
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
