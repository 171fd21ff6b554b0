"""Port parity: shacira_tpu_torch.ops.hashgrid against shacira_tpu.ops.hashgrid.

Layout and corner indices must be bit-identical (including coordinates
outside [-1, 1]); interpolated features agree to rtol 1e-5 and gradients
(codebook, z, scale, shift) to rtol 1e-4 (f32 sums in another order)."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.ops import hashgrid as jhg  # noqa: E402
from shacira_tpu_torch.ops import hashgrid as thg  # noqa: E402

LEGO = (jhg.geometric_resolutions(16, 512, 24), 19, 3)


def _specs(res, bw, dim):
    return jhg.HashGridSpec(tuple(res), bw, dim), thg.HashGridSpec(
        tuple(res), bw, dim)


@pytest.mark.parametrize('args', [LEGO, ((4, 9, 33), 6, 2), ((5, 12), 8, 3)])
def test_spec_layout_matches(args):
    res, bw, dim = args
    assert thg.geometric_resolutions(16, 512, 24) == jhg.geometric_resolutions(
        16, 512, 24)
    j, t = _specs(res, bw, dim)
    assert t.lod_sizes == j.lod_sizes
    assert t.lod_first_idx == j.lod_first_idx
    assert t.total_size == j.total_size
    np.testing.assert_array_equal(t.corner_offsets, j.corner_offsets)


def test_lego_layout():
    _, t = _specs(*LEGO)
    assert t.total_size == 7_879_908
    direct = [thg.use_direct_index(r, t.codebook_size, 3)
              for r in t.resolutions]
    assert sum(direct) == 11


def test_use_direct_index_matches_including_int32_wrap():
    cases = [(r, 2 ** bw, dim) for r in (1, 2, 16, 64, 80, 81, 512, 46341,
                                         65536, 65537, 2 ** 20 + 7)
             for bw in (8, 12, 19, 24, 31) for dim in (2, 3)]
    for r, cs, dim in cases:
        assert thg.use_direct_index(r, cs, dim) == jhg.use_direct_index(
            r, cs, dim), (r, cs, dim)
    # 65536^2 wraps to 0 in int32, so the reference indexes directly
    assert thg.use_direct_index(65536, 2 ** 19, 2)
    assert thg._int32_wrap(2 ** 31) == -2 ** 31


@pytest.mark.parametrize('dim', [2, 3])
def test_corner_indices_bit_identical(dim):
    rng = np.random.RandomState(dim)
    coords = rng.uniform(-1.3, 1.3, size=(2000, dim)).astype(np.float32)
    coords[:4] = [[-1.0] * dim, [1.0] * dim, [0.9999999] * dim, [-2.0] * dim]
    res_list = (3, 16, 60, 181, 512, 2049)
    j, t = _specs(res_list, 12, dim)
    for res in res_list:
        ji, jw = jhg._lod_corner_indices_and_weights(jnp.asarray(coords),
                                                     res, j)
        ti, tw = thg._lod_corner_indices_and_weights(torch.as_tensor(coords),
                                                     res, t)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)


def _encode_inputs(seed, spec, n=300, ld=1, f=4):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-1.1, 1.1, size=(n, spec.dim)).astype(np.float32)
    z = rng.randn(spec.total_size, ld).astype(np.float32)
    scale = rng.randn(ld, f).astype(np.float32)
    shift = rng.randn(1, f).astype(np.float32)
    ct = rng.randn(n, spec.num_lods, f).astype(np.float32)
    return coords, z, scale, shift, ct


def test_hash_encode_forward_and_grad_match_jax():
    j, t = _specs((4, 11, 40), 9, 3)
    coords, cb, _, _, ct = _encode_inputs(0, j, ld=4)
    want = np.asarray(jhg.hash_encode(jnp.asarray(coords), jnp.asarray(cb), j))
    want_g = np.asarray(jax.grad(lambda c: jnp.sum(
        jhg.hash_encode(jnp.asarray(coords), c, j) * ct))(jnp.asarray(cb)))
    cb_t = torch.tensor(cb, requires_grad=True)
    got = thg.hash_encode(torch.as_tensor(coords), cb_t, t)
    (got_g,) = torch.autograd.grad(torch.sum(got * torch.as_tensor(ct)), cb_t)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('ld', [1, 2])
def test_hash_encode_affine_forward_and_grads_match_jax(ld):
    j, t = _specs((5, 13, 50), 10, 3)
    coords, z, scale, shift, ct = _encode_inputs(1, j, ld=ld)

    def jloss(z_, s_, b_):
        out = jhg.hash_encode_affine(jnp.asarray(coords), z_, s_, b_, j)
        return jnp.sum(out * ct)

    args = (jnp.asarray(z), jnp.asarray(scale), jnp.asarray(shift))
    want = np.asarray(jhg.hash_encode_affine(jnp.asarray(coords), *args, j))
    want_g = [np.asarray(g) for g in jax.grad(jloss, (0, 1, 2))(*args)]

    targs = [torch.tensor(a, requires_grad=True) for a in (z, scale, shift)]
    got = thg.hash_encode_affine(torch.as_tensor(coords), *targs, t)
    got_g = torch.autograd.grad(torch.sum(got * torch.as_tensor(ct)), targs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_affine_encode_equals_encode_of_decoded_table():
    _, t = _specs((4, 9, 30), 8, 3)
    coords, z, scale, shift, _ = _encode_inputs(2, t, ld=2)
    z_t, s_t, b_t = (torch.as_tensor(a) for a in (z, scale, shift))
    fused = thg.hash_encode_affine(torch.as_tensor(coords), z_t, s_t, b_t, t)
    plain = thg.hash_encode(torch.as_tensor(coords), z_t @ s_t + b_t, t)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)


def test_paged_layout_is_not_ported():
    """The paged layout itself is ported (tests/test_torch_paged_hash.py);
    what is not, the paged kernel's occupancy row, raises, and so does an
    unknown layout."""
    from shacira_tpu_torch.ops import paged_hash as tph
    spec = thg.HashGridSpec((17, 64), 17, 3, hash_layout='paged')
    with pytest.raises(NotImplementedError):
        tph.PagedStatic(spec=spec, lods=(1,), occ_res=128)
    with pytest.raises(ValueError):
        thg.HashGridSpec((4,), 8, 3, hash_layout='morton')
