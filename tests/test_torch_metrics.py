"""Port parity: image metrics (``ops/image.py``) and LPIPS (``ops/lpips.py``)
against the JAX package, and what ``MultiviewTrainer.evaluate`` returns.

SSIM agrees to 1e-5 (f32, other summation orders); the clamped (uint8)
MSE and PSNR exactly where the f32 sum of squared integer differences is
exact (close images), else to 1e-6; LPIPS with the same random weights to
1e-4 relative (f32 convolutions through 13 VGG layers).
"""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from shacira_tpu.ops import image as jimage  # noqa: E402
from shacira_tpu.ops import lpips as jlpips  # noqa: E402
from shacira_tpu_torch.ops import image as timage  # noqa: E402
from shacira_tpu_torch.ops import lpips as tlpips  # noqa: E402


def _pair(kind, seed, h=37, w=29):
    rng = np.random.RandomState(seed)
    if kind == 'random':
        a = rng.uniform(0, 1, (h, w, 3))
        b = rng.uniform(0, 1, (h, w, 3))
    elif kind == 'structured':
        yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                             indexing='ij')
        a = np.stack([0.5 + 0.4 * np.sin(7 * xx), 0.5 + 0.4 * np.cos(5 * yy),
                      xx * yy], -1)
        b = np.clip(a + 0.05 * rng.randn(h, w, 3), 0, 1)
    else:                       # 'close': small differences, out of range
        a = rng.uniform(-0.1, 1.1, (h, w, 3))
        b = a + rng.uniform(-0.02, 0.02, (h, w, 3))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize('kind,seed', [('random', 0), ('random', 1),
                                       ('structured', 2), ('structured', 3),
                                       ('close', 4)])
def test_ssim_matches_jax(kind, seed):
    a, b = _pair(kind, seed)
    want = float(jimage.ssim(a, b))
    got = float(timage.ssim(torch.as_tensor(a), torch.as_tensor(b)))
    assert abs(got - want) <= 1e-5
    assert float(timage.ssim(torch.as_tensor(a), torch.as_tensor(a))) \
        == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize('seed', [5, 6, 7])
def test_clamped_metrics_exact(seed):
    a, b = _pair('close', seed)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert float(timage.clamped_mse(ta, tb)) == float(jimage.clamped_mse(ja, jb))
    assert (float(timage.clamped_psnr(ta, tb))
            == pytest.approx(float(jimage.clamped_psnr(ja, jb)), rel=1e-7,
                             abs=0))
    assert float(timage.mse(ta, tb)) == pytest.approx(
        float(jimage.mse(ja, jb)), rel=1e-6)
    # far apart: the f32 sums round in other orders
    a, b = _pair('random', seed)
    np.testing.assert_allclose(
        float(timage.clamped_psnr(torch.as_tensor(a), torch.as_tensor(b))),
        float(jimage.clamped_psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_uint8_cast_truncates():
    x = torch.as_tensor([[[0.999, 0.5, 1.7]]])
    y = torch.as_tensor([[[0.0, 0.0, 0.0]]])
    # 254.745 -> 254, 127.5 -> 127, clamped 255
    want = (254 ** 2 + 127 ** 2 + 255 ** 2) / 3
    assert float(timage.clamped_mse(x, y)) == pytest.approx(want, rel=1e-7)


@pytest.fixture(scope='module')
def lpips_weights():
    raw = tlpips.random_weights(0)
    return raw, tlpips.prepare_weights(raw)


def test_random_weights_equal_jax():
    a, b = tlpips.random_weights(3), jlpips.random_weights(3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize('shape', [(32, 32), (40, 52)])
def test_lpips_matches_jax(lpips_weights, shape):
    raw, weights = lpips_weights
    a, b = _pair('structured', 11, *shape)
    want = jlpips.lpips(a, b, weights={k: jnp.asarray(v)
                                       for k, v in raw.items()})
    got = tlpips.lpips(a, b, weights=weights)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tlpips.lpips(a, a, weights=weights) == pytest.approx(0, abs=1e-6)


def test_npz_round_trip(tmp_path, lpips_weights, monkeypatch):
    raw, weights = lpips_weights
    path = str(tmp_path / 'lpips_vgg.npz')
    np.savez(path, **raw)
    loaded = tlpips.load_lpips_weights(path)
    assert loaded['conv0_w'].shape == (64, 3, 3, 3)        # OIHW
    for k in weights:
        torch.testing.assert_close(loaded[k], weights[k], rtol=0, atol=0)
    monkeypatch.setenv(tlpips.ENV_VAR, path)
    a, b = _pair('random', 12, 32, 32)
    assert tlpips.lpips(a, b) == tlpips.lpips(a, b, weights=weights)


def test_missing_weights_raise(monkeypatch):
    monkeypatch.delenv(tlpips.ENV_VAR, raising=False)
    with pytest.raises(RuntimeError, match='LPIPS weights not found'):
        tlpips.load_lpips_weights(None)
    with pytest.raises(RuntimeError, match='LPIPS weights not found'):
        tlpips.load_lpips_weights('/nonexistent/lpips.npz')


def test_evaluate_returns_ssim_and_lpips(tmp_path, lpips_weights,
                                         monkeypatch):
    """PSNR and SSIM of each rendered view, and LPIPS with the weights."""
    from shacira_tpu_torch.ops.image import psnr
    from tests.test_torch_size_report import _trainers
    _, ttr, _, _ = _trainers(1, res=16)     # SSIM's 11 taps fit
    monkeypatch.delenv(tlpips.ENV_VAR, raising=False)
    m = ttr.evaluate([0, 1])
    assert set(m) == {'psnr', 'ssim'}
    raw, weights = lpips_weights
    path = str(tmp_path / 'w.npz')
    np.savez(path, **raw)
    monkeypatch.setenv(tlpips.ENV_VAR, path)
    m = ttr.evaluate([1])
    d = ttr.dataset
    pred = torch.as_tensor(ttr.render_view(1))
    gt = torch.as_tensor(d.rgb[1].reshape(d.h, d.w, 3))
    assert m['psnr'] == float(psnr(pred, gt))
    assert m['ssim'] == float(timage.ssim(pred, gt))
    assert m['lpips'] == tlpips.lpips(torch.clamp(pred, 0, 1), gt,
                                      weights=weights)
