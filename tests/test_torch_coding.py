"""Port parity: the arithmetic coder and the entropy estimates of
``shacira_tpu_torch/ops/coding.py`` against ``shacira_tpu/ops/coding.py``.

The native coder (``csrc/range_coder.cpp``, built with g++) must give the
bitstream of the port's pure-Python plain version and of the JAX package's
``ArithmeticCoder.encode`` byte for byte; sizes and estimates are equal.
"""
import numpy as np
import pytest

from shacira_tpu.ops import coding as jcoding
from shacira_tpu_torch.ops import coding as tcoding


def _symbols(seed, n, alphabet):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(alphabet))
    syms = rng.choice(alphabet, size=n, p=probs)
    hist = np.maximum(np.bincount(syms, minlength=alphabet).astype(
        np.float64), 1e-9)
    return syms, hist / hist.sum()


CASES = [(0, 500, 4), (1, 2000, 17), (2, 100, 2), (3, 3000, 9),
         (4, 1500, 300), (5, 1, 1), (6, 4000, 1)]


@pytest.mark.parametrize('seed,n,alphabet', CASES)
def test_round_trip(seed, n, alphabet):
    syms, probs = _symbols(seed, n, alphabet)
    stream = tcoding.ArithmeticCoder.encode(syms, probs)
    np.testing.assert_array_equal(
        tcoding.ArithmeticCoder.decode(stream, probs, n), syms)
    np.testing.assert_array_equal(
        tcoding.ArithmeticCoder._decode_py(stream, probs, n), syms)


@pytest.mark.parametrize('seed,n,alphabet', CASES)
def test_native_bitstream_equals_python_and_jax(seed, n, alphabet):
    syms, probs = _symbols(seed, n, alphabet)
    native = tcoding.ArithmeticCoder.encode(syms, probs)
    assert native == tcoding.ArithmeticCoder._encode_py(syms, probs)
    assert native == jcoding.ArithmeticCoder.encode(syms, probs)


@pytest.mark.parametrize('scale', [0.3, 3.0, 40.0])
def test_sizes_and_estimates_equal_jax(scale):
    """Rounded Gaussian latents, the payload's shape, and a model CDF."""
    rng = np.random.RandomState(int(scale * 10))
    w = np.round(rng.randn(20000) * scale).astype(np.int64)
    assert (tcoding.entropy_bits_histogram(w)
            == jcoding.entropy_bits_histogram(w))
    assert tcoding.coded_size_bits(w) == jcoding.coded_size_bits(w)
    uniq = np.unique(w)
    model = np.exp(-0.5 * (uniq / (scale + 0.5)) ** 2)
    assert (tcoding.coded_size_bits(w, probs=model)
            == jcoding.coded_size_bits(w, probs=model))


def test_code_length_near_entropy():
    rng = np.random.RandomState(0)
    syms = rng.choice(8, size=5000, p=np.asarray(
        [.5, .2, .1, .05, .05, .04, .03, .03]))
    bits = tcoding.coded_size_bits(syms)
    h = tcoding.entropy_bits_histogram(syms)
    assert h * 0.99 <= bits <= h * 1.05 + 64


def test_native_library_is_built_outside_the_sources():
    lib = tcoding.native_lib()
    assert 'build' in lib._name and 'csrc' not in lib._name


def test_bad_input_raises():
    probs = np.asarray([0.5, 0.5])
    with pytest.raises(ValueError, match='outside the alphabet'):
        tcoding.ArithmeticCoder.encode(np.asarray([0, 2]), probs)
    with pytest.raises(ValueError, match='alphabet'):
        tcoding.ArithmeticCoder.encode(np.zeros(3, np.int64),
                                       np.ones(1 << 16) / (1 << 16))
    with pytest.raises(ValueError, match='distinct symbols'):
        tcoding.coded_size_bits(np.asarray([0, 1, 2]), probs=probs)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No quiet fall-back to the Python coder."""
    bad = tmp_path / 'range_coder.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(tcoding, '_SOURCE', bad)
    monkeypatch.setattr(tcoding, '_LIBRARY', tmp_path / 'lib.so')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        tcoding._build_native()
