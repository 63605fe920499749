"""The port's MNIST data helpers are copies of the JAX package's numpy
modules (the port may not import them): the same inputs give the same
arrays, bit for bit."""
import numpy as np
import pytest

from imagecfgen_tpu.core import attributes as jattrs
from imagecfgen_tpu.data import mnist as jmnist
from imagecfgen_tpu.data.synthetic_digits import synthetic_digits as j_synthetic_digits
from imagecfgen_tpu.morphomnist import io as jio
from imagecfgen_torch.core import attributes as tattrs
from imagecfgen_torch.data import mnist as tmnist
from imagecfgen_torch.data.synthetic_digits import synthetic_digits
from imagecfgen_torch.morphomnist import io as tio


def raw_attrs(n, seed):
    rng = np.random.default_rng(seed)
    return {"digit": np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)],
            "thickness": rng.gamma(10, 1 / 5, n) + 0.5,
            "intensity": rng.uniform(64, 255, n).astype(np.float32),
            "slant": rng.normal(0, 0.3, n)}


def assert_same(a, b):
    assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_pack_and_split_columns_match_jax():
    raw = raw_attrs(17, 0)
    packed = tattrs.pack_mnist_attrs(raw)
    assert_same(packed, jattrs.pack_mnist_attrs(raw))
    assert packed.shape == (17, 13)
    assert tattrs.MNIST_LAYOUT == jattrs.MNIST_LAYOUT
    got = tattrs.split_columns(packed, None, tattrs.MNIST_LAYOUT)
    want = jattrs.split_columns(packed, None, jattrs.MNIST_LAYOUT)
    assert list(got) == list(want) == ["digit", "thickness", "intensity", "slant"]
    for k in want:
        assert_same(got[k], want[k])
        np.testing.assert_array_equal(got[k], np.asarray(raw[k], np.float32))


@pytest.mark.parametrize("shape", [(7,), (3, 4)])
def test_one_hot_matches_jax(shape):
    labels = np.random.default_rng(1).integers(0, 10, shape)
    got = tattrs.one_hot(labels, 10)
    assert_same(got, np.asarray(jattrs.one_hot(labels, 10)))
    assert got.shape == (*shape, 10) and (got.sum(-1) == 1).all()


@pytest.mark.parametrize("seed,n", [(0, 40), (7, 25)])
def test_synthetic_digits_match_jax(seed, n):
    x, y = synthetic_digits(n, seed)
    jx, jy = j_synthetic_digits(n, seed)
    assert_same(x, jx)
    assert_same(y, jy)
    assert x.shape == (n, 28, 28) and 0 <= x.min() and x.max() <= 255.0


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_idx_round_trips_across_packages(tmp_path, suffix):
    data = np.random.default_rng(2).integers(0, 256, (5, 28, 28)).astype(np.uint8)
    a, b = str(tmp_path / f"a-idx3-ubyte{suffix}"), str(tmp_path / f"b-idx3-ubyte{suffix}")
    tio.save_idx(data, a)
    jio.save_idx(data, b)
    if not suffix:  # gzip stamps the time
        assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        assert_same(tio.load_idx(path), jio.load_idx(path))
        np.testing.assert_array_equal(tio.load_idx(path), data)


def test_load_raw_mnist_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    tio.save_idx(rng.integers(0, 256, (6, 28, 28)), str(tmp_path / "t10k-images-idx3-ubyte.gz"))
    tio.save_idx(rng.integers(0, 10, 6), str(tmp_path / "t10k-labels-idx1-ubyte"))
    for got, want in zip(tmnist.load_raw_mnist(str(tmp_path), "test"),
                         jmnist.load_raw_mnist(str(tmp_path), "test")):
        assert_same(got, want)
    with pytest.raises(FileNotFoundError):
        tmnist.load_raw_mnist(str(tmp_path), "train")


def test_load_mnist_arrays_round_trips(tmp_path):
    raw = raw_attrs(9, 4)
    x = np.random.default_rng(4).integers(0, 256, (9, 28, 28)).astype(np.uint8)
    np.save(tmp_path / "mnist-x-train.npy", x)
    np.save(tmp_path / "mnist-a-train.npy", tattrs.pack_mnist_attrs(raw))
    tx, ta = tmnist.load_mnist_arrays(str(tmp_path), "train")
    jx, ja = jmnist.load_mnist_arrays(str(tmp_path), "train")
    assert_same(tx, jx)
    np.testing.assert_array_equal(tx, x.astype(np.float32))
    assert list(ta) == list(ja)
    for k in ja:
        assert_same(ta[k], ja[k])
        np.testing.assert_array_equal(ta[k], np.asarray(raw[k], np.float32))
    np.testing.assert_array_equal(tattrs.pack_mnist_attrs(ta), tattrs.pack_mnist_attrs(raw))
