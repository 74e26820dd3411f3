"""The port's dataset loaders (qiddm_tpu_torch/data.py) against the JAX
package's (qiddm_tpu/data.py), name for name: every loader from the same
``.npz`` cache in a temporary ``QIDDM_DATA_DIR`` and from its offline
fallback, EMNIST also from idx files (rotated and flipped, labels shifted
by -1) and from its rendered letters. Compared exactly: both packages run
the same numpy (and PIL) arithmetic.

Both modules read ``DATA_DIR`` when imported, so each test points both at
its own directory, and ``HOME`` at an empty one (no idx files, no sklearn
data home).
"""

import gzip
import struct
import sys

import numpy as np
import pytest

from qiddm_tpu import data as jdata
from qiddm_tpu_torch import data as tdata


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    d = tmp_path / "data"
    d.mkdir()
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "DATA_DIR", d)
    return d


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def _both(name, **kw):
    return (tdata.ALL_LOADERS[name](**kw), jdata.ALL_LOADERS[name](**kw))


def test_all_loaders_are_the_jax_packages():
    assert sorted(tdata.ALL_LOADERS) == sorted(jdata.ALL_LOADERS)
    assert len(tdata.ALL_LOADERS) == 18


# (loader, npz name, cached images' shape, uint8) for each new loader: an
# RGB cache (luminance weights for CIFAR and faces, a channel mean for the
# rebuttal sets), another side (nearest-neighbour resize), floats in [0, 1]
NPZ = [
    ("mnist_32x32", "mnist_32", (30, 28, 28), True),
    ("emnist_28x28", "emnist_letters_28", (30, 28, 28), True),
    ("cifar10_32x32", "cifar10_32", (30, 32, 32, 3), True),
    ("celeba_32x32", "celeba_32", (30, 40, 40, 3), True),
    ("celeba_64x64", "celeba_64", (30, 64, 64), False),
    ("lfw_28x28", "lfw_28", (30, 28, 28, 3), True),
    ("lfw_64x64", "lfw_64", (30, 50, 50), True),
    ("lfw_128x128", "lfw_128", (12, 128, 128), False),
    ("lfw_512x512", "lfw_512", (12, 64, 64), True),
    ("bloodmnist_28x28", "bloodmnist_28", (30, 28, 28, 3), True),
    ("PneumoniaMNIST_28x28", "pneumoniamnist", (30, 28, 28), True),
    ("pathmnist_28x28", "pathmnist", (30, 28, 28, 3), False),
    ("fruit_64x64", "fruit360_64", (30, 64, 64, 3), True),
    ("logo2kplus_28x28", "logo2kplus_28", (30, 28, 28), False),
    ("xray_64x64", "xray", (30, 64, 64), True),
]


@pytest.mark.parametrize("name,npz,shape,uint8", NPZ,
                         ids=[n for n, *_ in NPZ])
def test_loader_from_its_npz_cache_matches_jax(data_dir, name, npz, shape,
                                              uint8):
    rng = np.random.default_rng(len(name))
    x = (rng.integers(0, 256, size=shape, dtype=np.uint8) if uint8
         else rng.uniform(size=shape))
    y = np.arange(shape[0]) % 3
    if name.startswith(("bloodmnist", "Pneumonia", "pathmnist")):
        y = y[:, None]  # MedMNIST keeps its labels as (N, 1)
    np.savez(data_dir / f"{npz}.npz", x=x, y=y)
    kw = {} if name.startswith("celeba") else {"n_classes": 2}
    got, want = _both(name, ds_size=9, **kw)
    _same(got, want)
    assert 0 < len(got[0]) <= 9 and got[0].shape[1] == got[2] * got[3]


def test_rebuttal_cache_prefers_the_sided_name(data_dir):
    """``<name>_<side>.npz`` is read before ``<name>.npz``."""
    for npz, fill in (("bloodmnist_28", 200), ("bloodmnist", 10)):
        np.savez(data_dir / f"{npz}.npz",
                 x=np.full((4, 28, 28), fill, np.uint8), y=np.zeros(4))
    got, want = _both("bloodmnist_28x28")
    _same(got, want)
    assert got[0].max() == pytest.approx(200 / 255)


# the textures fallback at every side up to 64 (lfw_128x128 and
# lfw_512x512 reach it through the same _lfw -> _face_like as lfw_28x28 and
# lfw_64x64; their 2,000 textures at 128 and 512 take minutes)
FALLBACKS = ["cifar10_32x32", "celeba_32x32", "celeba_64x64", "lfw_28x28",
             "lfw_64x64", "bloodmnist_28x28", "PneumoniaMNIST_28x28",
             "pathmnist_28x28", "fruit_64x64", "logo2kplus_28x28",
             "xray_64x64"]


@pytest.mark.parametrize("name", FALLBACKS)
def test_loader_from_its_texture_fallback_matches_jax(data_dir, name):
    with pytest.warns(UserWarning, match="synthetic textures"):
        got = tdata.ALL_LOADERS[name](ds_size=15)
    with pytest.warns(UserWarning, match="synthetic textures"):
        want = jdata.ALL_LOADERS[name](ds_size=15)
    _same(got, want)


def test_lfw_without_sklearn_takes_the_face_fallback(data_dir, monkeypatch):
    """The JAX package catches any failure of sklearn's LFW: without
    sklearn the port goes on to ``lfw_<side>.npz``, then textures."""
    want = jdata.lfw_28x28(ds_size=10)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    _same(tdata.lfw_28x28(ds_size=10), want)


def test_mnist_32x32_digits_fallback_matches_jax(data_dir):
    with pytest.warns(UserWarning, match="sklearn digits"):
        got = tdata.mnist_32x32(ds_size=20)
    with pytest.warns(UserWarning, match="sklearn digits"):
        want = jdata.mnist_32x32(ds_size=20)
    _same(got, want)


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_emnist_from_idx_files_matches_jax(data_dir, tmp_path):
    """Labels 1..26 shift to 0..25; images rotate -90 degrees and flip."""
    root = tmp_path / "emnist"
    root.mkdir()
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, size=(40, 28, 28), dtype=np.uint8)
    _write_idx(root / "emnist-letters-train-images-idx3-ubyte.gz", imgs)
    _write_idx(root / "emnist-letters-train-labels-idx1-ubyte.gz",
               1 + np.arange(40) % 26)
    got, want = _both("emnist_28x28", n_classes=26, ds_size=30)
    _same(got, want)
    np.testing.assert_array_equal(got[1], np.arange(30) % 26)
    np.testing.assert_array_equal(
        got[0][0].reshape(28, 28), np.rot90(imgs[0] / 255.0, -1)[:, ::-1])


def test_letters_fallback_renders_the_jax_packages_letters(tmp_path,
                                                          monkeypatch):
    """The font-rendered stand-in, 3 glyphs a class (each package renders
    into its own directory), and its cache, which ``emnist_28x28`` reads
    when there is no idx file and no ``emnist_letters_28.npz``."""
    monkeypatch.setenv("HOME", str(tmp_path))
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "DATA_DIR", tmp_path / mod.__name__)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = tdata._letters_fallback(28, per_class=3)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        want = jdata._letters_fallback(28, per_class=3)
    _same(got, want)
    assert got[0].shape == (78, 28, 28)
    assert sorted(set(got[1].tolist())) == list(range(26))
    assert (tmp_path / tdata.__name__ / "emnist_letters_synth_28.npz").exists()
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        cached = tdata.emnist_28x28(n_classes=26, ds_size=20)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        _same(cached, jdata.emnist_28x28(n_classes=26, ds_size=20))
    np.testing.assert_array_equal(cached[0], got[0][:20].reshape(20, -1))


def test_letters_fallback_without_fonts_takes_digits_then_names_the_npz(
        data_dir, monkeypatch):
    monkeypatch.setattr(tdata, "_FONT_FILES", [])
    with pytest.warns(UserWarning, match="sklearn digits"):
        got = tdata._letters_fallback(28)
    with pytest.warns(UserWarning, match="sklearn digits"):
        _same(got, jdata._digits_fallback(28, "emnist_letters"))
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        with pytest.raises(RuntimeError, match="sklearn") as err:
            tdata.emnist_28x28()
    assert str(data_dir / "emnist_letters_28.npz") in str(err.value)
