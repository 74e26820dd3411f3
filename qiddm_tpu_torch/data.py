"""Dataset loaders with the reference's signatures, offline-safe
(counterpart of ``qiddm_tpu/data.py:36-189``; ported so far: ``mnist_8x8``
and ``mnist_28x28``).

Every loader returns ``(x_flat float64 (N, pixels), y int64 (N,), height,
width)``. ``mnist_28x28`` resolves its data in order:

1. MNIST idx files already on disk (torchvision layout, e.g.
   ``~/mnist/MNIST/raw``);
2. ``$QIDDM_DATA_DIR/mnist_28.npz`` (default ``~/qiddm_data``) with arrays
   ``x`` (N, H, W [, C]) and ``y`` (N,);
3. sklearn's 8x8 digits resampled to 28x28, with a warning.

sklearn is imported only inside the digits paths: a machine without it
(such as the GPU host) needs 1. or 2., and a missing dataset there raises
and names the ``.npz`` to provide.
"""

from __future__ import annotations

import gzip
import os
import pathlib
import struct
import warnings
import zlib

import numpy as np

DATA_DIR = pathlib.Path(os.environ.get("QIDDM_DATA_DIR",
                                       os.path.expanduser("~/qiddm_data")))


def _sk_datasets(remedy: str):
    """``sklearn.datasets``, or a RuntimeError that says what to provide
    instead."""
    try:
        from sklearn import datasets
    except ImportError as e:
        raise RuntimeError(f"sklearn is not installed: {remedy}") from e
    return datasets


def _read_idx(path: pathlib.Path) -> np.ndarray:
    """Parse an MNIST-format idx file (optionally gzipped)."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_idx_pair(roots, img_names, lbl_names):
    for root in roots:
        root = pathlib.Path(os.path.expanduser(root))
        for sub in ("", "MNIST/raw", "FashionMNIST/raw", "EMNIST/raw", "raw"):
            base = root / sub if sub else root
            for img_n in img_names:
                for ext in ("", ".gz"):
                    img = base / (img_n + ext)
                    if not img.exists():
                        continue
                    for lbl_n in lbl_names:
                        for ext2 in ("", ".gz"):
                            lbl = base / (lbl_n + ext2)
                            if lbl.exists():
                                return img, lbl
    return None


def _load_npz_cache(name: str):
    p = DATA_DIR / f"{name}.npz"
    if p.exists():
        z = np.load(p)
        return np.asarray(z["x"]), np.asarray(z["y"])
    return None


def _digits_fallback(side: int, name: str):
    """Upsample sklearn's 8x8 digits to ``side`` — real digit images, used
    when the requested dataset is not on disk (offline environment)."""
    datasets = _sk_datasets(
        f"dataset {name!r} is not on disk and its digits fallback needs "
        f"sklearn; provide {DATA_DIR / f'{name}_{side}.npz'} with arrays "
        f"x (N, H, W) and y (N,)")
    warnings.warn(
        f"dataset {name!r} not found on disk and this environment has no "
        f"network access; falling back to sklearn digits resampled to "
        f"{side}x{side}. Drop an .npz cache in {DATA_DIR} for real data.")
    x, y = datasets.load_digits(return_X_y=True)
    imgs = x.reshape(-1, 8, 8) / 16.0
    reps = max(1, side // 8)
    up = np.repeat(np.repeat(imgs, reps, axis=1), reps, axis=2)
    pad_h = side - up.shape[1]
    pad_w = side - up.shape[2]
    if pad_h or pad_w:
        up = np.pad(up, ((0, 0), (pad_h // 2, pad_h - pad_h // 2),
                         (pad_w // 2, pad_w - pad_w // 2)))
    return up[:, :side, :side], y


def _texture_fallback(side: int, name: str, n_classes: int = 10,
                      n: int = 2000, channels: int = 1):
    """Deterministic class-structured textures for non-digit datasets."""
    warnings.warn(
        f"dataset {name!r} unavailable offline; generating deterministic "
        f"synthetic textures ({n} samples, {n_classes} classes). Drop an "
        f".npz cache in {DATA_DIR} for real data.")
    # a stable per-name seed (Python's hash() is salted per process)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    yy, xx = np.mgrid[0:side, 0:side] / side
    y = rng.integers(0, n_classes, size=n)
    freqs = 1.0 + np.arange(n_classes)
    phases = rng.uniform(0, 2 * np.pi, size=(n, 2))
    base = 0.5 + 0.45 * np.sin(
        freqs[y][:, None, None] * np.pi * (xx + yy)[None] + phases[:, :1, None])
    base = base * (0.7 + 0.3 * np.cos(
        freqs[y][:, None, None] * np.pi * (xx - yy)[None] + phases[:, 1:, None]))
    base += 0.05 * rng.standard_normal((n, side, side))
    base = np.clip(base, 0, 1)
    if channels > 1:
        base = np.stack([np.roll(base, s, axis=1) for s in range(channels)], -1)
    return base, y


def _finish(imgs, labels, n_classes, ds_size, h, w):
    """Filter to the first n_classes, truncate, flatten, cast (reference
    loaders slice the head of the dataset without shuffling)."""
    mask = labels < n_classes
    imgs, labels = imgs[mask], labels[mask]
    imgs, labels = imgs[:ds_size], labels[:ds_size]
    x = imgs.reshape(len(imgs), -1).astype(np.float64)
    return x, labels.astype(np.int64), h, w


def _resize(imgs: np.ndarray, side: int) -> np.ndarray:
    """Nearest-neighbour resize of (N, H, W) to (N, side, side)."""
    n, h, w = imgs.shape[:3]
    ri = (np.arange(side) * h // side).clip(0, h - 1)
    ci = (np.arange(side) * w // side).clip(0, w - 1)
    return imgs[:, ri][:, :, ci]


def _load_mnist_like(name, roots, img_names, lbl_names, side,
                     fallback="digits"):
    pair = _find_idx_pair(roots, img_names, lbl_names)
    if pair is not None:
        imgs = _read_idx(pair[0]).astype(np.float64) / 255.0
        labels = _read_idx(pair[1]).astype(np.int64)
        if imgs.shape[1] != side:
            imgs = _resize(imgs, side)
        return imgs, labels
    cache = _load_npz_cache(f"{name}_{side}")
    if cache is not None:
        imgs, labels = cache
        imgs = imgs.astype(np.float64)
        if imgs.max() > 1.5:
            imgs = imgs / 255.0
        if imgs.ndim == 4:  # (N, H, W, C) cache -> grayscale like siblings
            imgs = imgs.mean(axis=-1)
        if imgs.shape[1] != side:
            imgs = _resize(imgs, side)
        return imgs, labels.astype(np.int64)
    if fallback == "digits":
        return _digits_fallback(side, name)
    return _texture_fallback(side, name)


def mnist_8x8(n_classes=10, ds_size=100):
    """sklearn digits (reference src/data.py:10-17); digits has 10
    classes, so larger requests clamp to all 10."""
    datasets = _sk_datasets("mnist_8x8 is sklearn's digits dataset")
    x, y = datasets.load_digits(n_class=min(n_classes, 10), return_X_y=True)
    x = (x / 16.0).reshape(-1, 64)
    x, y = x[:ds_size], y[:ds_size]
    return x.astype(np.float64), y.astype(np.int64), 8, 8


def mnist_28x28(n_classes=10, ds_size=100):
    imgs, labels = _load_mnist_like(
        "mnist", ["~/mnist", "~/data/mnist", str(DATA_DIR / "mnist")],
        ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
        ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"], 28)
    return _finish(imgs, labels, n_classes, ds_size, 28, 28)


ALL_LOADERS = {"mnist_8x8": mnist_8x8, "mnist_28x28": mnist_28x28}
