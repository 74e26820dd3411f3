"""Dataset loaders with the reference's signatures, offline-safe
(counterpart of ``qiddm_tpu/data.py``: the same 18 loaders, name for name).

Every loader returns ``(x_flat float64 (N, pixels), y int64 (N,), height,
width)`` and resolves its data in order:

1. raw dataset files already on disk (torchvision's idx layout, e.g.
   ``~/mnist/MNIST/raw``, ``~/fashion``, ``~/emnist``);
2. ``.npz`` caches under ``$QIDDM_DATA_DIR`` (default ``~/qiddm_data``)
   with arrays ``x`` (N, H, W [, C]) and ``y`` (N,): ``mnist_28.npz``,
   ``fashion_28.npz``, ``emnist_letters_28.npz``, ``cifar10_32.npz``,
   ``celeba_<side>.npz``, ``lfw_<side>.npz``, and for the rebuttal
   datasets ``<name>_<side>.npz`` or ``<name>.npz`` (``bloodmnist``,
   ``pneumoniamnist``, ``pathmnist``, ``fruit360``, ``logo2kplus``,
   ``xray``);
3. an offline fallback: sklearn's 8x8 digits resampled (the MNIST
   loaders), font-rendered letters (EMNIST), or deterministic synthetic
   textures (every other dataset; numpy only), each with a warning.

sklearn and PIL are imported only inside the paths that need them: a
machine without them (such as the GPU host) needs 1. or 2. for the digit
and letter datasets, and a missing one there raises and names the
``.npz`` to provide. The texture fallbacks run anywhere.
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


def _unit_range(imgs: np.ndarray) -> np.ndarray:
    """An npz cache's images as float64 in [0, 1] (uint8 caches hold
    0-255)."""
    imgs = imgs.astype(np.float64)
    return imgs / 255.0 if imgs.max() > 1.5 else imgs


# the reference's RGB -> grayscale weights (torchvision's T.Grayscale)
_LUMINANCE = np.array([0.2989, 0.587, 0.114])


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
        imgs, labels = _unit_range(cache[0]), cache[1]
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


def fashion_28x28(n_classes=10, ds_size=100):
    """FashionMNIST (the noise driver ``fashion_noise``'s default)."""
    imgs, labels = _load_mnist_like(
        "fashion", ["~/fashion", str(DATA_DIR / "fashion")],
        ["train-images-idx3-ubyte"], ["train-labels-idx1-ubyte"], 28,
        fallback="texture")
    return _finish(imgs, labels, n_classes, ds_size, 28, 28)


def mnist_32x32(n_classes=10, ds_size=100):
    imgs, labels = _load_mnist_like(
        "mnist", ["~/mnist", str(DATA_DIR / "mnist")],
        ["train-images-idx3-ubyte"], ["train-labels-idx1-ubyte"], 32)
    return _finish(imgs, labels, n_classes, ds_size, 32, 32)


def emnist_28x28(n_classes=10, ds_size=100):
    """EMNIST letters (reference src/data.py:199-225). From idx files the
    images are rotated -90 degrees and flipped to fix the raw orientation
    and the labels 1..26 become 0..25; an ``emnist_letters_28.npz`` cache
    is taken as it is."""
    pair = _find_idx_pair(
        ["~/emnist", str(DATA_DIR / "emnist")],
        ["emnist-letters-train-images-idx3-ubyte"],
        ["emnist-letters-train-labels-idx1-ubyte"])
    if pair is not None:
        imgs = _read_idx(pair[0]).astype(np.float64) / 255.0
        labels = _read_idx(pair[1]).astype(np.int64) - 1
        imgs = np.rot90(imgs, k=-1, axes=(1, 2))[:, :, ::-1]
    else:
        cache = _load_npz_cache("emnist_letters_28")
        if cache is not None:
            imgs, labels = _unit_range(cache[0]), cache[1]
        else:
            imgs, labels = _letters_fallback(28)
    return _finish(imgs, labels, n_classes, ds_size, 28, 28)


_FONT_FILES = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono-Bold.ttf",
]


def _letters_fallback(side: int, per_class: int = 200):
    """A synthetic stand-in for EMNIST letters: font-rendered a-z glyphs
    (the DejaVu fonts, both cases) with random affine jitter, blur and
    ink-centroid centring, white on black, ``side x side``; the same
    images as the JAX package's fallback. Results on it are
    synthetic-data results.

    It is cached as ``emnist_letters_synth_<side>.npz`` after the first
    render. Without PIL or the fonts it falls back to sklearn's digits,
    and without sklearn too it raises and names ``emnist_letters_28.npz``,
    the cache to provide."""
    warnings.warn(
        "EMNIST letters not found on disk and this environment has no "
        "network access; using a SYNTHETIC font-rendered letters stand-in "
        f"(26 classes x {per_class}). Results on it are synthetic-data "
        f"results. Drop real EMNIST idx files or emnist_letters_28.npz in "
        f"{DATA_DIR} for real data.")
    cache_path = DATA_DIR / f"emnist_letters_synth_{side}.npz"
    if cache_path.exists():
        z = np.load(cache_path)
        return (np.asarray(z["x"], np.float64) / 255.0,
                np.asarray(z["y"], np.int64))
    font_files = [f for f in _FONT_FILES if pathlib.Path(f).exists()]
    try:
        from PIL import Image, ImageDraw, ImageFilter, ImageFont
    except ImportError:
        font_files = []
    if not font_files:  # no renderer: the digits' shapes, or raise
        return _digits_fallback(side, "emnist_letters")
    rng = np.random.default_rng(0xE71157)
    big = side * 4  # a supersampled canvas for smooth strokes
    fonts = {}
    imgs, labels = [], []
    for cls in range(26):
        for _ in range(per_class):
            ch = chr((ord("A") if rng.random() < 0.5 else ord("a")) + cls)
            fkey = (font_files[int(rng.integers(len(font_files)))],
                    int(rng.integers(int(big * 0.55), int(big * 0.8))))
            if fkey not in fonts:
                fonts[fkey] = ImageFont.truetype(*fkey)
            img = Image.new("L", (big, big), 0)
            ImageDraw.Draw(img).text((big // 2, big // 2), ch, fill=255,
                                     font=fonts[fkey], anchor="mm")
            # a random affine map: rotation, shear, translation
            ang = float(rng.uniform(-20, 20))
            shear = float(rng.uniform(-0.25, 0.25))
            tx = float(rng.uniform(-0.06, 0.06)) * big
            ty = float(rng.uniform(-0.06, 0.06)) * big
            c, cy = big / 2, big / 2
            cos, sin = np.cos(np.radians(ang)), np.sin(np.radians(ang))
            img = img.transform(
                (big, big), Image.AFFINE,
                (cos, shear - sin, c - c * cos - cy * (shear - sin) + tx,
                 sin, cos, cy - c * sin - cy * cos + ty),
                resample=Image.BILINEAR)
            img = img.filter(ImageFilter.GaussianBlur(
                float(rng.uniform(0.5, 2.0))))
            a = np.asarray(img, np.float64)
            if a.max() > 0:  # centre the ink's centroid (EMNIST's by mass)
                ys, xs = np.mgrid[0:big, 0:big]
                m = a.sum()
                dy = int(round(big / 2 - (a * ys).sum() / m))
                dx = int(round(big / 2 - (a * xs).sum() / m))
                a = np.roll(np.roll(a, dy, axis=0), dx, axis=1)
            small = np.asarray(
                Image.fromarray(a.astype(np.uint8)).resize(
                    (side, side), Image.LANCZOS), np.float64)
            peak = small.max()
            if peak > 0:
                small = small / peak
            imgs.append(np.clip(small, 0.0, 1.0))
            labels.append(cls)
    imgs = np.stack(imgs)
    labels = np.asarray(labels, np.int64)
    # interleave the classes, so the head that ds_size keeps holds each
    order = rng.permutation(len(imgs))
    imgs, labels = imgs[order], labels[order]
    # quantized before returning, so a cached and a fresh load are equal
    x8 = (imgs * 255).astype(np.uint8)
    try:
        DATA_DIR.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(cache_path, x=x8, y=labels)
    except OSError:
        pass
    return x8.astype(np.float64) / 255.0, labels


def cifar10_32x32(n_classes=10, ds_size=100):
    cache = _load_npz_cache("cifar10_32")
    if cache is not None:
        imgs, labels = _unit_range(cache[0]), cache[1]
        if imgs.ndim == 4:  # RGB -> grayscale as the reference transform
            imgs = imgs @ _LUMINANCE
    else:
        imgs, labels = _texture_fallback(32, "cifar10")
    return _finish(imgs, labels, n_classes, ds_size, 32, 32)


def _face_like(name, side, label_or_classes, ds_size):
    cache = _load_npz_cache(f"{name}_{side}")
    if cache is not None:
        imgs, labels = _unit_range(cache[0]), cache[1]
        if imgs.ndim == 4:  # RGB -> grayscale (the reference's T.Grayscale)
            imgs = imgs @ _LUMINANCE
        if imgs.shape[1] != side:
            imgs = _resize(imgs, side)
    else:
        imgs, labels = _texture_fallback(side, name)
    return imgs, labels


def _celeba(side, label, ds_size):
    """The images of ``label`` (all of them when none has it), cut to
    ``ds_size``."""
    imgs, labels = _face_like("celeba", side, label, ds_size)
    mask = labels == label
    if mask.sum() == 0:
        mask = np.ones(len(labels), bool)
    imgs, labels = imgs[mask][:ds_size], labels[mask][:ds_size]
    return (imgs.reshape(len(imgs), -1), labels.astype(np.int64), side,
            side)


def celeba_32x32(label=1, ds_size=10000, n_classes=None):
    """The reference's signature is (label) only (src/data.py:74), which
    its own drivers cannot call; ``n_classes`` is accepted and ignored, so
    the drivers' convention works."""
    return _celeba(32, label, ds_size)


def celeba_64x64(label=1, ds_size=10000, n_classes=None):
    return _celeba(64, label, ds_size)


def _lfw(side, n_classes, ds_size):
    """sklearn's LFW people from its local cache (no download), else
    ``lfw_<side>.npz``, else textures; any failure of the first (no
    sklearn, no cache) goes on to the second, as in the JAX package."""
    try:
        people = _sk_datasets("LFW is read through sklearn").fetch_lfw_people(
            resize=None, download_if_missing=False)
        imgs = (people.images / 255.0 if people.images.max() > 1.5
                else people.images)
        imgs = _resize(imgs, side)
        labels = people.target
    except Exception:
        imgs, labels = _face_like("lfw", side, n_classes, ds_size)
    return _finish(imgs, labels, n_classes, ds_size, side, side)


def lfw_28x28(n_classes=10, ds_size=1000):
    return _lfw(28, n_classes, ds_size)


def lfw_64x64(n_classes=10, ds_size=1000):
    return _lfw(64, n_classes, ds_size)


def lfw_128x128(n_classes=10, ds_size=1000):
    return _lfw(128, n_classes, ds_size)


def lfw_512x512(n_classes=10, ds_size=1000):
    return _lfw(512, n_classes, ds_size)


# the rebuttal drivers' datasets, missing from the reference release
# (SURVEY section 8.5)

def _medmnist(name, side, n_classes, ds_size):
    """``<name>_<side>.npz``, else ``<name>.npz``, else textures; an RGB
    cache is averaged over its channels (not the luminance weights of the
    faces and CIFAR)."""
    cache = _load_npz_cache(f"{name}_{side}") or _load_npz_cache(name)
    if cache is not None:
        imgs, labels = _unit_range(cache[0]), cache[1]
        if imgs.ndim == 4:
            imgs = imgs.mean(axis=-1)
        labels = labels.reshape(-1)
    else:
        imgs, labels = _texture_fallback(side, name)
    return _finish(imgs, labels, n_classes, ds_size, side, side)


def bloodmnist_28x28(n_classes=8, ds_size=500):
    return _medmnist("bloodmnist", 28, n_classes, ds_size)


def PneumoniaMNIST_28x28(n_classes=2, ds_size=500):
    return _medmnist("pneumoniamnist", 28, n_classes, ds_size)


def pathmnist_28x28(n_classes=9, ds_size=500):
    return _medmnist("pathmnist", 28, n_classes, ds_size)


def fruit_64x64(n_classes=10, ds_size=500):
    return _medmnist("fruit360", 64, n_classes, ds_size)


def logo2kplus_28x28(n_classes=10, ds_size=500):
    return _medmnist("logo2kplus", 28, n_classes, ds_size)


def xray_64x64(n_classes=2, ds_size=500):
    return _medmnist("xray", 64, n_classes, ds_size)


ALL_LOADERS = {fn.__name__: fn for fn in (
    mnist_8x8, mnist_28x28, mnist_32x32, fashion_28x28, emnist_28x28,
    cifar10_32x32, celeba_32x32, celeba_64x64, lfw_28x28, lfw_64x64,
    lfw_128x128, lfw_512x512, bloodmnist_28x28, PneumoniaMNIST_28x28,
    pathmnist_28x28, fruit_64x64, logo2kplus_28x28, xray_64x64)}
