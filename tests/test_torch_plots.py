"""The plots of qiddm_tpu_torch against qiddm_tpu's on the CPU:
``metrics.show_metrics``, ``show_histogram``, ``show_images``, the dict
metrics' curves, and the drivers' PNG dumps (``cli/common._dump_images``).

Each function runs in both packages on the same data with ``savefig`` and
``imsave`` recorded, not written: the same file names (relative to each
run's save path) and the same plotted data, read from the figure before it
is saved (lines, markers, bars, titles, axis labels, legends, ticks, the
y range). Then the drivers: a training run plots its loss and score curves
and dumps its images where matplotlib imports, and says so in one line where
it cannot.
"""

import argparse
import pathlib
import sys

import numpy as np
import pytest
import torch

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from qiddm_tpu import metrics as jmetrics  # noqa: E402
from qiddm_tpu.cli import common as jcommon  # noqa: E402
from qiddm_tpu_torch import metrics as tmetrics  # noqa: E402
from qiddm_tpu_torch.cli import common as tcommon  # noqa: E402
from qiddm_tpu_torch.cli import mnist_exm as tmnist  # noqa: E402


def _figure_data(fig):
    """What a figure shows, as plain values."""
    out = []
    for ax in fig.get_axes():
        legend = ax.get_legend()
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(),
            "lines": [(l.get_label(), np.asarray(l.get_xdata(), float).tolist(),
                       np.asarray(l.get_ydata(), float).tolist(),
                       l.get_marker(), l.get_color(), l.get_linewidth())
                      for l in ax.get_lines()],
            "bars": [(p.get_x(), p.get_width(), p.get_height(),
                      tuple(p.get_facecolor()), p.get_label())
                     for p in ax.patches],
            "images": [np.asarray(im.get_array()).tolist()
                       for im in ax.get_images()],
            "legend": ([t.get_text() for t in legend.get_texts()]
                       if legend else None),
            "xticks": [(float(v), t.get_text()) for v, t in
                       zip(ax.get_xticks(), ax.get_xticklabels())],
            "ylim": ax.get_ylim() if ax.patches else None,
        })
    return out


@pytest.fixture
def recorded(monkeypatch):
    """``plt.savefig`` and ``plt.imsave`` recorded: {path: figure data or
    image}. Figures saved through ``Figure.savefig`` are recorded too."""
    seen = {}

    def savefig(path, *a, **kw):
        seen[str(path)] = _figure_data(plt.gcf())

    def imsave(path, arr, *a, **kw):
        seen[str(path)] = np.asarray(arr).tolist()

    monkeypatch.setattr(plt, "savefig", savefig)
    monkeypatch.setattr(plt, "imsave", imsave)
    return seen


def _args(path, label=3):
    return argparse.Namespace(save_path=str(path), label=label,
                              data="mnist_8x8", img_size=8)


def _both(seen, tmp_path, call):
    """Run ``call(package, args)`` for each package; returns the records
    of each, keyed by path relative to its save path."""
    out = []
    for name, pkg in (("jax", jmetrics), ("port", tmetrics)):
        base = tmp_path / name
        seen.clear()
        call(pkg, _args(base))
        out.append({str(pathlib.Path(k).relative_to(base)): v
                    for k, v in seen.items()})
    return out


def test_show_metrics_matches_jax(recorded, tmp_path):
    rng = np.random.default_rng(0)
    values = {"QIDDM_LL_noise=6_L=14_N=2#0": list(rng.uniform(size=6)),
              "QNN_noise=8_L=14#1": list(rng.uniform(size=6))}
    for kw in ({}, {"is_loss": True, "model_name": "QIDDM_LL_noise",
                    "model_params": ["784", "6", "14", "2"]},
               {"model_name": "noise2", "model_params": ["ssim"],
                "xlabel": "Amplitude Damping intensity",
                "x_values": [0.1, 0.2, 0.3, 0.5, 0.8, 0.9]}):
        want, got = _both(recorded, tmp_path, lambda pkg, args: (
            pkg.show_metrics(values, "SSIM", args, **kw)))
        assert got == want and len(got) == 1


def test_dict_metrics_plot_as_jax(recorded, tmp_path):
    rng = np.random.default_rng(1)
    gen = {f"m{i}": rng.uniform(size=(4, 3, 1, 8, 8)) for i in range(2)}
    real = {k: rng.uniform(size=(5, 1, 8, 8)) for k in gen}
    for name in ("get_ssim", "get_psnr", "get_cosine_similarity",
                 "get_fid"):
        want, got = _both(recorded, tmp_path, lambda pkg, args: getattr(
            pkg, name)(gen, real, args, gen_img_count=2, real_img_count=3))
        assert list(got) == list(want) and len(got) == 1, name
        for k in want:
            g, w = got[k][0], want[k][0]
            for (gl, gx, gy, *grest), (wl, wx, wy, *wrest) in zip(
                    g.pop("lines"), w.pop("lines")):
                assert (gl, gx, grest) == (wl, wx, wrest)
                np.testing.assert_allclose(gy, wy, rtol=1e-5, atol=1e-4)
            assert g == w, name


def test_show_histogram_matches_jax(recorded, tmp_path):
    scores = {"QIDDM_LL_noise": [0.3, 0.5, 0.4],
              "differN_noise": [0.2, 0.6, 0.1]}
    for kw in ({}, {"model_name": "differN_noise", "model_params": [28, 9]}):
        want, got = _both(recorded, tmp_path, lambda pkg, args: (
            pkg.show_histogram(scores, "SSIM", args, **kw)))
        assert got == want and len(got) == 1


def test_show_images_matches_jax(recorded, tmp_path):
    imgs = np.random.default_rng(2).uniform(size=(3, 64))
    for n in (1, 3):
        want, got = _both(recorded, tmp_path, lambda pkg, args: (
            pkg.show_images(imgs, num_images=n, save_path=pathlib.Path(
                args.save_path) / "row.png")))
        assert got == want and list(got) == ["row.png"]
    tmetrics.show_images(torch.as_tensor(imgs), num_images=2,
                         save_path=tmp_path / "t.png")


def test_dump_images_matches_jax(recorded, tmp_path):
    rng = np.random.default_rng(3)
    x_train = rng.uniform(size=(5, 64))
    gen = rng.uniform(size=(4, 3, 1, 8, 8))
    grid = rng.uniform(size=(32, 24)) * 255

    class _Diff:
        def save_name(self):
            return "QIDDM_LL_noise=3_L=2_N=2"

    out = []
    for name, pkg in (("jax", jcommon), ("port", tcommon)):
        recorded.clear()
        args = _args(tmp_path / name, label=4)
        pkg._dump_images(args, x_train, gen, grid, _Diff())
        out.append({str(pathlib.Path(k).relative_to(tmp_path / name)): v
                    for k, v in recorded.items()})
    want, got = out
    assert got == want
    assert len(got) == 5 + 3 * 4 + 1
    assert "QIDDM_LL_noise=3_L=2_N=2_4.png" in got


def _driver(tmp_path, *extra):
    return ["--data", "mnist_8x8", "--img_size", "8", "--model",
            "QIDDM_LL_noise", "64", "3", "1", "1", "--ds-size", "60",
            "--epochs", "1", "--batch_size", "4", "--tau", "2",
            "--device", "cpu", "--save-path", f"{tmp_path}/run_",
            "--load-path", f"{tmp_path}/run_", *extra]


def test_the_driver_plots_and_dumps_where_matplotlib_imports(
        recorded, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    tcommon.run_labels(tmnist.parse_args(_driver(tmp_path)), labels=[1],
                       tau_test=3)
    base = tmp_path / "run_1" / "noise_0"
    names = {str(pathlib.Path(k).relative_to(base)) for k in recorded}
    stem = "QIDDM_LL_noise=3_L=1_N=1"
    assert {f"LOSS_QIDDM_LL_noise_64_3_1_1_1.png",
            f"SSIM_{stem}#0_1.png", f"PSNR_{stem}#0_1.png",
            f"Cosine Similarity_{stem}#0_1.png", f"{stem}_1.png",
            "image_1/step_4.png", "image_0/train_image_1.png"} <= names
    loss = recorded[str(base / "LOSS_QIDDM_LL_noise_64_3_1_1_1.png")][0]
    assert loss["xlabel"] == "Epochs" and len(loss["lines"][0][2]) == 1
    assert "skipped" not in capsys.readouterr().out


def test_without_matplotlib_the_driver_says_so_in_one_line(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmetrics, "plots_available", lambda: False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tcommon.run_labels(tmnist.parse_args(_driver(tmp_path)), labels=[1],
                       tau_test=3)
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if "matplotlib cannot" in l]
    assert lines == [
        tmetrics.NO_PLOTS.format(what="the PNG dumps"),
        tmetrics.NO_PLOTS.format(
            what="the loss/SSIM/PSNR/cosine plots and histograms")]
    assert not list(tmp_path.rglob("*.png"))
    with pytest.raises(ImportError):
        tmetrics.show_metrics({"a": [1.0]}, "SSIM", None)
