"""The learning-rate sweep (qiddm_tpu_torch/sweep.py) and its drivers
(``cli.mnist_ray``, ``cli.fashion_ray``) against qiddm_tpu's on the CPU.

The JAX package trains a group's trials in one vmapped program from
``jax.random`` keys; the port trains them one after another from torch
generators, so the two sweeps' weights differ by construction. What is
held: the rung schedule (``asha_rungs``, ``_rung_plan``) on a grid of
epochs; the halving, given the same scores, stopping the same trials at
the same epochs with the same artifacts (files, JSON keys and values but
the measured ones); the selection score ``_score_ssim`` from the same
weights and start images, within 1e-4 (JAX scores in float32, the port in
float64); and, within the port, each trial equal to the same trial trained
alone, bit for bit.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from qiddm_tpu import nn as jnn
from qiddm_tpu import sweep as jsweep
from qiddm_tpu.cli import mnist_ray as jray
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import data as tdata
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch import sweep as tsweep
from qiddm_tpu_torch.cli import common as tcommon
from qiddm_tpu_torch.cli import fashion_ray, mnist_ray
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion

SSIM_TOL = 1e-4
ARGS = (64, 2, 1, 1)  # QIDDM_LL_noise on 8x8 images: 2 wires, 1 layer


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread per test process: a thread pool in each oversubscribes
    the cores beside the other workers. One thread gives the same
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, 64)) ** 2


def test_rung_schedule_matches_jax():
    for epochs in range(0, 70):
        assert tsweep.asha_rungs(epochs) == jsweep.asha_rungs(epochs)
        assert (tsweep.asha_rungs(epochs, 2, 3)
                == jsweep.asha_rungs(epochs, 2, 3))
        for rungs in (None, [], tsweep.asha_rungs(epochs), [0.5],
                      [0.5, 0.25], [(3, 0.5), (2, 0.5), (epochs, 0.25)]):
            assert (tsweep._rung_plan(epochs, rungs)
                    == jsweep._rung_plan(epochs, rungs)), (epochs, rungs)


def _fake_scores(calls):
    """A ``_score_ssim`` that returns the given arrays in turn."""
    it = iter(calls)
    return lambda *args, **kwargs: np.asarray(next(it), np.float32)


def _artifacts(root: pathlib.Path) -> dict:
    """{trial dir: (file names with the checkpoint's numbers cut,
    params.json, result.json without its measured values, progress.csv
    epochs)}."""
    out = {}
    for td in sorted(p for p in root.iterdir() if p.is_dir()):
        names = sorted(n.name if not n.name.endswith(".pt")
                       else n.name.rsplit("_", 2)[0] + ".pt"
                       for n in td.iterdir())
        params = json.loads((td / "params.json").read_text())
        rec = json.loads((td / "result.json").read_text())
        measured = {k: rec.pop(k) for k in ("loss", "ssim",
                                            "time_total_s")}
        assert all(np.isfinite(v) for v in measured.values())
        lines = (td / "progress.csv").read_text().splitlines()
        epochs = [int(line.split(",")[0]) for line in lines[1:]]
        out[td.name] = (names, params, rec, lines[0], epochs)
    return out


def test_halving_and_artifacts_match_jax(tmp_path, monkeypatch):
    """Four trials, 2 epochs of one batch, AsyncHyperBand's rungs (one, at
    epoch 1, keeping a quarter): from the same injected scores both
    packages keep trial 1, stop the other three at epoch 1, and write the
    same layout."""
    lrs = [0.01, 0.02, 0.03, 0.04]
    scores = [[0.1, 0.9, 0.5, 0.3], [0.7]]
    x = _images(6)
    common = dict(shape=(8, 8), epochs=2, batch_size=6, T=2, seed=3,
                  rungs=jsweep.asha_rungs(2), exp_name="g")
    monkeypatch.setattr(jsweep, "_score_ssim", _fake_scores(scores))
    want = jsweep.sweep_lr(lambda s: jnn.QIDDM_LL_noise(*ARGS, 0, seed=s),
                           lrs, x, local_dir=str(tmp_path / "jax"), **common)
    monkeypatch.setattr(tsweep, "_score_ssim", _fake_scores(scores))
    got = tsweep.sweep_lr(
        lambda s: tnn.QIDDM_LL_noise(*ARGS, 0, seed=s, device="cpu"), lrs, x,
        local_dir=str(tmp_path / "port"), **common)
    np.testing.assert_array_equal(got.ssim, want.ssim)
    np.testing.assert_array_equal(
        got.ssim, np.float32([0.1, 0.7, 0.5, 0.3]))
    assert got.best_by_ssim == want.best_by_ssim == 1
    assert got.lrs == want.lrs
    assert got.loss_curves.shape == want.loss_curves.shape == (4, 2)
    np.testing.assert_array_equal(got.loss_curves == 0,
                                  want.loss_curves == 0)
    assert (got.loss_curves[[0, 2, 3], 1:] == 0).all()
    for res in (got, want):  # a stopped trial's loss is its last epoch's
        np.testing.assert_array_equal(res.final_loss[[0, 2, 3]],
                                      res.loss_curves[[0, 2, 3], 0])
        assert res.final_loss[1] == res.loss_curves[1, 1]
    mine = _artifacts(tmp_path / "port" / "g")
    assert mine == _artifacts(tmp_path / "jax" / "g")
    assert [v[2]["early_stopped"] for v in mine.values()] == [
        True, False, True, True]
    assert mine["trial_00001_lr=0.02000"][0] == [
        "QIDDM_LL_noise=2_L=1_N=1.pt", "params.json", "progress.csv",
        "result.json"]
    assert [p.name for p in map(pathlib.Path, got.trial_dirs)] == list(mine)


def test_a_single_trial_is_never_culled(tmp_path, monkeypatch):
    calls = []

    def score(diffs, *args):
        calls.append(len(diffs))
        return np.zeros(len(diffs), np.float32)

    monkeypatch.setattr(tsweep, "_score_ssim", score)
    res = tsweep.sweep_lr(
        lambda s: tnn.QIDDM_LL_noise(*ARGS, 0, seed=s, device="cpu"), [0.01],
        _images(4), shape=(8, 8), epochs=5, batch_size=2, T=2,
        rungs=tsweep.asha_rungs(5))
    assert calls == [1]  # one segment, scored once
    assert (res.loss_curves != 0).all()


def test_score_ssim_matches_jax():
    """Two trials' weights carried from the JAX nets, the same 15 start
    images: the sampled first image's SSIM against the first real image."""
    jnets = [jnn.QIDDM_LL_noise(*ARGS, 0, seed=s) for s in (1, 2)]
    tnets = []
    for jnet in jnets:
        tnet = tnn.QIDDM_LL_noise(*ARGS, 0, device="cpu")
        tckpt.load_jax_variables(
            tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
        tnets.append(tnet)
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a),
                                     *[j.variables for j in jnets])
    rng = np.random.default_rng(9)
    first_x = (rng.uniform(size=(15, 1, 8, 8)) * 0.75 + 0.5).astype(
        np.float32)
    real = rng.uniform(size=(20, 64))
    jdiff = JDiffusion(jnets[0], shape=(8, 8))
    want = jsweep._score_ssim(jdiff, jnets[0].module, stacked["params"],
                              {k: v for k, v in stacked.items()
                               if k != "params"},
                              first_x, 5, real, None, (8, 8))
    got = tsweep._score_ssim([TDiffusion(n, shape=(8, 8)) for n in tnets],
                             torch.as_tensor(first_x), 5, real, None, (8, 8))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, atol=SSIM_TOL)


def test_each_trial_equals_that_trial_trained_alone(tmp_path):
    """Three trials, 2 epochs, halving at epoch 1 to half: every trial's
    losses, and the survivors' checkpointed weights, are those of the
    trial trained alone from ``make_net(seed + t)``, Adam at its rate and
    its generator, carried across its segments."""
    lrs, seed, x = [0.05, 0.01, 0.03], 7, _images(5)

    def make_net(s):
        return tnn.QIDDM_LL_noise(*ARGS, 0, seed=s, device="cpu")

    res = tsweep.sweep_lr(make_net, lrs, x, shape=(8, 8), epochs=2,
                          batch_size=2, T=2, seed=seed, rungs=[(1, 0.5)],
                          local_dir=str(tmp_path), exp_name="g")
    kept = [t for t in range(3) if res.loss_curves[t, 1] != 0]
    assert len(kept) == 2
    xt = torch.as_tensor(x, dtype=torch.float32)
    for t, lr in enumerate(lrs):
        net = make_net(seed + t)
        diff = TDiffusion(net, shape=(8, 8))
        opt = torch.optim.Adam(diff.parameters(), lr=lr)
        gen = tsweep.trial_generator(seed, t)
        losses = [diff.make_multi_epoch_fn(opt, 2, 2, 1)(gen, xt, 5)
                  for _ in range(2 if t in kept else 1)]
        np.testing.assert_array_equal(
            res.loss_curves[t, :len(losses)],
            torch.cat(losses).numpy().astype(np.float32))
        ckpts = list((tmp_path / "g").glob(f"trial_{t:05d}_*/*.pt"))
        assert len(ckpts) == (1 if t in kept else 0)
        if ckpts:
            saved = tckpt.load_checkpoint(ckpts[0])["model_state_dict"]
            want = tckpt.export_jax_variables(net)
            jax.tree_util.tree_map(np.testing.assert_array_equal, saved,
                                   want)


def test_mesh_and_orbax_are_not_ported(tmp_path):
    """The mesh is still item 11's and raises before any work; so does an
    unknown checkpoint backend. The orbax backend is ported: each finished
    trial's checkpoint is a DCP directory holding what the pt backend's
    holds (tests/test_torch_dcp.py holds the rest)."""
    kw = dict(shape=(8, 8), epochs=1, batch_size=2, T=2)

    def refuse(s):
        raise AssertionError("a net was built before the refusal")

    with pytest.raises(NotImplementedError, match="item 11"):
        tsweep.sweep_lr(refuse, [0.01], _images(2), mesh=object(), **kw)
    with pytest.raises(ValueError, match="backend"):
        tsweep.sweep_lr(refuse, [0.01], _images(2), ckpt_backend="zarr",
                        **kw)

    def make_net(s):
        return tnn.QIDDM_LL_noise(*ARGS, 0, seed=s, device="cpu")

    for backend in ("orbax", "pt"):
        tsweep.sweep_lr(make_net, [0.01], _images(4), ckpt_backend=backend,
                        local_dir=str(tmp_path), exp_name=backend, **kw)
    (dcp,) = (tmp_path / "orbax").rglob("*.dcp")
    (pt,) = (tmp_path / "pt").rglob("*.pt")
    assert dcp.name[:-len(".dcp")] == pt.name[:-len(".pt")]
    got = tckpt.load_dcp(dcp, like=tckpt.export_jax_variables(make_net(0)))
    want = tckpt.load_checkpoint(pt)
    assert got["meta"] == {"loss_values": want["loss_values"],
                           "epochs": want["epochs"]}
    jax.tree_util.tree_map(np.testing.assert_array_equal, got["variables"],
                           want["model_state_dict"])


def test_sweep_drivers_keep_the_jax_drivers_flags():
    got, want = vars(mnist_ray.parse_args([])), vars(jray.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    assert vars(fashion_ray.parse_args([])) == vars(mnist_ray.parse_args([]))


@pytest.fixture
def ray_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(tdata, "DATA_DIR", tmp_path / "data")
    return tmp_path


@pytest.mark.parametrize("driver", [mnist_ray, fashion_ray],
                         ids=["mnist_ray", "fashion_ray"])
def test_sweep_driver_runs_on_the_cpu(ray_env, driver):
    """Two groups (L 1 and 2) of 5 trials, 2 epochs with the default
    halving: one row a trial, the best by SSIM, the tune_results layout,
    and in each group of more than one trial all but a quarter stopped at
    epoch 1."""
    argv = ["--ds-size", "150", "--num-samples", "5", "--epochs", "2",
            "--batch_size", "8", "--tau", "2", "--hidden", "2", "--N", "1",
            "--L-min", "1", "--L-max", "2", "--device", "cpu", "--local-dir",
            str(ray_env / "tr")]
    if driver is mnist_ray:  # sklearn's digits; fashion's textures at 28
        argv = ["--data", "mnist_8x8", "--img_size", "8", *argv]
    rows, best = driver.main(argv)
    assert len(rows) == 5 and best["ssim"] == max(r["ssim"] for r in rows)
    exp = "train_mnist28" if driver is mnist_ray else "train_fmnist28"
    for L in sorted({r["L"] for r in rows}):
        group = [r for r in rows if r["L"] == L]
        dirs = sorted((ray_env / "tr" / f"{exp}_L{L}").iterdir())
        assert len(dirs) == len(group)
        stopped = [json.loads((d / "result.json").read_text())[
            "early_stopped"] for d in dirs]
        keep = len(group) if len(group) == 1 else -(-len(group) // 4)
        assert stopped.count(False) == keep
        assert len(list((ray_env / "tr").glob(f"{exp}_L{L}/*/*.pt"))) == keep


@pytest.mark.parametrize("driver", [mnist_ray, fashion_ray],
                         ids=["mnist_ray", "fashion_ray"])
def test_sweep_driver_without_a_card_raises_before_loading_data(
        monkeypatch, driver):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-fallback check needs a "
                    "host without it")

    def no_data(args):
        raise AssertionError("data loaded before the device was resolved")

    monkeypatch.setattr(tcommon, "load_dataset", no_data)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        driver.main([])
    with pytest.raises(SystemExit, match="unknown dataset"):
        driver.main(["--data", "no_such_set", "--device", "cpu"])
