"""The port's training driver (qiddm_tpu_torch.cli.mnist_exm) and what it
stands on — data loaders, checkpoints, the Diffusion constructor — against
qiddm_tpu on the CPU, at QIDDM_LL_noise(64, 3, 2, 2) on 8x8 digits.

Tolerances: loaders and the shared checkpoint are compared exactly; the
JAX model's images from the port's checkpoint, and sampled images, agree
with the port's to <= 1e-4 (a 3 -> 64 linear over two blocks of 4 gate
layers in float32, through independent formulations of the circuit).
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import ckpt as jckpt
from qiddm_tpu import data as jdata
from qiddm_tpu import nn as jnn
from qiddm_tpu import noise as jnoise
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import data as tdata
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch.cli import common as tcommon
from qiddm_tpu_torch.cli import mnist_exm as tmnist
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.nn import QIDDM_LL_noise

TOL = 1e-4
MODEL = ["QIDDM_LL_noise", "64", "3", "2", "2"]


def test_diffusion_positional_arguments_match_jax():
    """Diffusion(net, noise_f, prediction_goal, shape, loss) and
    sample(n_iters, first_x, labels, show_progress, only_last) mean the
    same in both packages."""
    jnet = jnn.QIDDM_LL_noise(64, 3, 2, 2, seed=1)
    tnet = QIDDM_LL_noise(64, 3, 2, 2)
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    jd = JDiffusion(jnet, jnoise.add_normal_noise_multiple, "noise", (8, 6),
                    "l1")
    td = TDiffusion(tnet, tnoise.add_normal_noise_multiple, "noise", (8, 6),
                    "l1")
    for attr in ("prediction_goal", "width", "height", "loss"):
        assert getattr(td, attr) == getattr(jd, attr), attr
    assert td.save_name() == jd.save_name() == "QIDDM_LL_noise=3_L=2_N=2_noise"
    assert td.add_noise is tnoise.add_normal_noise_multiple
    first = np.random.default_rng(0).uniform(size=(2, 1, 8, 8)).astype(
        np.float32)
    jd, td = JDiffusion(jnet), TDiffusion(tnet)
    want = np.asarray(jd.eval().sample(2, jnp.asarray(first), None, False,
                                       True))
    got = td.eval().sample(2, torch.as_tensor(first), None, False, True)
    assert got.shape == want.shape == (2, 1, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_mnist_8x8_and_digits_fallback_match_jax():
    for got, want in zip(tdata.mnist_8x8(n_classes=5, ds_size=40),
                         jdata.mnist_8x8(n_classes=5, ds_size=40)):
        np.testing.assert_array_equal(got, want)
    with pytest.warns(UserWarning, match="sklearn digits"):
        got = tdata._digits_fallback(28, "mnist")
    with pytest.warns(UserWarning, match="sklearn digits"):
        want = jdata._digits_fallback(28, "mnist")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(tdata.ALL_LOADERS) == {"mnist_8x8", "mnist_28x28"}


def _hide_disk_data(monkeypatch, tmp_path):
    """No idx files under HOME and an empty data directory, for both
    packages."""
    monkeypatch.setenv("HOME", str(tmp_path))
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "DATA_DIR", tmp_path / "data")


def test_mnist_28x28_reads_the_npz_cache_like_jax(tmp_path, monkeypatch):
    _hide_disk_data(monkeypatch, tmp_path)
    rng = np.random.default_rng(2)
    (tmp_path / "data").mkdir()
    np.savez(tmp_path / "data" / "mnist_28.npz",
             x=rng.integers(0, 256, size=(30, 28, 28), dtype=np.uint8),
             y=np.arange(30) % 10)
    monkeypatch.setitem(sys.modules, "sklearn", None)  # not needed here
    got = tdata.mnist_28x28(n_classes=4, ds_size=9)
    monkeypatch.delitem(sys.modules, "sklearn")
    want = jdata.mnist_28x28(n_classes=4, ds_size=9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_missing_dataset_without_sklearn_names_the_npz(tmp_path,
                                                       monkeypatch):
    _hide_disk_data(monkeypatch, tmp_path)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    want = str(tmp_path / "data" / "mnist_28.npz")
    with pytest.raises(RuntimeError, match="sklearn") as err:
        tdata.mnist_28x28()
    assert want in str(err.value)


def _driver_args(tmp_path, *extra):
    return ["--data", "mnist_8x8", "--img_size", "8", "--model", *MODEL,
            "--ds-size", "60", "--epochs", "2", "--batch_size", "2",
            "--tau", "3", "--device", "cpu",
            "--save-path", f"{tmp_path}/run_",
            "--load-path", f"{tmp_path}/run_", *extra]


@pytest.fixture
def driver_env(tmp_path, monkeypatch):
    """Run mnist_exm in tmp_path; its tee loggers are undone afterwards."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    return tmp_path


def test_mnist_exm_on_cpu_writes_a_checkpoint_jax_reads_and_resumes(
        driver_env, capsys):
    tmp = driver_env
    out = tmnist.main(_driver_args(tmp))
    losses = out["QIDDM_LL_noise"]["loss"][0]
    assert len(losses) == 2 and np.isfinite(losses).all()
    gen = out["QIDDM_LL_noise"]["generated"][0]
    assert gen.shape == (16, 10, 1, 8, 8) and np.isfinite(gen).all()
    assert list(tmp.glob("Logs/log-*.log"))
    ckpt_dir = tmp / "run_4" / "noise_0"
    assert (ckpt_dir / "QIDDM_LL_noise=3_L=2_N=2_4.pt").exists()

    # the JAX package reads the port's checkpoint and computes the same
    jdiff = JDiffusion(jnn.QIDDM_LL_noise(64, 3, 2, 2, seed=9), shape=(8, 8))
    jlosses, jepochs = jckpt.load_diffusion(jdiff, ckpt_dir, 4)
    assert jepochs == 2 and np.allclose(jlosses, losses)
    tdiff = TDiffusion(QIDDM_LL_noise(64, 3, 2, 2, seed=9), shape=(8, 8))
    assert tckpt.load_diffusion(tdiff, ckpt_dir, 4) == (jlosses, 2)
    img = np.random.default_rng(3).uniform(size=(5, 1, 8, 8)).astype(
        np.float32)
    with torch.no_grad():
        got = tdiff.net(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdiff.net(img)), atol=TOL)

    # a rerun with more epochs resumes at the checkpoint's epoch
    capsys.readouterr()
    out = tmnist.main(_driver_args(tmp, "--epochs", "3"))
    assert "epoch start from 2, left 1" in capsys.readouterr().out
    resumed = out["QIDDM_LL_noise"]["loss"][0]
    assert len(resumed) == 3 and resumed[:2] == losses
    assert tckpt.load_checkpoint(
        ckpt_dir / "QIDDM_LL_noise=3_L=2_N=2_4.pt")["epochs"] == 3


def test_checkpoint_every_saves_each_segment(driver_env, monkeypatch):
    tmp = driver_env
    saved = []
    real_save = tcommon.save_diffusion

    def spy(diff, path, label, losses, epochs):
        saved.append((epochs, list(losses)))
        return real_save(diff, path, label, losses, epochs)

    monkeypatch.setattr(tcommon, "save_diffusion", spy)
    tmnist.main(_driver_args(tmp, "--checkpoint-every", "1"))
    assert [e for e, _ in saved] == [1, 2]
    assert len(saved[0][1]) == 1 and len(saved[1][1]) == 2


@pytest.mark.parametrize("extra", [
    ["--ckpt-backend", "orbax"],
    ["--model", "QNN_noise", "784", "8", "14"],
    ["--vmap-labels"],
    ["--profile", "trace"],
    ["--noise-backend", "traj"],
    ["--add_noise", "1"],
    ["--data", "fashion_28x28"],
], ids=["orbax", "QNN_noise", "vmap", "profile", "traj", "add_noise",
        "dataset"])
def test_unported_runs_are_rejected_before_any_work(driver_env, monkeypatch,
                                                    extra):
    def no_data(args):
        raise AssertionError("data loaded before the run was rejected")

    monkeypatch.setattr(tcommon, "load_dataset", no_data)
    argv = _driver_args(driver_env)
    if extra[0] == "--model":  # replaces the one model instead of adding
        i = argv.index("--model")
        argv = argv[:i] + argv[i + 1 + len(MODEL):]
    with pytest.raises(SystemExit, match="not ported"):
        tmnist.main(argv + extra)
    assert not list(driver_env.rglob("*.pt"))


def test_default_models_name_an_unported_one():
    args = tmnist.parse_args([])
    assert [m[0] for m in args.model] == ["QIDDM_LL_noise", "QNN_noise"]
    assert args.device == "cuda" and args.batch_size == 1
    assert args.tau == 10 and args.ds_size == 500 and args.epochs == 50
    assert tcommon.model_lr(args, "QIDDM_LL_noise") == 0.0255
    args.device = "cpu"
    with pytest.raises(SystemExit, match="QNN_noise"):
        tcommon.validate_args(args)


def test_cuda_without_a_card_raises_before_training(driver_env):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-fallback check needs a "
                    "host without it")
    argv = _driver_args(driver_env)
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        tmnist.main(argv)
    assert not list(driver_env.rglob("*.pt"))


def test_make_first_x_is_seeded_and_scaled():
    args = tmnist.parse_args(["--img_size", "8", "--seed", "3"])
    a, b = tcommon.make_first_x(args), tcommon.make_first_x(args)
    assert a.shape == (10, 1, 8, 8) and torch.equal(a, b)
    assert 0.5 <= a.min() and a.max() < 1.25
