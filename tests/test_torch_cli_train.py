"""The port's training driver (qiddm_tpu_torch.cli.mnist_exm) and what it
stands on — data loaders, checkpoints, the Diffusion constructor — against
qiddm_tpu on the CPU, at QIDDM_LL_noise(64, 3, 2, 2) on 8x8 digits.

Tolerances: loaders and the shared checkpoint are compared exactly; the
JAX model's images from the port's checkpoint, and sampled images, agree
with the port's to <= 1e-4 (a 3 -> 64 linear over two blocks of 4 gate
layers in float32, through independent formulations of the circuit).
"""

import json
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
    tnet = QIDDM_LL_noise(64, 3, 2, 2, device="cpu")
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
    assert set(tdata.ALL_LOADERS) == set(jdata.ALL_LOADERS)


def _hide_disk_data(monkeypatch, tmp_path):
    """No idx files under HOME and an empty data directory, for both
    packages."""
    monkeypatch.setenv("HOME", str(tmp_path))
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "DATA_DIR", tmp_path / "data")


def test_fashion_28x28_matches_jax(tmp_path, monkeypatch):
    """The noise driver's dataset: the synthetic textures when nothing is
    on disk, then ``fashion_28.npz`` from the data directory, equal to the
    JAX package's in both cases."""
    _hide_disk_data(monkeypatch, tmp_path)
    with pytest.warns(UserWarning, match="synthetic textures"):
        got = tdata.fashion_28x28(ds_size=30)
    with pytest.warns(UserWarning, match="synthetic textures"):
        want = jdata.fashion_28x28(ds_size=30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    (tmp_path / "data").mkdir()
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "data" / "fashion_28.npz",
             x=rng.integers(0, 256, size=(50, 28, 28), dtype=np.uint8),
             y=np.arange(50) % 10)
    got = tdata.fashion_28x28(n_classes=4, ds_size=30)
    want = jdata.fashion_28x28(n_classes=4, ds_size=30)
    assert got[0].shape == (20, 784)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


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
    tdiff = TDiffusion(QIDDM_LL_noise(64, 3, 2, 2, seed=9, device="cpu"),
                       shape=(8, 8))
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

    def spy(diff, path, label, losses, epochs, **kw):
        saved.append((epochs, list(losses)))
        return real_save(diff, path, label, losses, epochs, **kw)

    monkeypatch.setattr(tcommon, "save_diffusion", spy)
    tmnist.main(_driver_args(tmp, "--checkpoint-every", "1"))
    assert [e for e, _ in saved] == [1, 2]
    assert len(saved[0][1]) == 1 and len(saved[1][1]) == 2


@pytest.mark.parametrize("extra", [
    ["--ckpt-backend", "orbax"],
    # a noisy model (add_noise=1) under the trajectory backend: ported, so
    # the flag passes validation (as do the two other traj cases)
    ["--model", "QNN_noise", "784", "8", "14", "1", "--noise-backend",
     "traj"],
    ["--vmap-labels"],
    ["--profile", "trace"],
    ["--noise-backend", "traj"],
    ["--add_noise", "1", "--noise-backend", "traj"],
    ["--data", "no_such_dataset"],
], ids=["orbax", "QNN_noise", "vmap", "profile", "traj", "add_noise",
        "dataset"])
def test_unported_runs_are_rejected_before_any_work(driver_env, monkeypatch,
                                                    extra):
    """The unported flag is rejected before any data is loaded; so is an
    unknown dataset (every JAX loader is ported). ``--profile`` is ported:
    a CPU run writes a torch.profiler trace of its training. So is
    ``--ckpt-backend orbax``: a CPU run checkpoints as a DCP directory
    (tests/test_torch_dcp.py holds it against the pt backend)."""
    if extra[0] == "--ckpt-backend":
        tmnist.main(_driver_args(driver_env, "--epochs", "1", *extra))
        dcps = list(driver_env.rglob("*.dcp"))
        assert len(dcps) == 1 and dcps[0].is_dir()
        assert pathlib.Path(str(dcps[0]) + ".meta.json").is_file()
        assert not list(driver_env.rglob("*.pt"))
        return
    if extra[0] == "--profile":
        tmnist.main(_driver_args(driver_env, "--epochs", "1",
                                 "--profile", str(driver_env / "trace")))
        traces = list((driver_env / "trace").glob("trace_*.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any(e.get("name") == "aten::backward" or "Backward" in
                   e.get("name", "") for e in events)
        return

    def no_data(args):
        raise AssertionError("data loaded before the run was rejected")

    monkeypatch.setattr(tcommon, "load_dataset", no_data)
    argv = _driver_args(driver_env)
    if extra[0] == "--model":  # replaces the one model instead of adding
        i = argv.index("--model")
        argv = argv[:i] + argv[i + 1 + len(MODEL):]
    if "traj" in extra:
        args = tmnist.parse_args(argv + extra)
        tcommon.validate_args(args)
        assert args.noise_backend == "traj" and args.n_traj == 100
        return
    match = "unknown dataset" if extra[0] == "--data" else "not ported"
    with pytest.raises(SystemExit, match=match):
        tmnist.main(argv + extra)
    assert not list(driver_env.rglob("*.pt"))


def test_noise_flags_and_noisy_models_pass_validation(driver_env):
    """--add_noise and --noise_intensity are read by no JAX driver and
    pass, as a model's own add_noise does, and so does the trajectory
    backend (above)."""
    args = tmnist.parse_args(["--add_noise", "2", "--device", "cpu",
                              "--model", "QNN_noise", "784", "8", "14", "1",
                              "--model", "QIDDM_PL_noise1", "784", "8", "6",
                              "2", "4"])
    tcommon.validate_args(args)


def test_default_models_name_an_unported_one():
    """The default model list and flags are the JAX mnist_exm's; both default
    models are ported now, so the defaults pass validation on the CPU, and
    each model keeps its own default learning rate."""
    args = tmnist.parse_args([])
    assert [m[0] for m in args.model] == ["QIDDM_LL_noise", "QNN_noise"]
    assert args.device == "cuda" and args.batch_size == 1
    assert args.tau == 10 and args.ds_size == 500 and args.epochs == 50
    assert tcommon.model_lr(args, "QIDDM_LL_noise") == 0.0255
    assert tcommon.model_lr(args, "QNN_noise") == 0.01011
    args.device = "cpu"
    tcommon.validate_args(args)


def test_mnist_exm_without_model_trains_both_default_models(
        driver_env, monkeypatch):
    """No --model: QIDDM_LL_noise(784, 6, 14, 2) and QNN_noise(784, 8, 14)
    train in turn on a seeded 28x28 set, each at its own rate, and each
    writes its own checkpoint."""
    tmp = driver_env
    _hide_disk_data(monkeypatch, tmp)
    rng = np.random.default_rng(5)
    (tmp / "data").mkdir()
    np.savez(tmp / "data" / "mnist_28.npz",
             x=rng.integers(0, 256, size=(40, 28, 28), dtype=np.uint8),
             y=np.arange(40) % 10)
    rates = []
    real_train = tcommon.train_diffusion_scan

    def spy(diff, x, **kw):
        rates.append((diff.net.save_name(), kw["lr"]))
        return real_train(diff, x, **kw)

    monkeypatch.setattr(tcommon, "train_diffusion_scan", spy)
    out = tmnist.main(["--ds-size", "20", "--epochs", "1", "--device", "cpu",
                       "--save-path", f"{tmp}/run_",
                       "--load-path", f"{tmp}/run_"])
    assert set(out) == {"QIDDM_LL_noise", "QNN_noise"}
    for entry in out.values():
        assert len(entry["loss"][0]) == 1 and np.isfinite(entry["loss"][0])
        assert entry["generated"][0].shape == (16, 10, 1, 28, 28)
    assert rates == [("QIDDM_LL_noise=6_L=14_N=2", 0.0255),
                     ("QNN_linear_features=8_qdepth=14_add_noise=0", 0.01011)]
    ckpt_dir = tmp / "run_4" / "noise_0"
    assert sorted(p.name for p in ckpt_dir.glob("*.pt")) == [
        "QIDDM_LL_noise=6_L=14_N=2_4.pt",
        "QNN_linear_features=8_qdepth=14_add_noise=0_4.pt"]
    jdiff = JDiffusion(jnn.QNN_noise(784, 8, 14, seed=2))
    assert jckpt.load_diffusion(jdiff, ckpt_dir, 4)[1] == 1


def test_cuda_without_a_card_raises_before_training(driver_env):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-fallback check needs a "
                    "host without it")
    argv = _driver_args(driver_env)
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        tmnist.main(argv)
    assert not list(driver_env.rglob("*.pt"))


def test_build_model_defaults_to_the_card():
    """``build_model`` is the library entry: without a device it builds on
    the card, and on a host without CUDA it raises rather than fall back to
    the CPU; ``device="cpu"`` builds there."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-fallback check needs a "
                    "host without it")
    margs = ["QIDDM_LL_noise", "64", "3", "2", "2"]
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        tcommon.build_model(margs)
    net = tcommon.build_model(margs, seed=1, device="cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}


def test_cpu_runs_pass_the_option_check_on_the_cpu(monkeypatch):
    """The option check builds every model before the device is resolved,
    and builds it on the CPU: a ``--device cpu`` run passes it on a host
    without CUDA."""
    devices = []
    real = tcommon.build_model

    def spy(margs, seed=0, device="cuda"):
        devices.append(device)
        return real(margs, seed=seed, device=device)

    monkeypatch.setattr(tcommon, "build_model", spy)
    args = tmnist.parse_args(["--device", "cpu", "--model", "QIDDM_LL_noise",
                              "784", "16", "14", "2", "--model", "QNN_noise",
                              "784", "8", "14"])
    tcommon.validate_args(args)
    assert devices == ["cpu", "cpu"]


def test_make_first_x_is_seeded_and_scaled():
    args = tmnist.parse_args(["--img_size", "8", "--seed", "3"])
    a, b = tcommon.make_first_x(args), tcommon.make_first_x(args)
    assert a.shape == (10, 1, 8, 8) and torch.equal(a, b)
    assert 0.5 <= a.min() and a.max() < 1.25
