"""The port's counterpart of the orbax backend, a
``torch.distributed.checkpoint`` (DCP) directory, through the drivers and
the sweep on the CPU: the four cases of ``tests/test_orbax_driver.py``, each
held against the port's own ``pt`` backend bit for bit, and the loader's
rules (``.dcp`` before ``.pt``, a lone JAX ``.orbax`` refused, the sampling
CLI reading a ``.dcp``).
"""

import json
import pathlib
import threading

import numpy as np
import pytest
import torch

from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch.cli import common as tcommon
from qiddm_tpu_torch.cli import mnist_exm as tmnist
from qiddm_tpu_torch.cli import sample as tsample
from qiddm_tpu_torch.diffusion import Diffusion
from qiddm_tpu_torch.sweep import sweep_lr

MODEL = ["QIDDM_LL_noise", "64", "3", "1", "1"]


@pytest.fixture(autouse=True)
def _no_plots(monkeypatch):
    """The drivers' plots are tests/test_torch_plots.py's; here they would
    only cost time."""
    monkeypatch.setattr(tcommon.metrics, "plots_available", lambda: False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small float32 ops by the thousand: a thread pool in each of the
    test processes oversubscribes the cores. One thread gives the same
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(tmp_path, prefix, backend="orbax", extra=()):
    return tmnist.parse_args([
        "--model", *MODEL, "--data", "mnist_8x8", "--img_size", "8",
        "--ds-size", "60", "--epochs", "2", "--batch_size", "8",
        "--tau", "2", "--ckpt-backend", backend, "--device", "cpu",
        "--save-path", f"{tmp_path}/{prefix}",
        "--load-path", f"{tmp_path}/{prefix}", *extra])


def _fresh(seed):
    return Diffusion(tnn.QIDDM_LL_noise(64, 3, 1, 1, 0, seed=seed,
                                        device="cpu"), shape=(8, 8))


def _state(diff):
    return {k: v.clone() for k, v in diff.net.state_dict().items()}


def _assert_same_bits(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_driver_dcp_save_resume_bit_identical(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    scores = tcommon.run_labels(_args(tmp_path, "o_"), labels=[1],
                                tau_test=3)
    assert scores
    ckpts = list(tmp_path.rglob("*.dcp"))
    assert len(ckpts) == 1 and ckpts[0].is_dir()
    assert pathlib.Path(str(ckpts[0]) + ".meta.json").is_file()
    assert not list(tmp_path.rglob("*.pt"))

    # a fresh model of another init finds the finished checkpoint
    diff = _fresh(999)
    losses, epochs = tckpt.load_diffusion(diff, tmp_path / "o_1/noise_0", 1)
    assert epochs == 2 and len(losses) == 2

    # ground truth: the pt backend's run of the same configuration
    tcommon.run_labels(_args(tmp_path, "p_", "pt"), labels=[1], tau_test=3)
    diff_pt = _fresh(999)
    losses_pt, _ = tckpt.load_diffusion(diff_pt, tmp_path / "p_1/noise_0", 1)
    np.testing.assert_array_equal(losses, losses_pt)
    _assert_same_bits(_state(diff), _state(diff_pt))


def test_driver_dcp_mid_training_resume(tmp_path, monkeypatch):
    """With --checkpoint-every 1, the mid-training save runs in the
    background: the uninterrupted DCP run equals the pt run bit for bit,
    losses and weights. Interrupted at epoch 1 and resumed, the first
    epoch's loss is the same run's. (The port draws a segment's batch
    orders before its noise, so a segment of 2 epochs is not two of one:
    the ground truth checkpoints every epoch too.)"""
    monkeypatch.chdir(tmp_path)
    every = ["--checkpoint-every", "1"]
    tcommon.run_labels(_args(tmp_path, "full_", "pt", every), labels=[1],
                       tau_test=3)
    full = _fresh(33)
    full_losses, _ = tckpt.load_diffusion(full, tmp_path / "full_1/noise_0",
                                          1)
    tcommon.run_labels(_args(tmp_path, "dcp_", extra=every), labels=[1],
                       tau_test=3)
    whole = _fresh(34)
    assert tckpt.load_diffusion(whole, tmp_path / "dcp_1/noise_0", 1) == (
        full_losses, 2)
    _assert_same_bits(_state(whole), _state(full))

    args_a = _args(tmp_path, "o_", extra=every)
    args_a.epochs = 1
    tcommon.run_labels(args_a, labels=[1], tau_test=3)
    _, epochs = tckpt.load_diffusion(_fresh(31), tmp_path / "o_1/noise_0", 1)
    assert epochs == 1
    tcommon.run_labels(_args(tmp_path, "o_", extra=every), labels=[1],
                       tau_test=3)  # resumes at epoch 1
    losses, epochs = tckpt.load_diffusion(_fresh(32),
                                          tmp_path / "o_1/noise_0", 1)
    assert epochs == 2 and len(losses) == 2
    # the resumed segment starts Adam afresh: only epoch 1 is the same run
    assert losses[0] == full_losses[0]
    assert np.isfinite(losses).all()


def test_sweep_dcp_artifacts(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(24, 64)).astype(np.float32)

    def make_net(s):
        return tnn.QIDDM_LL_noise(64, 3, 1, 1, 0, seed=s, device="cpu")

    kw = dict(shape=(8, 8), epochs=1, batch_size=8, T=2)
    res = sweep_lr(make_net, [0.01, 0.02], x, local_dir=str(tmp_path),
                   exp_name="orb", ckpt_backend="orbax", **kw)
    res_pt = sweep_lr(make_net, [0.01, 0.02], x, local_dir=str(tmp_path),
                      exp_name="pt", **kw)
    assert len(res.trial_dirs) == 2
    np.testing.assert_array_equal(res.loss_curves, res_pt.loss_curves)
    dcps = sorted((tmp_path / "orb").rglob("*.dcp"))
    pts = sorted((tmp_path / "pt").rglob("*.pt"))
    assert len(dcps) == len(pts) == 2
    for dcp, pt in zip(dcps, pts):
        proto = make_net(0)
        out = tckpt.load_dcp(dcp, like=tckpt.export_jax_variables(proto))
        assert out["meta"]["epochs"] == 1
        want = tckpt.load_checkpoint(pt)["model_state_dict"]
        got, ref = tckpt._flatten(out["variables"]), tckpt._flatten(want)
        assert set(got) == set(ref)
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k])


def test_async_save_failure_surfaces(tmp_path):
    """A failed background save raises on wait_until_finished(), not
    silently: the sidecar's path is a directory, so writing it fails after
    the commit."""
    p = tmp_path / "ck.dcp"
    (tmp_path / "ck.dcp.meta.json").mkdir()
    h = tckpt.save_dcp(p, {"w": np.ones((2,), np.float32)}, async_save=True)
    with pytest.raises(IsADirectoryError):
        h.wait_until_finished()


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """The arrays are copied before save_dcp returns: an in-place update
    while the background thread writes does not reach the checkpoint."""
    net = tnn.QIDDM_LL_noise(64, 3, 1, 1, 0, seed=3, device="cpu")
    want = tckpt.export_jax_variables(net)
    want = {k: v.copy() for k, v in tckpt._flatten(want).items()}
    gate = threading.Event()
    real_commit = tckpt._dcp_commit

    def slow_commit(*args):
        gate.wait(10)
        real_commit(*args)

    monkeypatch.setattr(tckpt, "_dcp_commit", slow_commit)
    h = tckpt.save_dcp(tmp_path / "a.dcp", tckpt.export_jax_variables(net),
                       epochs=1, async_save=True)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(1.0)
    gate.set()
    h.wait_until_finished()
    got = tckpt.load_dcp(tmp_path / "a.dcp",
                         like=tckpt.export_jax_variables(net))
    flat = tckpt._flatten(got["variables"])
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    assert json.loads((tmp_path / "a.dcp.meta.json").read_text()) == {
        "loss_values": [], "epochs": 1}
    # the temporary directory was swapped in and is gone
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "a.dcp", "a.dcp.meta.json"]


def test_loader_order_and_the_jax_orbax_refusal(tmp_path):
    diff = _fresh(1)
    base = tmp_path / "ck"
    name = f"{diff.save_name()}_4"
    # .pt alone, then .dcp beside it: auto prefers the .dcp
    tckpt.save_diffusion(diff, base, 4, [1.0], 1)
    other = _fresh(2)
    tckpt.save_diffusion(other, base, 4, [2.0, 3.0], 2, backend="orbax")
    probe = _fresh(3)
    assert tckpt.load_diffusion(probe, base, 4) == ([2.0, 3.0], 2)
    _assert_same_bits(_state(probe), _state(other))
    assert tckpt.load_diffusion(probe, base, 4, backend="pt") == ([1.0], 1)
    _assert_same_bits(_state(probe), _state(diff))
    assert tckpt.load_diffusion(probe, base / f"{name}.dcp", 4)[1] == 2
    # a directory with the JAX package's .orbax alone is refused by name
    lone = tmp_path / "jax"
    (lone / f"{name}.orbax").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax checkpoint"):
        tckpt.load_diffusion(probe, lone, 4)
    with pytest.raises(ValueError, match="orbax checkpoint"):
        tckpt.load_diffusion(probe, lone, 4, backend="orbax")
    # nothing at all: the fresh model stays
    assert tckpt.load_diffusion(probe, tmp_path / "none", 4) == ([], 0)
    with pytest.raises(ValueError, match="backend"):
        tckpt.load_diffusion(probe, base, 4, backend="tensorstore")


def test_sample_cli_reads_a_dcp_as_the_pt(tmp_path):
    diff = _fresh(5)
    pt = tckpt.save_diffusion(diff, tmp_path, 4, [1.0], 1)
    tckpt.save_diffusion(diff, tmp_path, 4, [1.0], 1, backend="orbax")
    dcp = tmp_path / f"{diff.save_name()}_4.dcp"
    common = ["--model", *MODEL, "--img_size", "8", "--n", "3", "--iters",
              "2", "--device", "cpu", "--format", "npz"]
    a = tsample.main(["--ckpt", str(pt), *common, "--out",
                      str(tmp_path / "a")])
    b = tsample.main(["--ckpt", str(dcp), *common, "--out",
                      str(tmp_path / "b")])
    np.testing.assert_array_equal(a, b)
    (tmp_path / "x.orbax").mkdir()
    with pytest.raises(SystemExit, match="orbax checkpoint"):
        tsample.main(["--ckpt", str(tmp_path / "x.orbax"), *common])
