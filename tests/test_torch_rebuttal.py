"""The experiment drivers' scoring and the rebuttal drivers in
qiddm_tpu_torch against qiddm_tpu on the CPU: ``augment_rotation``,
``test()`` under each scoring protocol from one injected grid, the dict
metrics, the rebuttal drivers' default models at full width (the Qdense
baseline ``QDenseUndirected_old_noise(60, side)`` at 12 wires for 64x64
and 10 for 28x28, depth 60, a CNOT ring, and ``QIDDM_LL_noise(4096, 6,
14, 2)``), and a rebuttal driver run in both packages at a tiny size; then
each of the port's new drivers on the CPU, and on a host without a card
the refusal before any data is loaded.

Tolerances: ``augment_rotation`` and the loaders' arrays are bit-equal
(numpy and scipy in both). ``test()``'s arrays within 1e-4 (JAX clips in
float32). The dict metrics within 1e-4 relative (JAX scores in float32
under jit, the port in float64). The full-width forwards within 1e-4 of
JAX's images, the training loss within 1e-5 relative and each gradient
within 1e-4 of its own max norm (``qweights`` a block at a time), as
tests/test_torch_zoo.py holds them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import metrics as jmetrics
from qiddm_tpu import nn as jnn
from qiddm_tpu.cli import bloodmnist as jblood
from qiddm_tpu.cli import common as jcommon
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import data as tdata
from qiddm_tpu_torch import metrics as tmetrics
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch.cli import (PneumoniaMNIST, bloodmnist, emnist_exm,
                                 fashion_exm, fruit_360, logo2kplus)
from qiddm_tpu_torch.cli import common as tcommon
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion

IMAGE_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SCORE_TOL = 1e-4
PROTOCOLS = ("MNIST", "FASHION", "EMNIST", "REBUTTAL", "NOISE")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread per test process: a thread pool in each oversubscribes
    the cores beside the other workers. One thread gives the same
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_augment_rotation_is_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(5, 64))
    y = np.arange(5)
    got = tcommon.augment_rotation(x, y, 8, 8, 23, seed=3)
    want = jcommon.augment_rotation(x, y, 8, 8, 23, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (23, 64)
    # nothing to add: the same arrays back, in both
    for fn in (tcommon.augment_rotation, jcommon.augment_rotation):
        assert fn(x, y, 8, 8, 5)[0] is x and fn(x[:0], y[:0], 8, 8, 9)[0]\
            .shape == (0, 64)


def test_score_protocols_are_the_jax_packages():
    for name in PROTOCOLS:
        assert (getattr(tcommon, f"{name}_PROTOCOL").__dict__
                == getattr(jcommon, f"{name}_PROTOCOL").__dict__), name


@pytest.mark.parametrize("proto", PROTOCOLS)
def test_test_under_each_protocol_matches_jax(proto):
    """One injected sampler grid (3 iterations of 5 images, 8x8), scaled
    and renormalized as the protocol says; the real images from x_test, or
    from x_train under the rebuttal protocol."""
    rng = np.random.default_rng(4)
    grid = rng.normal(0.5, 0.4, size=(3 * 8, 5 * 8)).astype(np.float32)
    x_train = rng.uniform(size=(6, 64))
    x_test = rng.uniform(size=(4, 64))

    class Args:
        img_size, save_path = 8, ""

    want = jcommon.test(None, Args, x_train, x_test, None, tau_test=2,
                        save_images=False, grid=grid,
                        protocol=getattr(jcommon, f"{proto}_PROTOCOL"))
    got = tcommon.test(None, Args, x_train, x_test, None, tau_test=2,
                       save_images=False, grid=grid,
                       protocol=getattr(tcommon, f"{proto}_PROTOCOL"))
    assert got[1].shape[0] == (6 if proto == "REBUTTAL" else 4)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=IMAGE_TOL)


def test_dict_metrics_match_jax():
    rng = np.random.default_rng(5)
    gen = {f"m#{i}": rng.uniform(0, 255, size=(3, 4, 1, 8, 8))
           for i in range(2)}
    real = {k: rng.uniform(0, 255, size=(6, 1, 8, 8)) for k in gen}
    for name in ("get_ssim", "get_psnr", "get_cosine_similarity", "get_fid"):
        for counts in ((None, None), (2, 5)):
            got = getattr(tmetrics, name)(gen, real, None, *counts)
            want = getattr(jmetrics, name)(gen, real, None, *counts)
            assert list(got) == list(want)
            for k in got:
                assert len(got[k]) == len(want[k]) == 3
                np.testing.assert_allclose(got[k], want[k], rtol=SCORE_TOL)
    for n in ("UNetUndirected", "differN_noise", "QDenseUndirected_old_noise",
              "QIDDM_PL_noise", "QNN_noise", "QIDDM_PL_noise1", "QNN_A",
              "differN_old_pca", "unet_undirected_d3", "QIDDM_LL_noise",
              None):
        assert tmetrics.map_model_name(n) == jmetrics.map_model_name(n)


# --- the rebuttal drivers' default models at full width ---------------------

FULL = [("QDenseUndirected_old_noise", (60, 64), 64),
        ("QDenseUndirected_old_noise", (60, 28), 28),
        ("QIDDM_LL_noise", (4096, 6, 14, 2), 64)]
FULL_IDS = ["Qdense_12_wires", "Qdense_10_wires", "LL_4096"]


@functools.lru_cache(maxsize=None)
def _pair(name, args):
    jnet = getattr(jnn, name)(*args, seed=3)
    tnet = getattr(tnn, name)(*args, seed=5, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    return jnet, tnet


def _images(n, side, seed):
    """``n`` distinct images in [0, 1], image j scaled by 0.7^j."""
    x = np.random.default_rng(seed).uniform(size=(n, side * side)) ** 3
    return (x * 0.7 ** np.arange(n)[:, None]).astype(np.float32)


@pytest.mark.parametrize("name,args,side", FULL, ids=FULL_IDS)
def test_full_width_forward_matches_jax(name, args, side):
    """10 rows: a training step's (batch 1 x tau 10) and the drivers'
    sampling batch."""
    jnet, tnet = _pair(name, args)
    if name.startswith("QDense"):
        assert tnet.wires == (12 if side == 64 else 10)
    img = _images(10, side, 0).reshape(-1, 1, side, side)
    want = np.asarray(jnet(img))
    with torch.no_grad():
        got = tnet(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == (10, 1, side, side)
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL)


@pytest.mark.parametrize("name,args,side", FULL, ids=FULL_IDS)
def test_full_width_training_step_matches_jax_grad(name, args, side):
    """One loss at batch 1, tau 10 (the rebuttal drivers'), with the JAX
    schedule's noise draw blended on both sides; every gradient against
    ``jax.grad``."""
    jnet, tnet = _pair(name, args)
    x = _images(1, side, 1)
    key = jax.random.PRNGKey(11)
    jdiff = JDiffusion(jnet, prediction_goal="data", shape=(side, side))

    def jloss(params):
        return jdiff._chain_loss(params, jnet.extra_variables, key,
                                 jnp.asarray(x), 10)[0]

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(jnet.params)
    draw = np.array(0.5 + 0.2 * jax.random.normal(key, x.shape))

    def noise_f(generator, data, tau, decay_mod):
        return tnoise.add_normal_noise_multiple(
            generator, data, tau, decay_mod, noise=torch.as_tensor(draw))

    tnet.zero_grad()
    tloss, _ = TDiffusion(tnet, noise_f, "data", (side, side)).loss_fn(
        torch.as_tensor(x), 10)
    tloss.backward()
    assert abs(tloss.item() - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    params = dict(tnet.module.named_parameters())
    grads = {}
    for pname, (path, layout) in tckpt._flax_paths(tnet).items():
        got = tckpt._to_flax(params[pname].grad.numpy(), layout)
        want = np.asarray(functools.reduce(lambda t, k: t[k], path[1:],
                                           jgrads))
        if path[-1] == "qweights" and got.ndim == 5:  # a block at a time
            grads.update({(path, n): (got[n], want[n])
                          for n in range(len(got))})
        else:
            grads[path] = (got, want)
    assert grads
    for key_, (got, want) in grads.items():
        scale = np.abs(want).max()
        assert scale > 0, key_
        err = np.abs(got - want).max()
        assert err <= GRAD_TOL * scale, (key_, err, scale)


# --- the drivers ---------------------------------------------------------------

TINY = ["--model", "QIDDM_LL_noise", "784", "2", "1", "1", "--ds-size", "30",
        "--epochs", "1", "--batch_size", "8", "--tau", "2", "--device",
        "cpu"]


@pytest.fixture
def driver_env(tmp_path, monkeypatch):
    """Run drivers in tmp_path with an empty data directory (the texture
    fallbacks) in both packages; their tee loggers are undone afterwards."""
    import sys

    from qiddm_tpu import data as jdata

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    for mod in (tdata, jdata):
        monkeypatch.setattr(mod, "DATA_DIR", tmp_path / "data")
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    return tmp_path


def test_rebuttal_driver_matches_jax_at_a_tiny_size(driver_env,
                                                    monkeypatch):
    """bloodmnist in both packages on the same texture data: the training
    split augmented to 100 images, scored against them by SSIM only
    (PSNR and cosine NaN), the same keys. The JAX driver's PNG dumps and
    plots are left out (the port has none)."""
    from qiddm_tpu import metrics as jmetrics_

    monkeypatch.setattr(jcommon, "_dump_images", lambda *a, **k: None)
    monkeypatch.setattr(jmetrics_, "show_metrics", lambda *a, **k: None)
    augmented = {}
    for pkg, mod in (("port", tcommon), ("jax", jcommon)):
        def spy(*args, _real=mod.augment_rotation, _pkg=pkg, **kw):
            out = _real(*args, **kw)
            augmented.setdefault(_pkg, []).append((len(args[0]),
                                                   len(out[0])))
            return out

        monkeypatch.setattr(mod, "augment_rotation", spy)
    argv = [*TINY, "--save-path", f"{driver_env}/t_", "--load-path",
            f"{driver_env}/t_"]
    got = bloodmnist.main(argv)
    argv[-3] = argv[-1] = f"{driver_env}/j_"
    want = jblood.main(argv)
    assert augmented["port"] == augmented["jax"]
    assert [n for _, n in augmented["port"]] == [100]
    assert list(got) == list(want) == ["QIDDM_LL_noise"]
    entry = got["QIDDM_LL_noise"]
    assert set(want["QIDDM_LL_noise"]) <= set(entry)
    for key in ("ssim", "psnr", "cos"):
        assert len(entry[key]) == len(want["QIDDM_LL_noise"][key]) == 1
    assert np.isfinite(entry["ssim"][0])
    assert np.isnan(entry["psnr"][0]) and np.isnan(entry["cos"][0])
    assert np.isnan(want["QIDDM_LL_noise"]["psnr"][0])
    assert entry["real"][0].shape == (100, 1, 28, 28)  # the augmented set
    assert entry["generated"][0].shape == (6, 10, 1, 28, 28)
    assert (driver_env / "t_0" / "noise_0"
            / "QIDDM_LL_noise=2_L=1_N=1_0.pt").exists()


def test_a_label_without_images_raises_as_in_jax(driver_env):
    """The JAX quirk kept: at a small --ds-size a label may have no image,
    and the run raises ValueError in both packages."""
    (driver_env / "data").mkdir()
    np.savez(driver_env / "data" / "bloodmnist_28.npz",
             x=np.zeros((5, 28, 28), np.uint8), y=np.full(5, 3))
    argv = [*TINY[:6], "--device", "cpu", "--save-path", f"{driver_env}/v_",
            "--load-path", f"{driver_env}/v_"]
    for main in (bloodmnist.main, jblood.main):
        with pytest.raises(ValueError, match="label 0 has no images"):
            main(argv)


DRIVERS = {
    "fashion_exm": (fashion_exm, ["--model", "QIDDM_LL_noise", "784", "2",
                                  "1", "1"], (4,)),
    "emnist_exm": (emnist_exm, ["--model", "QNN_noise", "784", "3", "1"],
                   (2,)),
    "bloodmnist": (bloodmnist, [], (0,)),
    "PneumoniaMNIST": (PneumoniaMNIST, [], (0,)),
    "fruit_360": (fruit_360, [], (0, 1, 2)),
    "logo2kplus": (logo2kplus, [], (1, 4, 5)),
}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_runs_on_the_cpu_at_a_tiny_size(driver_env, name):
    """Each new experiment driver on its own dataset's fallback (the
    rebuttal drivers with their default label lists and the Qdense baseline
    cut to depth 1), 1 epoch; finite scores for each label, a checkpoint
    each."""
    module, models, labels = DRIVERS[name]
    args = module.parse_args([])
    side = args.img_size
    if not models:  # the rebuttal defaults, Qdense cut to depth 1
        assert [m[0] for m in args.model] == ["QDenseUndirected_old_noise",
                                              "QIDDM_LL_noise"]
        assert args.model[0][1:] == ["60", str(side)]
        models = ["--model", "QDenseUndirected_old_noise", "1", str(side),
                  "--model", "QIDDM_LL_noise", str(side * side), "2", "1",
                  "1"]
    if name == "emnist_exm":  # the letters fallback, 26 x 200 glyphs, cached
        x8 = (np.arange(60 * 784) % 251).astype(np.uint8).reshape(60, 28, 28)
        (driver_env / "data").mkdir()
        np.savez(driver_env / "data" / "emnist_letters_28.npz", x=x8,
                 y=np.arange(60) % 26)
    out = module.main([*models, "--ds-size", "200", "--epochs", "1",
                       "--tau", "2", "--batch_size", "25", "--device", "cpu",
                       "--save-path", f"{driver_env}/r_",
                       "--load-path", f"{driver_env}/r_"])
    for entry in out.values():
        assert len(entry["ssim"]) == len(labels)
        assert np.all(np.isfinite(entry["ssim"]))
    for label in labels:
        assert list((driver_env / f"r_{label}" / "noise_0").glob("*.pt"))


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_defaults_are_the_jax_drivers(name):
    """Every default of each driver's parser equals the JAX driver's but
    the device (``cuda`` here, ``tpu`` there)."""
    import importlib

    module = DRIVERS[name][0]
    jmod = importlib.import_module(f"qiddm_tpu.cli.{name}")
    got, want = vars(module.parse_args([])), vars(jmod.parse_args([]))
    assert got.pop("device") == "cuda" and want.pop("device") == "tpu"
    assert got == want


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_without_a_card_raises_before_loading_data(
        driver_env, monkeypatch, name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-fallback check needs a "
                    "host without it")

    def no_data(args):
        raise AssertionError("data loaded before the device was resolved")

    monkeypatch.setattr(tcommon, "load_dataset", no_data)
    module = DRIVERS[name][0]
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        module.main(["--model", "QIDDM_LL_noise", "784", "2", "1", "1"])
