"""The noise path of qiddm_tpu_torch against qiddm_tpu on the CPU: the noise
models, the engine's density-matrix branches (``reupload_block``,
``qnn_circuit``, ``qdense_circuit``), the noisy models with their
``noise_cfg`` carried across, sampling through ``with_noise``, the scores
of ``metrics.py`` and the two noise drivers.

The JAX side runs its XLA density-matrix path (on the CPU the Pallas dm
kernel is not taken); the port's re-uploading block runs the dm kernel's
plain version when autograd does not record and the two-sided SEL chain
when it does, so each case holds both routes to the same JAX values.

Tolerances:
* circuit values: <= 1e-5 (probabilities and PauliZ expectations of
  unit-trace density matrices after a few float32 channel and gate layers);
* gradients of the two-sided route: within 1e-4 of ``jax.grad``'s max norm;
* model images and sampled images: <= 1e-4 (a linear or a x-pixels
  post-processing over the circuit, through a PCA fit for the PCA-down
  models);
* SSIM, PSNR and cosine: 1e-5 relative (the JAX package scores in float32,
  the port in float64); FID: 1e-6 relative (the same numpy and scipy code).
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import config as jconfig
from qiddm_tpu import metrics as jmetrics
from qiddm_tpu import nn as jnn
from qiddm_tpu.cli import common as jcommon
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu.sim import engine as jengine
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import config as tconfig
from qiddm_tpu_torch import data as tdata
from qiddm_tpu_torch import metrics as tmetrics
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch.cli import common as tcommon
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.sim import dm_kernel
from qiddm_tpu_torch.sim import engine as tengine

TOL = 1e-5
GRAD_TOL = 1e-4
IMAGE_TOL = 1e-4
SCORE_TOL = 1e-5
KINDS = ["amplitude_damping", "depolarizing", "phase_damping"]


@pytest.fixture
def unitary_mode(request):
    """Set ``dm_unitary_mode`` in both packages, and restore it."""
    before = (jconfig.dm_unitary_mode(), tconfig.dm_unitary_mode())
    jconfig.set_dm_unitary_mode(request.param)
    tconfig.set_dm_unitary_mode(request.param)
    yield request.param
    jconfig.set_dm_unitary_mode(before[0])
    tconfig.set_dm_unitary_mode(before[1])


def _noise_pair(kind, strength, placement):
    return (jengine.NoiseModel(kind, strength, placement),
            tengine.NoiseModel(kind, strength, placement))


def _jax_grads(fn, *args):
    return jax.grad(lambda *a: jnp.sum(fn(*a) * _weights(fn(*a).shape)),
                    argnums=tuple(range(len(args))))(*args)


def _weights(shape):
    """Fixed readout weights for a scalar loss."""
    return np.random.default_rng(99).normal(size=shape).astype(np.float32)


def _assert_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * scale


# --- noise models ------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(jengine._FAMILY_NOISE))
def test_noise_from_code_matches_jax(family):
    for code in range(4):
        for intensity in (None, 0.2):
            want = jengine.noise_from_code(code, family, intensity)
            got = tengine.noise_from_code(code, family, intensity)
            if want is None:
                assert got is None
                continue
            assert (got.kind, got.strength, got.placement) == (
                want.kind, want.strength, want.placement)
            assert got.is_unitary == want.is_unitary
    got = tengine.noise_from_code(4, family, 0.05)
    assert (got.kind, got.strength, got.placement) == ("rot_angle", 0.05,
                                                       "encode")
    t = torch.tensor(0.1)
    assert tengine.noise_from_code(2, family, t).strength is t
    with pytest.raises(ValueError, match="explicit"):
        tengine.noise_from_code(4, family)


# --- engine: re-uploading block ---------------------------------------------

def _block_inputs(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, 3)).astype(np.float32),
            (rng.normal(size=(2, 2, 3, 3)) * 0.6).astype(np.float32))


@pytest.mark.parametrize("unitary_mode", ["gates", "matmul"], indirect=True)
@pytest.mark.parametrize("placement", ["encode", "end"])
@pytest.mark.parametrize("kind", KINDS)
def test_reupload_block_dm_matches_jax(unitary_mode, kind, placement):
    """Both readouts and both encodes, without grad (the dm kernel's route
    where eligible) and under grad (the two-sided SEL chains), each against
    the JAX values."""
    x, w = _block_inputs()
    jnoise, tnoise = _noise_pair(kind, 0.25, placement)
    for encode in ("rz", "ry"):
        for readout in ("probs", "expvalz"):
            kw = dict(encode=encode, readout=readout)
            want = np.asarray(jengine.reupload_block(
                jnp.asarray(x), jnp.asarray(w), noise=jnoise, **kw))
            before = dm_kernel.DM_LAUNCHES
            with torch.no_grad():
                fast = tengine.reupload_block(torch.as_tensor(x),
                                              torch.as_tensor(w),
                                              noise=tnoise, **kw)
            assert dm_kernel.DM_LAUNCHES == before  # the CPU: plain
            np.testing.assert_allclose(fast.numpy(), want, atol=TOL)
            out = tengine.reupload_block(
                torch.as_tensor(x), torch.as_tensor(w).requires_grad_(True),
                noise=tnoise, **kw)
            np.testing.assert_allclose(out.detach().numpy(), want, atol=TOL)


@pytest.mark.parametrize("encode", ["rz", "ry"])
@pytest.mark.parametrize("kind", KINDS)
def test_reupload_block_dm_gradients_match_jax(kind, encode):
    """The two-sided route's gradients in the angles and the weights
    against ``jax.grad`` of the JAX dm path (its XLA gate chains)."""
    x, w = _block_inputs(6)
    jnoise, tnoise = _noise_pair(kind, 0.25, "encode")

    def jfn(x_, w_):
        return jengine.reupload_block(x_, w_, encode=encode, noise=jnoise,
                                      readout="expvalz")

    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    out = tengine.reupload_block(xt, wt, encode=encode, noise=tnoise,
                                 readout="expvalz")
    (out * torch.as_tensor(_weights(out.shape))).sum().backward()
    _assert_grads((xt.grad, wt.grad),
                  _jax_grads(jfn, jnp.asarray(x), jnp.asarray(w)))


def test_reupload_block_routes_by_autograd(monkeypatch):
    """Without grad an encode-placed channel runs the block through
    ``dm_chain``; under grad, or with the channel at the end, it does not
    (the JAX package routes by the same condition)."""
    calls = []
    real = tengine.dm_chain

    def spy(*a, **kw):
        calls.append(a[4])
        return real(*a, **kw)

    monkeypatch.setattr(tengine, "dm_chain", spy)
    x, w = torch.rand(2, 3), torch.rand(2, 2, 3, 3)
    enc = tengine.NoiseModel("depolarizing", 0.1, "encode")
    with torch.no_grad():
        tengine.reupload_block(x, w, noise=enc)
        tengine.reupload_block(
            x, w, noise=tengine.NoiseModel("depolarizing", 0.1, "end"))
    assert calls == ["depolarizing"]
    tengine.reupload_block(x, w.requires_grad_(True), noise=enc)
    tengine.reupload_block(x, w.detach(), noise=tengine.NoiseModel(
        "depolarizing", torch.tensor(0.1, requires_grad=True), "encode"))
    assert calls == ["depolarizing"]
    tengine.reupload_block(x, w.detach(), noise=enc)  # nothing records
    assert calls == ["depolarizing"] * 2


@pytest.mark.parametrize("code,family", [(1, "qiddm"), (2, "differn_befor"),
                                         (3, "qdense"), (4, "qiddm"),
                                         (1, "qdense")])
def test_reupload_block_codes_match_jax(code, family):
    """The codes through ``noise_from_code``: the channels, the
    rotation-angle error (after the halfpi scaling) and the phase shift
    (a no-op for the probabilities)."""
    rng = np.random.default_rng(code)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 3, 3)) * 0.6).astype(np.float32)
    for encode in ("rz", "rz_halfpi", "ry"):
        want = jengine.reupload_block(
            jnp.asarray(x), jnp.asarray(w), encode=encode,
            noise=jengine.noise_from_code(code, family, 0.3))
        with torch.no_grad():
            got = tengine.reupload_block(
                torch.as_tensor(x), torch.as_tensor(w), encode=encode,
                noise=tengine.noise_from_code(code, family, 0.3))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


# --- engine: QNN and Qdense circuits -----------------------------------------

@pytest.mark.parametrize("unitary_mode", ["gates", "matmul"], indirect=True)
@pytest.mark.parametrize("placement", ["encode", "end"])
@pytest.mark.parametrize("kind", KINDS)
def test_qnn_circuit_dm_matches_jax(unitary_mode, kind, placement):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 3)).astype(np.float32)
    w = (rng.normal(size=(4, 3, 3)) * 0.6).astype(np.float32)
    jnoise, tnoise = _noise_pair(kind, 0.3, placement)
    for encode, ring, readout in (("rz", "cz", "expvalz"),
                                  ("ry", "cnot", "probs")):
        kw = dict(encode=encode, imprimitive=ring, readout=readout)

        def jfn(x_, w_):
            return jengine.qnn_circuit(x_, w_, noise=jnoise, **kw)

        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w)))
        wt = torch.as_tensor(w).requires_grad_(True)
        xt = torch.as_tensor(x).requires_grad_(True)
        out = tengine.qnn_circuit(xt, wt, noise=tnoise, **kw)
        np.testing.assert_allclose(out.detach().numpy(), want, atol=TOL)
        if encode == "ry":  # the RZ circuit's input is a global phase
            (out * torch.as_tensor(_weights(out.shape))).sum().backward()
            _assert_grads((xt.grad, wt.grad),
                          _jax_grads(jfn, jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("kind", KINDS + ["phase_shift"])
@pytest.mark.parametrize("batch", [3, 9])
def test_qdense_circuit_dm_matches_jax(kind, batch):
    """Both statevector routes (the SEL chain below 2^w, the composed
    unitary at or above it), then the channel at the end."""
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(batch, 7)).astype(np.float32)
    w = (rng.normal(size=(5, 3, 3))).astype(np.float32)
    want = jengine.qdense_circuit(
        jnp.asarray(x), jnp.asarray(w), wires=3,
        noise=jengine.NoiseModel(kind, 0.2, "end"))
    got = tengine.qdense_circuit(
        torch.as_tensor(x), torch.as_tensor(w), wires=3,
        noise=tengine.NoiseModel(kind, 0.2, "end"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL)


def test_trajectory_backend_raises():
    """The trajectory backend raises without a random source; with one it
    runs at 3 wires on the kernels' routes and at 13 on the JAX package's
    XLA routes: ``sel_apply_gates`` for the SEL layers and the PyTorch
    amplitude-damping pass."""
    noise = tengine.NoiseModel("amplitude_damping", 0.1, "encode")
    for fn, wires in ((tengine.reupload_block, 3), (tengine.qnn_circuit, 3),
                      (tengine.qdense_circuit, 3),
                      (tengine.reupload_block, 13),
                      (tengine.qnn_circuit, 13),
                      (tengine.qdense_circuit, 13)):
        if fn is tengine.reupload_block:
            args = (torch.zeros(2, wires), torch.zeros(1, 2, wires, 3))
        elif fn is tengine.qnn_circuit:
            args = (torch.zeros(2, wires), torch.zeros(1, wires, 3))
        else:
            args = (torch.zeros(2, 8), torch.zeros(1, wires, 3))
        kw = {"wires": wires} if fn is tengine.qdense_circuit else {}
        with pytest.raises(ValueError, match="random source"):
            fn(*args, noise=noise, n_traj=4, **kw)
        gen = torch.Generator().manual_seed(0)
        tengine.reset_route_calls()
        out = fn(*args, noise=noise, n_traj=4, traj_rng=gen, **kw)
        assert torch.isfinite(out).all()
        routes = dict(tengine.ROUTE_CALLS)
        if wires > 12:
            assert routes["gates"] >= 1 and routes["amp_xla"] >= 1, routes
        else:
            assert not any(routes.values()), routes


# --- models ------------------------------------------------------------------

# (name, ctor args, batch, passes noise_intensity to the ctor)
MODELS = [
    ("QIDDM_LL_noise", (64, 3, 2, 2), 4, True),
    ("QIDDM_PL_noise", (64, 4, 2, 2), 8, True),
    ("QIDDM_PL_noise1", (64, 4, 2, 2), 8, False),
    ("QNN_noise", (64, 3, 2), 4, False),
    ("QNN_A", (3, 8), 4, False),
    ("QDenseUndirected_old_noise", (3, 8), 4, False),
    ("differN_noise", (8, 2, 2), 8, False),
    ("differN_noise_befor", (8, 2, 2), 8, False),
]


def _noisy_pair(name, args, code, intensity, use_ctor):
    """The JAX model with ``add_noise=code`` and an explicit intensity, and
    the port's with its variables, ``noise_cfg`` included, carried across
    by ``load_jax_variables``."""
    if use_ctor:
        jnet = getattr(jnn, name)(*args, code, noise_intensity=intensity,
                                  seed=3)
    else:  # at code 4 the JAX ctor's init would need an intensity
        jnet = jcommon.with_noise(getattr(jnn, name)(*args, seed=3), code,
                                  intensity)
    tnet = getattr(tnn, name)(*args, code, seed=5, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    return jnet, tnet


@pytest.mark.parametrize("name,args,batch,use_ctor", MODELS,
                         ids=[m[0] for m in MODELS])
def test_noisy_models_match_jax(name, args, batch, use_ctor):
    for code in (1, 2, 3, 4):
        jnet, tnet = _noisy_pair(name, args, code, 0.15, use_ctor)
        assert "noise_cfg" in jnet.variables
        assert torch.is_tensor(tnet.module.noise_intensity)
        img = np.random.default_rng(code).uniform(
            size=(batch, 1, *tnet.img_shape)).astype(np.float32)
        want = np.asarray(jnet(img))
        with torch.no_grad():
            got = tnet(torch.as_tensor(img)).numpy()
        np.testing.assert_allclose(got, want, atol=IMAGE_TOL,
                                   err_msg=f"add_noise={code}")


@pytest.mark.parametrize("name,args", [("differN_noise", (8, 4, 2)),
                                       ("differN_noise_befor", ("8", 4, 2)),
                                       ("differN_noise", (28, 9, 2, 3))])
def test_differn_save_name_params_and_attributes_match_jax(name, args):
    jnet = getattr(jnn, name)(*args)
    tnet = getattr(tnn, name)(*args, device="cpu")
    assert tnet.save_name() == jnet.save_name()
    assert tnet.num_params() == jnet.num_params()
    for attr in ("spectrum_layer", "N", "add_noise", "wires"):
        assert getattr(tnet, attr) == getattr(jnet, attr), attr


def test_noise_cfg_round_trips_through_the_checkpoint(tmp_path):
    """load_jax_variables takes the JAX tree's noise_cfg/intensity and
    export_jax_variables writes it back, so the shared checkpoint holds
    it for both packages."""
    from qiddm_tpu import ckpt as jckpt

    jnet = jnn.QIDDM_LL_noise(64, 3, 2, 2, 2, noise_intensity=0.3, seed=1)
    path = jckpt.save_checkpoint(tmp_path / "j.pt", jnet.variables, [1.0], 2)
    tnet = tnn.QIDDM_LL_noise(64, 3, 2, 2, 2, device="cpu")
    assert tnet.module.noise_intensity is None
    tckpt.load_jax_variables(tnet,
                             tckpt.load_checkpoint(path)["model_state_dict"])
    assert tnet.module.noise_intensity.item() == np.float32(0.3)
    back = tckpt.export_jax_variables(tnet)
    assert back["noise_cfg"]["intensity"].dtype == np.float32
    assert back["noise_cfg"]["intensity"] == np.float32(0.3)
    want = jax.tree_util.tree_map(np.asarray, jnet.variables)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    out = tckpt.save_checkpoint(tmp_path / "t.pt", back, [1.0], 2)
    jback = jnn.QIDDM_LL_noise(64, 3, 2, 2, 2, noise_intensity=0.1, seed=4)
    jback.variables = jckpt.load_checkpoint(out)["model_state_dict"]
    img = np.random.default_rng(0).uniform(size=(3, 1, 8, 8)).astype(
        np.float32)
    np.testing.assert_allclose(np.asarray(jback(img)), np.asarray(jnet(img)),
                               atol=1e-6)
    clean = tnn.QIDDM_LL_noise(64, 3, 2, 2, device="cpu")
    assert "noise_cfg" not in tckpt.export_jax_variables(clean)


# --- sampling through with_noise --------------------------------------------

def test_sampling_through_with_noise_matches_jax():
    """3 iterations of a noisy QIDDM_LL_noise at two intensities, the port's
    intensity set in place on one noisy net, against JAX's sampler with
    the intensity in noise_cfg."""
    jnet = jnn.QIDDM_LL_noise(64, 3, 2, 2, seed=2)
    tnet = tnn.QIDDM_LL_noise(64, 3, 2, 2, device="cpu")
    tckpt.load_jax_variables(
        tnet, jax.tree_util.tree_map(np.asarray, jnet.variables))
    first_x = (np.random.default_rng(3).uniform(size=(4, 1, 8, 8)) * 0.75
               + 0.5).astype(np.float32)
    jdiff = JDiffusion(jcommon.with_noise(jnet, 3, 0.2), shape=(8, 8))
    noisy = tcommon.with_noise(tnet, 3, 0.2)
    assert noisy.module.qweights is tnet.module.qweights
    assert tnet.module.add_noise == 0 and noisy.module.add_noise == 3
    tdiff = TDiffusion(noisy, shape=(8, 8))
    base = {k: v for k, v in jdiff.net.variables.items() if k != "noise_cfg"}
    grids = []
    for intensity in (0.2, 0.7):
        want = np.asarray(jdiff.sample_fn(
            {**base, "noise_cfg": {"intensity": jnp.float32(intensity)}},
            jnp.asarray(first_x), 3, only_last=False))
        tcommon.set_noise_intensity(noisy, intensity)
        got = tdiff.sample_fn(torch.as_tensor(first_x), 3, only_last=False)
        assert got.shape == want.shape == (4 * 8, 4 * 8)
        np.testing.assert_allclose(got.numpy(), want, atol=IMAGE_TOL)
        grids.append(got)
    assert (grids[0] - grids[1]).abs().max() > 1e-3
    clean = TDiffusion(tnet, shape=(8, 8)).sample_fn(
        torch.as_tensor(first_x), 3)
    assert (clean - grids[0]).abs().max() > 1e-3


def test_with_noise_leaves_a_net_without_noise_as_it_is():
    net = tnn.QNN(64, 3, 2, device="cpu")
    assert tcommon.with_noise(net, 2, 0.1).module.add_noise == 2
    net.module.__dict__.pop("add_noise")
    assert tcommon.with_noise(net, 2, 0.1) is net


# --- metrics -----------------------------------------------------------------

def _images(seed):
    """Structured 28x28 images in [0, 255], as the noise protocol scores:
    a shared pattern plus noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, 28)
    base = np.sin(6 * t[:, None] + 3 * t[None, :] + seed)
    gen = np.clip(0.5 + 0.4 * base + rng.normal(0, 0.1, (3, 4, 1, 28, 28)),
                  0, 1) * 255
    real = np.clip(0.5 + 0.4 * base + rng.normal(0, 0.2, (10, 1, 28, 28)),
                   0, 1) * 255
    return gen.astype(np.float32), real.astype(np.float32)


@pytest.mark.parametrize("counts", [(1, 90), (2, 5), (None, None)])
def test_scores_match_jax(counts):
    gen, real = _images(sum(c or 0 for c in counts))
    for name in ("ssim", "psnr", "cosine"):
        want = getattr(jmetrics, f"{name}_iterations")(gen, real, *counts)
        got = getattr(tmetrics, f"{name}_iterations")(gen, real, *counts)
        assert got.shape == want.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=SCORE_TOL, err_msg=name)
    want = jmetrics.fid_iterations(gen[-1:], real, *counts)
    got = tmetrics.fid_iterations(gen[-1:], real, *counts)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    pair = tmetrics.ssim_pair(real[0, 0], real[0, 0], 255.0)
    assert pair == pytest.approx(1.0)
    # one generated image: the covariance is its pixels' variance on any
    # numpy (later releases' np.cov would give a matrix of NaN)
    act = gen[-1, :1].reshape(1, -1).astype(np.float64)
    assert tmetrics._cov(act) == pytest.approx(np.var(act, ddof=1))
    assert np.isfinite(tmetrics.calculate_fid(act, real, 1, len(real)))


# --- the drivers -------------------------------------------------------------

@pytest.fixture
def driver_env(tmp_path, monkeypatch):
    """A scratch directory as the working directory, stdout and stderr
    restored after the drivers tee them into their log, and a seeded
    fashion_28.npz as the only fashion data."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(8)
    np.savez(data / "fashion_28.npz",
             x=rng.integers(0, 256, size=(60, 28, 28), dtype=np.uint8),
             y=np.arange(60) % 10)
    monkeypatch.setattr(tdata, "DATA_DIR", data)
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


def _check_results(results, models, types, n_int):
    assert sorted(results) == sorted(models)
    for per_model in results.values():
        assert sorted(per_model) == list(types)
        for scores in per_model.values():
            assert sorted(scores) == ["cos", "fid", "psnr", "ssim"]
            for values in scores.values():
                assert len(values) == n_int and np.isfinite(values).all()


def test_mnist_noise_sweeps_and_reuses_its_caches(driver_env, monkeypatch):
    from qiddm_tpu_torch.cli import mnist_noise

    tmp = driver_env
    argv = ["--data", "mnist_8x8", "--img_size", "8",
            "--model", "QIDDM_LL_noise", "64", "3", "2", "2",
            "--ds-size", "60", "--epochs", "1", "--tau", "2",
            "--device", "cpu", "--save-path", f"{tmp}/run_",
            "--load-path", f"{tmp}/run_"]
    first = mnist_noise.main(argv)
    _check_results(first, ["QIDDM_LL_noise"], [4], 10)
    cache_dir = tmp / "run_0" / "noise_4"
    caches = sorted(cache_dir.glob("*_outp_*.pt"))
    assert len(caches) == 10
    # the JAX package's loader reads the port's cache
    jdiff = JDiffusion(jnn.QIDDM_LL_noise(64, 3, 2, 2), shape=(8, 8))
    grid = jcommon.load_outp(jdiff, cache_dir, 0.05)
    assert grid.shape == (5 * 8, 10 * 8) and grid.dtype == np.float32

    def no_sampling(*a, **kw):
        raise AssertionError("sampled although every cache exists")

    monkeypatch.setattr(TDiffusion, "sample", no_sampling)
    second = mnist_noise.main(argv)
    assert second == first


def test_fashion_noise_sweeps_all_types_on_the_dm_backend(driver_env):
    from qiddm_tpu_torch.cli import fashion_noise

    tmp = driver_env
    before = dm_kernel.DM_LAUNCHES
    out = fashion_noise.main([
        "--all-noise-types", "--model", "QIDDM_LL_noise", "784", "3", "2",
        "2", "--ds-size", "60", "--epochs", "1", "--tau", "1", "--device",
        "cpu", "--save-path", f"{tmp}/f_", "--load-path", f"{tmp}/f_"])
    assert dm_kernel.DM_LAUNCHES == before  # the CPU runs the plain path
    _check_results(out, ["QIDDM_LL_noise"], [1, 2, 3], 5)
    args = fashion_noise.parse_args([])
    assert args.data == "fashion_28x28" and args.model == [
        ["QNN_noise", "784", "8", "6"]]
    cached = sorted(p.name for p in (tmp / "f_0" / "noise_2").glob("*.pt"))
    assert cached == [f"QIDDM_LL_noise=3_L=2_N=2_outp_{v}.pt"
                      for v in (0.1, 0.2, 0.3, 0.5, 0.8)]


def test_score_protocols_match_jax():
    """The port's protocols keep the JAX ones' values of the fields they
    carry; the JAX ones' other fields hold what the port does always:
    real images from x_test, every score computed."""
    for name in ("MNIST", "NOISE"):
        want = getattr(jcommon, f"{name}_PROTOCOL")
        got = getattr(tcommon, f"{name}_PROTOCOL")
        for field in got.__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), (name, field)
        assert not want.real_from_train and want.psnr_cos


def test_test_under_the_noise_protocol_matches_jax():
    """``test(grid=...)`` post-processes a cached grid as the JAX driver
    does: generated kept in [0, 255], real min-max scaled to [0, 255]."""
    rng = np.random.default_rng(4)
    grid = rng.normal(0.5, 0.4, size=(3 * 8, 5 * 8)).astype(np.float32)
    x_train = rng.uniform(size=(6, 64))
    x_test = rng.uniform(size=(4, 64))

    class Args:
        img_size, save_path = 8, ""

    for proto in ("NOISE", "MNIST"):
        want = jcommon.test(None, Args, x_train, x_test, None, tau_test=2,
                            save_images=False, grid=grid,
                            protocol=getattr(jcommon, f"{proto}_PROTOCOL"))
        got = tcommon.test(None, Args, x_train, x_test, None, tau_test=2,
                           save_images=False, grid=grid,
                           protocol=getattr(tcommon, f"{proto}_PROTOCOL"))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)
