"""The PCA-down re-uploading family of qiddm_tpu_torch — ``QIDDM_PL_noise1``
(RY re-upload), ``QIDDM_PL``, ``QIDDM_PL_old`` and ``QIDDM_PL_noise`` (RZ)
— against qiddm_tpu on the CPU, with the JAX weights carried across by
``load_jax_variables``, and the training driver on ``QIDDM_PL_noise1``.

Every forward refits the PCA on its batch. Batches hold at least
``hidden + 2`` rows: at fewer, whether a null-space component survives the
fit's 1e-4 zeroing rule depends on rounding (tests/test_torch_pca.py checks
that rule on its own). The training steps take several distinct images:
the chain of ONE image (one image blended with one noise draw) spans a
few directions, fewer than the components, and in float32 ``eigh`` of the
Gram matrix returns its null-space eigenvalues at rounding size, ~1e-7 of
the largest, i.e. singular values ~3e-4 of the largest, above the zeroing
threshold: those components are rounding noise in both packages (ROADMAP
Queue 3).

Tolerances:
* model images: <= 1e-4 (a hidden -> pixels linear over N blocks of up to
  12 gate layers and 6 RY encodes per block, in float32, through the PCA
  fit, the gate chain or composed unitaries here and per-layer or composed
  unitaries in JAX);
* the training loss: <= 1e-5 relative; gradients: each parameter within
  1e-4 of its own max norm, and each block of ``qweights`` on its own. The
  first block's weights reach the loss only through the second block's
  encode angles (the RY chain's dcs), so a wrong or missing dcs shows in
  ``qweights[0]`` alone.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import ckpt as jckpt
from qiddm_tpu import nn as jnn
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch.cli import sample as tsample
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.nn import core as tcore

IMAGE_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4

PL_NAMES = ["QIDDM_PL_noise1", "QIDDM_PL", "QIDDM_PL_old", "QIDDM_PL_noise"]


def _jax_tree(net):
    return jax.tree_util.tree_map(np.asarray, net.variables)


def _trees_equal(a, b):
    return (jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
            and all(np.array_equal(x, y) for x, y in
                    zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b))))


def _pair(name, args, seed=3):
    jnet = getattr(jnn, name)(*args, seed=seed)
    tnet = getattr(tnn, name)(*args, seed=seed + 2, device="cpu")
    tckpt.load_jax_variables(tnet, _jax_tree(jnet))
    return jnet, tnet


# (name, ctor args, batch); batch >= 2^hidden takes the composed route
@pytest.mark.parametrize("name,args,batch", [
    ("QIDDM_PL_noise1", (64, 4, 3, 2), 10),
    ("QIDDM_PL_noise1", (64, 4, 3, 2), 20),
    ("QIDDM_PL_noise1", (64, 3, 2, 3), 7),
    ("QIDDM_PL", (64, 4, 2, 2), 6),
    ("QIDDM_PL_old", (64, 4, 2, 1), 8),
    ("QIDDM_PL_noise", (64, 4, 2, 2), 20),
    ("QIDDM_PL_noise1", (784, 8, 6, 2), 10),
], ids=["ry_chain", "ry_composed", "ry_three_blocks", "PL", "PL_old",
        "PL_noise_composed", "ry_full_width"])
def test_forward_matches_jax(name, args, batch):
    jnet, tnet = _pair(name, args)
    img = np.random.default_rng(0).uniform(
        size=(batch, 1, *tnet.img_shape)).astype(np.float32)
    want = np.asarray(jnet(img))
    with torch.no_grad():
        got = tnet(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL)


@pytest.mark.parametrize("name", PL_NAMES)
@pytest.mark.parametrize("args", [(784, 8, 6, 2), ("8 * 8", 4, "2", 1)],
                         ids=["full", "small"])
def test_save_name_param_count_and_attributes_match_jax(name, args):
    jnet = getattr(jnn, name)(*args)
    tnet = getattr(tnn, name)(*args, device="cpu")
    assert tnet.save_name() == jnet.save_name()
    assert tnet.num_params() == jnet.num_params()
    for attr in ("hidden_features", "spectrum_layer", "N", "add_noise"):
        assert hasattr(tnet, attr) == hasattr(jnet, attr), attr
        if hasattr(jnet, attr):
            assert getattr(tnet, attr) == getattr(jnet, attr), attr
    # the PCA is refitted per batch: no linear_down to carry
    assert not hasattr(tnet.module, "linear_down")


def test_ry_and_rz_variants_share_a_save_name():
    """The reference's collision, kept: QIDDM_PL_noise1 (RY) saves under
    QIDDM_PL_noise's name (RZ)."""
    name = tnn.QIDDM_PL_noise1(784, 8, 6, 2, device="cpu").save_name()
    assert name == tnn.QIDDM_PL_noise(784, 8, 6, 2, device="cpu").save_name()
    assert name == "QIDDM_PL_noise=8_L=6_N=2"
    net = tnn.QIDDM_PL_noise1(784, 8, 6, 2, device="cpu")
    assert net.module.encode == "ry"


@pytest.mark.parametrize("name", PL_NAMES)
def test_jax_checkpoint_round_trips_through_port(tmp_path, name):
    jnet = getattr(jnn, name)(784, 8, 6, 2, seed=7)
    path = jckpt.save_checkpoint(tmp_path / "jax.pt", jnet.variables,
                                 [0.5], 3)
    tnet = getattr(tnn, name)(784, 8, 6, 2, device="cpu")
    tckpt.load_jax_variables(tnet,
                             tckpt.load_checkpoint(path)["model_state_dict"])
    back = tckpt.export_jax_variables(tnet)
    assert _trees_equal(back, _jax_tree(jnet))
    out = tckpt.save_checkpoint(tmp_path / "torch.pt", back, [0.1], 1)
    assert _trees_equal(jckpt.load_checkpoint(out)["model_state_dict"],
                        _jax_tree(jnet))


def test_unported_options_raise():
    """The noise codes build (the density-matrix and trajectory backends
    are ported; the trajectory backend raises without a random source);
    every Reupload option is ported, and an unknown ``down`` or ``up``
    raises ``ValueError``, as the JAX module does."""
    from qiddm_tpu_torch.sim import engine as tengine

    net = tnn.QIDDM_PL_noise1(64, 4, 2, 2, 1, device="cpu")
    assert net.module.add_noise == 1
    net = tnn.QIDDM_PL_noise(64, 4, 2, 2, 2, noise_intensity=0.1, device="cpu")
    assert net.module.noise_intensity == 0.1
    with pytest.raises(ValueError, match="random source"):
        tengine.reupload_block(torch.zeros(2, 4), torch.zeros(2, 2, 4, 3),
                               encode="ry", n_traj=8,
                               noise=tengine.noise_from_code(2, "qiddm"))
    gen = torch.Generator().manual_seed(0)
    for kw in ({"down": "pca2_bn_linear"}, {"down": "conv"},
               {"pca_lazy": True}):
        tcore.Reupload(4, 2, 1, generator=gen, shape=(8, 8), **kw)
    for kw in ({"down": "pca3"}, {"up": "conv"}):
        with pytest.raises(ValueError, match="unknown"):
            tcore.Reupload(4, 2, 1, generator=gen, shape=(8, 8), **kw)


# --- one training step -------------------------------------------------------

def _injecting(draw):
    """A ``noise_f`` that blends the JAX schedule's draw."""

    def noise_f(generator, data, tau, decay_mod):
        return tnoise.add_normal_noise_multiple(
            generator, data, tau, decay_mod,
            noise=torch.as_tensor(np.array(draw)))

    return noise_f


def _by_block(grads: dict) -> dict:
    """Flax-path gradients, with ``qweights`` split into its N blocks."""
    out = {}
    for path, g in grads.items():
        if path[-1] == "qweights":
            out.update({path + (n,): g[n] for n in range(len(g))})
        else:
            out[path] = g
    return out


@pytest.mark.parametrize("name,args,batch,T", [
    ("QIDDM_PL_noise1", (64, 4, 3, 2), 5, 3),
    ("QIDDM_PL_noise1", (64, 3, 2, 2), 3, 3),
    ("QIDDM_PL_noise", (64, 4, 2, 2), 5, 3),
])
def test_training_step_matches_jax_grad(name, args, batch, T):
    """batch x T rows below 2^hidden run the gate chain's autograd Function
    (RY for QIDDM_PL_noise1, RZ for QIDDM_PL_noise) on the CPU, at or above
    it the composed unitaries (the second case: 9 rows at 3 wires)."""
    jnet, tnet = _pair(name, args)
    shape = tnet.img_shape
    x = np.random.default_rng(4).uniform(
        size=(batch, shape[0] * shape[1])).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jdiff = JDiffusion(jnet, prediction_goal="data", shape=shape)

    def jloss(params):
        return jdiff._chain_loss(params, jdiff.net.extra_variables, key,
                                 jnp.asarray(x), T)[0]

    want_loss, jgrads = jax.value_and_grad(jloss)(jdiff.net.params)
    tdiff = TDiffusion(tnet, _injecting(
        0.5 + 0.2 * jax.random.normal(key, x.shape)), "data", shape)
    tloss, _ = tdiff._chain_loss(torch.as_tensor(x), T, generator=None)
    tloss.backward()
    assert abs(tloss.item() - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    params = dict(tnet.module.named_parameters())
    got, want = {}, {}
    for pname, (path, transpose) in tckpt._flax_paths(tnet).items():
        g = params[pname].grad.numpy()
        got[path] = g.T if transpose else g
        node = jgrads
        for k in path[1:]:
            node = node[k]
        want[path] = np.asarray(node)
    got, want = _by_block(got), _by_block(want)
    assert ("params", "qweights", 0) in want
    for key_, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, key_
        err = np.abs(got[key_] - w).max()
        assert err <= GRAD_TOL * scale, (key_, err, scale)


# --- sampling ----------------------------------------------------------------

def test_sampling_matches_jax_step_by_step():
    """QIDDM_PL_noise1 sampling, each iteration from JAX's batch: the
    port's denoiser maps JAX's batch t to JAX's batch t+1 within 1e-4.

    Free-running trajectories are not compared: the map refits the PCA on
    every batch and carries each step's float32 rounding into the next
    fit, so two float32 implementations part after a few iterations
    (ROADMAP Queue 3)."""
    jnet, tnet = _pair("QIDDM_PL_noise1", (784, 8, 6, 2), seed=1)
    first_x = (np.random.default_rng(1).uniform(size=(16, 1, 28, 28))
               * 0.75 + 0.5).astype(np.float32)
    stack = np.array(JDiffusion(jnet).eval().sample_stack_fn(
        jnet.variables, jnp.asarray(first_x), 3))
    assert stack.shape == (4, 16, 1, 28, 28)
    with torch.no_grad():
        for t in range(3):
            got = tnet(torch.as_tensor(stack[t])).numpy()
            np.testing.assert_allclose(got, stack[t + 1], atol=IMAGE_TOL)


# --- the drivers -------------------------------------------------------------

def test_mnist_exm_trains_and_sample_serves_qiddm_pl_noise1(tmp_path,
                                                          monkeypatch):
    from qiddm_tpu_torch.cli import common as tcommon
    from qiddm_tpu_torch.cli import mnist_exm as tmnist

    # the JAX drivers' rates: QIDDM_PL_noise1 has no default of its own
    args = tmnist.parse_args([])
    assert tcommon.model_lr(args, "QIDDM_PL_noise1") == 0.01
    assert tcommon.model_lr(args, "QIDDM_PL_noise") == 0.01116

    # mnist_exm tees stdout and stderr into its log: undone afterwards
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    out = tmnist.main([
        "--data", "mnist_8x8", "--img_size", "8",
        "--model", "QIDDM_PL_noise1", "64", "4", "2", "2",
        "--ds-size", "60", "--epochs", "1", "--batch_size", "2",
        "--tau", "3", "--device", "cpu",
        "--save-path", f"{tmp_path}/run_", "--load-path", f"{tmp_path}/run_"])
    losses = out["QIDDM_PL_noise1"]["loss"][0]
    assert len(losses) == 1 and np.isfinite(losses).all()
    ckpt = tmp_path / "run_4" / "noise_0" / "QIDDM_PL_noise=4_L=2_N=2_4.pt"
    assert ckpt.exists()
    # the JAX package reads it into its own QIDDM_PL_noise1
    jdiff = JDiffusion(jnn.QIDDM_PL_noise1(64, 4, 2, 2, seed=9),
                       shape=(8, 8))
    assert jckpt.load_diffusion(jdiff, ckpt.parent, 4)[1] == 1
    imgs = tsample.main(["--ckpt", str(ckpt), "--model", "QIDDM_PL_noise1",
                         "64", "4", "2", "2", "--img_size", "8", "--n", "6",
                         "--iters", "2", "--device", "cpu", "--out",
                         str(tmp_path / "out")])
    assert imgs.shape == (6, 1, 8, 8) and np.isfinite(imgs).all()
