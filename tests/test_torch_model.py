"""QIDDM_LL_noise in qiddm_tpu_torch against the JAX shim, with the JAX
weights carried across, and checkpoints shared between the two packages.

On the CPU the JAX engine takes its per-layer-unitary route
(qiddm_tpu/sim/engine.py:522-549) and the port its plain gate chain, so the
forward pass compares two independent formulations. Tolerance: <= 1e-4 on
the output images — 784 outputs of a 6 -> 784 linear over N=2 blocks of
28 gate layers in float32.
"""

import jax
import numpy as np
import pytest
import torch

from qiddm_tpu import ckpt as jckpt
from qiddm_tpu import nn as jnn
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch.nn import QIDDM_LL_noise

TOL = 1e-4


def _jax_tree(net):
    return jax.tree_util.tree_map(np.asarray, net.variables)


def _trees_equal(a, b):
    return (jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
            and all(np.array_equal(x, y) for x, y in
                    zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b))))


@pytest.mark.parametrize("args", [(784, 6, 14, 2), (64, 4, 3, 2)])
def test_forward_matches_jax(args):
    jnet = jnn.QIDDM_LL_noise(*args, seed=3)
    tnet = QIDDM_LL_noise(*args, seed=5, device="cpu")
    tckpt.load_jax_variables(tnet, _jax_tree(jnet))
    side = int(np.sqrt(args[0]))
    img = np.random.default_rng(0).uniform(
        size=(5, 1, side, side)).astype(np.float32)
    want = np.asarray(jnet(img))
    with torch.no_grad():
        got = tnet(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == (5, 1, side, side)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("args", [(784, 6, 14, 2), ("8 * 8", 4, 3, "2")])
def test_save_name_and_param_count_match_jax(args):
    jnet = jnn.QIDDM_LL_noise(*args)
    tnet = QIDDM_LL_noise(*args, device="cpu")
    assert tnet.save_name() == jnet.save_name()
    assert tnet.num_params() == jnet.num_params()


def test_seed_fixes_weights():
    a, b, c = (tckpt.export_jax_variables(
        QIDDM_LL_noise(64, 4, 3, 2, seed=s, device="cpu")) for s in (1, 1, 2))
    assert _trees_equal(a, b)
    assert not _trees_equal(a, c)


def test_unported_options_raise():
    """Noise is ported (add_noise 1-4 build and run), and so is the
    Monte-Carlo trajectory backend, which raises without a random source
    and runs past the SEL-chain kernel's 12 wires on ``sel_apply_gates``."""
    from qiddm_tpu_torch.sim import engine as tengine

    net = QIDDM_LL_noise(64, 4, 3, 2, 1, device="cpu")
    assert net.module.add_noise == 1
    noise = tengine.noise_from_code(1, "qiddm")
    with pytest.raises(ValueError, match="random source"):
        tengine.reupload_block(torch.zeros(2, 4), torch.zeros(3, 2, 4, 3),
                               noise=noise, n_traj=8)
    gen = torch.Generator().manual_seed(0)
    out = tengine.reupload_block(torch.zeros(2, 4), torch.zeros(3, 2, 4, 3),
                                 noise=noise, n_traj=8, traj_rng=gen)
    assert out.shape == (2, 16) and torch.isfinite(out).all()
    tengine.reset_route_calls()
    out = tengine.reupload_block(torch.zeros(2, 13), torch.zeros(1, 2, 13, 3),
                                 noise=noise, n_traj=8, traj_rng=gen)
    assert out.shape == (2, 2**13) and torch.isfinite(out).all()
    # zero angles leave |0...0>; phase damping changes no probability
    assert torch.allclose(out[:, 0], torch.ones(2))
    assert tengine.ROUTE_CALLS["gates"] == 1


def test_jax_checkpoint_round_trips_through_port(tmp_path):
    jnet = jnn.QIDDM_LL_noise(784, 6, 14, 2, seed=7)
    path = jckpt.save_checkpoint(tmp_path / "jax.pt", jnet.variables,
                                 [0.5, 0.25], 4)
    tnet = QIDDM_LL_noise(784, 6, 14, 2, device="cpu")
    blob = tckpt.load_checkpoint(path)
    assert blob["loss_values"] == [0.5, 0.25] and blob["epochs"] == 4
    tckpt.load_jax_variables(tnet, blob["model_state_dict"])
    back = tckpt.export_jax_variables(tnet)
    assert _trees_equal(back, _jax_tree(jnet))
    # and the port's file reads in the JAX package
    out = tckpt.save_checkpoint(tmp_path / "torch.pt", back, [0.1], 1)
    reread = jckpt.load_checkpoint(out)
    assert reread["loss_values"] == [0.1] and reread["epochs"] == 1
    assert _trees_equal(reread["model_state_dict"], _jax_tree(jnet))


def test_load_rejects_unknown_missing_and_misshapen_keys():
    tnet = QIDDM_LL_noise(64, 4, 3, 2, device="cpu")
    good = tckpt.export_jax_variables(tnet)
    extra = {"params": {**good["params"], "bn": {"scale": np.ones(4)}}}
    with pytest.raises(ValueError, match="unknown"):
        tckpt.load_jax_variables(tnet, extra)
    missing = {"params": {k: v for k, v in good["params"].items()
                          if k != "linear_up"}}
    with pytest.raises(ValueError, match="missing"):
        tckpt.load_jax_variables(tnet, missing)
    bad = {"params": {**good["params"], "qweights": np.zeros((2, 3, 2, 5, 3))}}
    with pytest.raises(ValueError, match="does not fit"):
        tckpt.load_jax_variables(tnet, bad)


# a small configuration of every model class of qiddm_tpu_torch.nn
SMALL_MODELS = {
    "QDenseUndirected_old": (2, 8), "QDenseUndirected_old_noise": (2, 8),
    "QNN_A": (2, 8), "QNN_noise": (64, 3, 2), "QNN": (64, 3, 2),
    "differN_noise": (8, 2, 1), "differN_noise_befor": (8, 2, 1),
    "QIDDM_LL_noise": (64, 3, 2, 2), "QIDDM_PL": (64, 3, 2, 2),
    "QIDDM_PL_old": (64, 3, 2, 2), "QIDDM_PL_noise": (64, 3, 2, 2),
    "QIDDM_PL_noise1": (64, 3, 2, 2),
    "differN_old_pca": (8, 2, 1), "differN_new_pca": (8, 2, 1),
    "differN_new_conv": (8, 2, 1), "differN_old_conv": (8, 2, 1),
    "QIDDM_A_sameN": (8, 2, 1), "QIDDM_A_differN_basePL": (8, 2, 1),
    "QIDDM_A_differN_NEW": (8, 2, 1), "QIDDM_LL_relu_noise": (64, 3, 2, 2),
    "QIDDM_LL_old": (64, 3, 2, 2), "QIDDM_L": (64, 3, 2, 2),
    "QIDDM_bias_false": (64, 3, 2, 2), "QIDDM_L_B": (64, 3, 2, 2),
    "QIDDM_CL_new": (64, 3, 2, 2), "QIDDM_CL_old": (64, 3, 2, 2),
    "QIDDM_PP_noise": (64, 3, 2, 2), "QIDDM_PP_old": (64, 3, 2, 2),
    "UNetUndirected": (2, 2, 1, 0, (8, 8)),
    "UNetUndirectedS": (2, 2, 1, 0, (8, 8)),
    "UnetDirected": (2, 2, 0, 0, (8, 8)),
    "UnetDirectedS": (2, 2, 1, 0, (8, 8)),
    "DeepConvUndirected": ([1, 2, 1], (8, 8)),
    "DeepConvDirectedMulti": ([1, 2, 1], (8, 8)),
    "DeepConvDirectedSingle": ([1, 2, 1], (8, 8))}


def test_small_models_cover_every_class():
    from qiddm_tpu_torch.cli.common import MODEL_REGISTRY

    assert set(SMALL_MODELS) == set(MODEL_REGISTRY)


@pytest.mark.parametrize("name", sorted(SMALL_MODELS))
def test_model_classes_default_to_the_card(name):
    """Built with no device, a model class goes to the card: on a host
    without CUDA it raises naming the device rather than fall back to the
    CPU; with ``device="cpu"`` the same class builds and runs there."""
    from qiddm_tpu_torch import nn as tnn

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-fallback check needs a "
                    "host without it")
    cls = getattr(tnn, name)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        cls(*SMALL_MODELS[name])
    net = cls(*SMALL_MODELS[name], device="cpu")
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    img = torch.rand(10, 1, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        # the directed conv classes take their labels beside the images
        out = (net(img, torch.arange(10)) if getattr(net, "directed", False)
               else net(img))
    assert out.shape == img.shape and torch.isfinite(out).all()
