"""The rest of the dense model zoo in qiddm_tpu_torch — the differN family
(PCA, conv and no down-projection, per-block post-processing, shared block
weights, the pi/2-scaled RZ encode) and the QIDDM-L family (conv down,
inverse-PCA up, a lazily fitted PCA, BatchNorm, bias-free and k = 3) —
against qiddm_tpu on the CPU, with the JAX variables (``params``,
``batch_stats``, ``pca_state``) carried across by ``load_jax_variables``.

Each of the 16 classes at a small size (8x8 images, L 2, N 2): the
forward, ``save_name``/``num_params``/attributes, a JAX -> port -> JAX
checkpoint round trip, and one training step against ``jax.grad`` with the
BatchNorm running statistics after it; one sampling run step by step for
each new option; flax's BatchNorm update and the conv kernel's layout on
their own, each at inputs where the wrong port would fail; every class of
the JAX zoo in the port's registry; and ``mnist_exm`` training the
lazily fitted PCA model on the driver's init batch.

PCA batches hold at least ``hidden + 2`` rows (see
tests/test_torch_pl_models.py). Tolerances, as there: images 1e-4, the
training loss 1e-5 relative, each gradient within 1e-4 of its own max
norm (``qweights`` a block at a time), or of the largest gradient's where
its own is below 1e-6 of that (a gradient that is zero but for rounding);
BatchNorm statistics 1e-5.
"""

import contextlib
import functools
import inspect
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import ckpt as jckpt
from qiddm_tpu.cli import common as jcommon
from qiddm_tpu import nn as jnn
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu.nn import qdense as jqdense
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import config as tconfig
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch.cli import common as tcommon
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.nn import core as tcore
from qiddm_tpu_torch.nn import layers as tlayers

IMAGE_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STAT_TOL = 1e-5
GRAD_FLOOR = 1e-6   # below this share of the largest, a gradient is ~zero

# (name, small ctor args, forward batch)
ZOO = [
    ("differN_old_pca", (8, 2, 2), 10),
    ("differN_new_pca", (8, 2, 2), 10),
    ("differN_new_conv", (8, 2, 2), 6),
    ("differN_old_conv", (8, 2, 2), 6),
    ("QIDDM_A_sameN", (8, 2, 2), 6),
    ("QIDDM_A_differN_basePL", (8, 2, 2), 10),
    ("QIDDM_A_differN_NEW", (8, 2, 2), 10),
    ("QIDDM_LL_relu_noise", (64, 4, 2, 2), 6),
    ("QIDDM_LL_old", (64, 4, 2, 2), 6),
    ("QIDDM_L", (64, 4, 2, 2), 6),
    ("QIDDM_bias_false", (64, 4, 2, 2), 6),
    ("QIDDM_L_B", (64, 4, 2, 2), 6),
    ("QIDDM_CL_new", (64, 4, 2, 2), 6),
    ("QIDDM_CL_old", (64, 4, 2, 2), 6),
    ("QIDDM_PP_noise", (64, 4, 2, 2), 8),
    ("QIDDM_PP_old", (64, 4, 2, 2), 6),
]
NAMES = [z[0] for z in ZOO]
ATTRS = ("hidden_features", "spectrum_layer", "N", "add_noise", "wires")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small float32 ops by the thousand: a thread pool in each of the
    test processes oversubscribes the cores. One thread gives the same
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_net(name, args, seed=3):
    """One JAX model a configuration, so its jitted applies compile once
    per module."""
    return getattr(jnn, name)(*args, seed=seed)


def _jax_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _trees_equal(a, b):
    return (jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
            and all(np.array_equal(x, y) for x, y in
                    zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b))))


def _port(name, args, variables):
    net = getattr(tnn, name)(*args, seed=11, device="cpu")
    tckpt.load_jax_variables(net, _jax_tree(variables))
    return net


def _images(batch, shape, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(batch, 1, *shape)).astype(np.float32)


@pytest.mark.parametrize("name,args,batch", ZOO, ids=NAMES)
def test_forward_matches_jax(name, args, batch):
    jnet = _jax_net(name, args)
    tnet = _port(name, args, jnet.variables)
    img = _images(batch, tnet.img_shape)
    want = np.asarray(jnet(img))
    with torch.no_grad():
        got = tnet(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL)


@pytest.mark.parametrize("name,args,batch", ZOO, ids=NAMES)
def test_save_name_param_count_and_attributes_match_jax(name, args, batch):
    jnet = _jax_net(name, args)
    tnet = getattr(tnn, name)(*args, device="cpu")
    assert tnet.save_name() == jnet.save_name()
    assert tnet.num_params() == jnet.num_params()
    for attr in ATTRS:
        assert hasattr(tnet, attr) == hasattr(jnet, attr), attr
        if hasattr(jnet, attr):
            assert getattr(tnet, attr) == getattr(jnet, attr), attr
    # the JAX signature, the port's keyword-only device besides
    want = list(inspect.signature(getattr(jnn, name).__init__).parameters)
    got = list(inspect.signature(getattr(tnn, name).__init__).parameters)
    assert got == want + ["device"]


@pytest.mark.parametrize("name,args,batch", ZOO, ids=NAMES)
def test_jax_checkpoint_round_trips_through_port(tmp_path, name, args,
                                                 batch):
    jnet = _jax_net(name, args)
    tree = _jax_tree(jnet.variables)
    if "batch_stats" in tree:  # statistics away from their init values
        rng = np.random.default_rng(5)
        for stats in tree["batch_stats"].values():
            stats["mean"] = rng.normal(size=stats["mean"].shape).astype(
                np.float32)
            stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(
                np.float32)
    path = jckpt.save_checkpoint(tmp_path / "jax.pt", tree, [0.5], 3)
    tnet = getattr(tnn, name)(*args, device="cpu")
    tckpt.load_jax_variables(tnet,
                             tckpt.load_checkpoint(path)["model_state_dict"])
    back = tckpt.export_jax_variables(tnet)
    assert _trees_equal(back, tree)
    out = tckpt.save_checkpoint(tmp_path / "torch.pt", back, [0.1], 1)
    assert _trees_equal(jckpt.load_checkpoint(out)["model_state_dict"], tree)


def test_jax_variable_trees_are_the_ones_expected():
    """The collections and shapes the port carries, per the JAX trees."""
    flat = {"/".join(p): np.shape(v) for p, v in tckpt._flatten(
        _jax_tree(jnn.differN_old_conv(8, 2, 2).variables)).items()}
    assert flat["params/conv_down/Conv_0/kernel"] == (3, 3, 1, 6)
    assert flat["params/conv_down/Conv_0/bias"] == (6,)
    flat = tckpt._flatten(_jax_tree(jnn.QIDDM_L_B(64, 4, 2, 2).variables))
    assert {("params", "bn", "scale"), ("params", "bn", "bias"),
            ("batch_stats", "bn", "mean"),
            ("batch_stats", "bn", "var")} <= set(flat)
    flat = tckpt._flatten(_jax_tree(jnn.QIDDM_PP_old(64, 4, 2, 2).variables))
    assert flat[("pca_state", "components")].shape == (8, 64)
    assert {("params", "pca_bn", "scale"),
            ("batch_stats", "pca_bn", "var")} <= set(flat)
    flat = tckpt._flatten(_jax_tree(jnn.QIDDM_A_sameN(8, 2, 2).variables))
    assert flat[("params", "qweights")].shape == (2, 2, 6, 3)
    flat = tckpt._flatten(_jax_tree(
        jnn.QIDDM_bias_false(64, 4, 2, 2).variables))
    assert ("params", "linear_down", "bias") not in flat
    assert ("params", "linear_up", "bias") in flat
    net = tnn.QIDDM_bias_false(64, 4, 2, 2, device="cpu")
    assert net.module.linear_down.bias is None
    assert net.module.linear_up.bias is not None


# --- one training step -------------------------------------------------------

def _injecting(draw):
    """A ``noise_f`` that blends the JAX schedule's draw."""

    def noise_f(generator, data, tau, decay_mod):
        return tnoise.add_normal_noise_multiple(
            generator, data, tau, decay_mod,
            noise=torch.as_tensor(np.array(draw)))

    return noise_f


def _by_block(grads: dict) -> dict:
    """Flax-path gradients, with ``qweights`` split along its first axis."""
    out = {}
    for path, g in grads.items():
        if path[-1] == "qweights":
            out.update({path + (n,): g[n] for n in range(len(g))})
        else:
            out[path] = g
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@contextlib.contextmanager
def _x64():
    """Both packages in float64/complex128 (the per-layer route below
    2^wires in each), restored afterwards."""
    from qiddm_tpu import config as jconfig

    jconfig.enable_x64(True)
    tconfig.enable_x64(True)
    try:
        yield
    finally:
        jconfig.enable_x64(False)
        tconfig.enable_x64(False)


def check_training_step(jnet, tnet, batch, T, seed=4, dtype=np.float32):
    """One training loss, its gradients and the BatchNorm statistics it
    leaves, port against ``jax.grad`` of the JAX package's chain loss, in
    ``dtype`` (float64 needs ``_x64``). The port's net starts in eval
    mode: the loss must train it."""
    shape = tnet.img_shape
    x = np.random.default_rng(seed).uniform(
        size=(batch, shape[0] * shape[1])).astype(dtype)
    key = jax.random.PRNGKey(11)
    jdiff = JDiffusion(jnet, prediction_goal="data", shape=shape)
    cast = functools.partial(jax.tree_util.tree_map,
                             lambda a: jnp.asarray(a, dtype))

    def jloss(params):
        loss, (_, _, new_vars) = jdiff._chain_loss(
            params, cast(jnet.extra_variables), key, jnp.asarray(x), T)
        return loss, new_vars

    (want_loss, new_vars), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(cast(jnet.params))
    tnet.to(torch.float64 if dtype == np.float64 else torch.float32)
    tdiff = TDiffusion(tnet, _injecting(
        0.5 + 0.2 * jax.random.normal(key, x.shape, dtype=dtype)), "data",
        shape)
    assert not tnet.training
    tloss, _ = tdiff.loss_fn(torch.as_tensor(x), T)
    tloss.backward()
    assert not tnet.training  # the caller's mode comes back
    assert abs(tloss.item() - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    state = {**dict(tnet.module.named_parameters()),
             **dict(tnet.module.named_buffers())}
    got, want = {}, {}
    for pname, (path, layout) in tckpt._flax_paths(tnet).items():
        if path[0] == "params":
            got[path] = tckpt._to_flax(state[pname].grad.numpy(), layout)
            want[path] = _at(jgrads, path[1:])
        elif path[0] == "batch_stats":
            np.testing.assert_allclose(state[pname].numpy(),
                                       _at(new_vars, path), rtol=STAT_TOL,
                                       atol=STAT_TOL, err_msg=str(path))
    assert ("batch_stats" in new_vars) == any(
        p[0] == "batch_stats" for p, _ in tckpt._flax_paths(tnet).values())
    got, want = _by_block(got), _by_block(want)
    top = max(np.abs(w).max() for w in want.values())
    assert top > 0
    for key_, w in want.items():
        scale = np.abs(w).max()
        if scale < GRAD_FLOOR * top:
            # zero but for rounding: QIDDM_L_B's linear_down bias, which
            # the BatchNorm after it subtracts again
            scale = top
        err = np.abs(got[key_] - w).max()
        assert err <= GRAD_TOL * scale, (key_, err, scale)


@pytest.mark.parametrize("name,args,batch", ZOO, ids=NAMES)
def test_training_step_matches_jax_grad(name, args, batch):
    """A batch of 3 images, tau 3: 9 rows, below 2^wires (the gate chain's
    autograd Function). The BatchNorm classes' running statistics move as
    flax's do, QIDDM_L_B's once a block.

    QIDDM_L_B runs in float64 in both packages. Its BatchNorm before the
    second block normalises the first block's PauliZ outputs, whose batch
    variance here is ~1e-4 in some wires, and flax's variance
    E[x^2] - E[x]^2 cancels ~4 digits there: in float32 the port's own
    gradient of the first block lies 2.5e-4 (relative to its max norm)
    from its float64 gradient, as JAX's does, so two float32
    implementations cannot be held to 1e-4 at this point. In float64 they
    are held at the same tolerances as the rest; the float32 route of a
    k = 3 block is QIDDM_bias_false's."""
    jnet = _jax_net(name, args)
    tnet = _port(name, args, jnet.variables)
    if name != "QIDDM_L_B":
        check_training_step(jnet, tnet, 3, 3)
        return
    with _x64():
        check_training_step(jnet, tnet, 3, 3, dtype=np.float64)


# --- sampling ----------------------------------------------------------------

# one class for each new option
SAMPLED = [
    ("differN_old_conv", (8, 2, 2)),         # conv down
    ("QIDDM_A_sameN", (8, 2, 2)),            # no down, shared weights
    ("differN_new_pca", (8, 2, 2)),          # post-processed each block
    ("QIDDM_A_differN_basePL", (8, 2, 2)),   # the pi/2-scaled RZ encode
    ("QIDDM_L_B", (64, 4, 2, 2)),            # BatchNorm, k = 3
    ("QIDDM_bias_false", (64, 4, 2, 2)),     # no linear_down bias
    ("QIDDM_PP_noise", (64, 4, 2, 2)),       # inverse-PCA up
    ("QIDDM_PP_old", (64, 4, 2, 2)),         # lazy PCA(2h), BN, Linear
]


@pytest.mark.parametrize("name,args", SAMPLED, ids=[s[0] for s in SAMPLED])
def test_sampling_matches_jax_step_by_step(name, args):
    """Three sampling iterations, each from JAX's batch: the port's
    sampler maps JAX's batch t to JAX's batch t+1. The BatchNorm classes
    run with statistics away from their init values and with the port's
    net left in train mode: sampling evaluates all the same."""
    jnet = _jax_net(name, args)
    variables = jnet.variables
    if "batch_stats" in variables:
        rng = np.random.default_rng(8)
        variables = _jax_tree(variables)
        for stats in variables["batch_stats"].values():
            stats["mean"] = rng.normal(
                scale=0.3, size=stats["mean"].shape).astype(np.float32)
            stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(
                np.float32)
    tnet = _port(name, args, variables)
    shape = tnet.img_shape
    first_x = (np.random.default_rng(1).uniform(size=(8, 1, *shape)) * 0.75
               + 0.5).astype(np.float32)
    stack = np.array(JDiffusion(jnet, shape=shape).sample_stack_fn(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(first_x),
        3))
    assert stack.shape == (4, 8, 1, *shape)
    tdiff = TDiffusion(tnet, shape=shape)
    tnet.train()
    before = {n: b.clone() for n, b in tnet.module.named_buffers()}
    for t in range(3):
        got = tdiff.sample_stack_fn(torch.as_tensor(stack[t]), 1)[1].numpy()
        np.testing.assert_allclose(got, stack[t + 1], atol=IMAGE_TOL,
                                   err_msg=f"iteration {t + 1}")
    assert tnet.training
    for n, b in tnet.module.named_buffers():
        assert torch.equal(b, before[n]), n


# --- the layers on their own -------------------------------------------------

def test_batchnorm_running_variance_is_flax_biased_update():
    """flax's BatchNorm over a batch of 3 rows: the output and the running
    statistics after one training call. The unbiased running variance
    (torch.nn.BatchNorm1d's) is 3/2 of the biased one and misses."""
    import flax.linen as fnn

    x = np.random.default_rng(2).normal(1.0, 2.0, (3, 5)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    scale = np.random.default_rng(3).uniform(0.5, 1.5, 5).astype(np.float32)
    bias = np.random.default_rng(4).normal(size=5).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.full(5, 0.2, np.float32),
                                 "var": np.full(5, 1.5, np.float32)}}
    want, new = bn.apply(variables, x, mutable=["batch_stats"])
    port = tlayers.FlaxBatchNorm(5).train()
    with torch.no_grad():
        port.weight.copy_(torch.as_tensor(scale))
        port.bias.copy_(torch.as_tensor(bias))
        port.running_mean.fill_(0.2)
        port.running_var.fill_(1.5)
    got = port(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=STAT_TOL)
    want_var = np.asarray(new["batch_stats"]["var"])
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               rtol=STAT_TOL)
    np.testing.assert_allclose(port.running_var.numpy(), want_var,
                               rtol=STAT_TOL)
    torch_bn = torch.nn.BatchNorm1d(5, momentum=0.1, eps=1e-5)
    with torch.no_grad():
        torch_bn.running_mean.fill_(0.2)
        torch_bn.running_var.fill_(1.5)
    torch_bn(torch.as_tensor(x))
    assert not np.allclose(torch_bn.running_var.numpy(), want_var,
                           rtol=1e-2)
    # eval: the running statistics
    port.eval()
    want = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                         epsilon=1e-5).apply(
        {"params": variables["params"], **new}, x)
    np.testing.assert_allclose(port(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(want), atol=STAT_TOL)


def test_conv_kernel_maps_by_axis_not_by_transpose():
    """A conv kernel whose values are not symmetric in kh and kw: the port
    reads flax's (kh, kw, I, O) as (O, I, kh, kw), and the layer's output
    is flax's. Reading it with ``.T`` (every axis reversed, so kh and kw
    swap) fits the shape and gives another output; through a model, the
    checkpoint's conv_down/Conv_0 kernel lands where the layer reads it."""
    from qiddm_tpu.nn.layers import TorchConv as JConv

    x = _images(4, (8, 8), seed=6)
    jconv = JConv(6, kernel_size=(3, 3), strides=(2, 2), padding=(1, 1))
    variables = _jax_tree(jconv.init(jax.random.PRNGKey(1), x))
    kernel = variables["params"]["Conv_0"]["kernel"]
    assert kernel.shape == (3, 3, 1, 6)
    assert np.abs(kernel - kernel.transpose(1, 0, 2, 3)).max() > 0.1
    want = np.asarray(jconv.apply(variables, x))
    port = tlayers.TorchConv(1, 6, kernel_size=(3, 3), stride=(2, 2),
                             padding=(1, 1),
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port.bias.copy_(torch.as_tensor(variables["params"]["Conv_0"]["bias"]))
        port.weight.copy_(torch.as_tensor(tckpt._to_port(kernel, "conv")))
        got = port(torch.as_tensor(x)).numpy()
        port.weight.copy_(torch.as_tensor(kernel.T.copy()))
        wrong = port(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (4, 6, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(wrong - want).max() > 0.1
    jnet = _jax_net("differN_old_conv", (8, 2, 2))
    tree = _jax_tree(jnet.variables)
    tnet = _port("differN_old_conv", (8, 2, 2), tree)
    np.testing.assert_array_equal(
        tnet.module.conv_down.weight.detach().numpy(),
        tree["params"]["conv_down"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))


# --- the registry, the options, the driver -----------------------------------

def test_every_jax_class_is_in_the_port_registry():
    jax_classes = {
        name for name, obj in vars(jqdense).items()
        if isinstance(obj, type) and issubclass(obj, jnn.DenoiserShim)
        and obj.__module__ == jqdense.__name__ and not name.startswith("_")}
    assert len(jax_classes) == 28
    assert jax_classes <= set(tcommon.MODEL_REGISTRY)
    # and the rest of the JAX drivers' registry: the U-Net and conv classes
    assert set(jcommon.MODEL_REGISTRY) == set(tcommon.MODEL_REGISTRY)
    assert len(tcommon.MODEL_REGISTRY) == 35


def test_unknown_options_raise_value_error():
    gen = torch.Generator().manual_seed(0)
    for kw in ({"down": "svd"}, {"up": "conv"}, {"readout": "amps"},
               {"encode": "rx"}, {"noise_family": "nope"}):
        with pytest.raises(ValueError, match="unknown"):
            tcore.Reupload(4, 2, 1, generator=gen, shape=(8, 8), **kw)


def test_lazy_pca_fits_the_init_batch_once():
    """QIDDM_PP_old fits its PCA on the init batch (or, without one, on 32
    uniform images from ``seed + 1``); training leaves it alone."""
    rng = np.random.default_rng(3)
    batch = rng.uniform(size=(20, 1, 8, 8)).astype(np.float32)
    net = tnn.QIDDM_PP_old(64, 4, 2, 2, init_batch=batch, device="cpu")
    jnet = jnn.QIDDM_PP_old(64, 4, 2, 2, init_batch=batch)
    for leaf in ("mean", "components"):
        np.testing.assert_allclose(
            getattr(net.module.pca_state, leaf).numpy(),
            np.asarray(jnet.variables["pca_state"][leaf]), atol=1e-5)
    other = tnn.QIDDM_PP_old(64, 4, 2, 2, seed=1, device="cpu")
    again = tnn.QIDDM_PP_old(64, 4, 2, 2, seed=1, device="cpu")
    assert not torch.equal(other.module.pca_state.mean,
                           net.module.pca_state.mean)
    assert torch.equal(other.module.pca_state.components,
                       again.module.pca_state.components)
    before = net.module.pca_state.components.clone()
    diff = TDiffusion(net, shape=(8, 8))
    opt = torch.optim.Adam(diff.parameters(), lr=0.1)
    diff.make_train_step(opt, 2)(torch.as_tensor(batch[:4].reshape(4, -1)),
                                 torch.Generator().manual_seed(0))
    assert torch.equal(net.module.pca_state.components, before)
    assert "pca_state.components" not in dict(net.named_parameters())


def test_mnist_exm_trains_qiddm_pp_old_on_its_init_batch(tmp_path,
                                                        monkeypatch):
    """The driver passes x_train[:32] as the init batch: the checkpoint's
    PCA is the fit of the training images, and the JAX package serves
    it."""
    from qiddm_tpu_torch.cli import mnist_exm as tmnist

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    out = tmnist.main([
        "--data", "mnist_8x8", "--img_size", "8",
        "--model", "QIDDM_PP_old", "64", "4", "2", "2",
        "--ds-size", "60", "--epochs", "1", "--batch_size", "2",
        "--tau", "3", "--device", "cpu",
        "--save-path", f"{tmp_path}/run_", "--load-path", f"{tmp_path}/run_"])
    losses = out["QIDDM_PP_old"]["loss"][0]
    assert len(losses) == 1 and np.isfinite(losses).all()
    ckpt = (tmp_path / "run_4" / "noise_0"
            / "QIDDM_PP_features=4_L=2_N=2_4.pt")
    tree = tckpt.load_checkpoint(ckpt)["model_state_dict"]
    args = tmnist.parse_args(["--data", "mnist_8x8", "--ds-size", "60"])
    x, y, h, w = tcommon.load_dataset(args)
    x_lab = x[y == 4]
    x_train = x_lab[:int(len(x_lab) * 0.8)]
    fitted = tnn.QIDDM_PP_old(
        64, 4, 2, 2, init_batch=x_train[:32].reshape(-1, 1, h, w),
        device="cpu")
    np.testing.assert_array_equal(tree["pca_state"]["components"],
                                  fitted.module.pca_state.components.numpy())
    jdiff = JDiffusion(jnn.QIDDM_PP_old(64, 4, 2, 2, seed=9), shape=(8, 8))
    assert jckpt.load_diffusion(jdiff, ckpt.parent, 4)[1] == 1
    np.testing.assert_array_equal(
        np.asarray(jdiff.net.variables["pca_state"]["components"]),
        tree["pca_state"]["components"])
