"""The U-Net and conv family in qiddm_tpu_torch against qiddm_tpu on the
CPU, with the JAX weights and BatchNorm statistics carried across by
``load_jax_variables``: the three DeepConv classes, the four U-Net classes
at small sizes (quantum and classical convs, the simple blocks, the label
mask, a side that ``autopad`` pads), ``UNetUndirected(3, 8, 3)`` at 28x28
(the JAX bench's configuration), checkpoints in the JAX pickle layout, and
the training driver and the sampling CLI on the CPU.

For each U-Net: the forward in eval mode, one training step (the
``Diffusion`` loss on the JAX schedule's noise draw against ``jax.grad``;
for a directed class an MSE with its labels, as no ``Diffusion`` passes
labels), the BatchNorm statistics after it, sampling step by step, and
the save name.

Tolerances: images 1e-5 (forwards) and 1e-4 (sampling), the loss 1e-5
relative, each gradient within 1e-4 of its parameter's max |g| (of the
model's largest where the parameter's own is below GRAD_FLOOR of it: a
conv bias that a BatchNorm follows, whose gradient is zero up to
rounding), BatchNorm statistics 1e-5.
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
from qiddm_tpu import config as jconfig
from qiddm_tpu import nn as jnn
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import config as tconfig
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion

VALUE_TOL = 1e-5
SAMPLE_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STAT_TOL = 1e-5
GRAD_FLOOR = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread per test process: a thread pool in each oversubscribes
    the cores beside the other workers. One thread gives the same
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (class, ctor args, image side, directed)
UNETS = [
    ("UNetUndirected", (2, 2, 1), 8),
    ("UNetUndirected", (3, 8, 0), 16),
    ("UNetUndirectedS", (2, 2, 1), 8),
    ("UnetDirected", (2, 4, 0), 8),
    # 10 -> 5 -> 2 down, 2 -> 4 up against the skip's 5: autopad pads
    ("UNetUndirected", (3, 2, 1), 10),
]
UNET_IDS = [f"{n}-{'-'.join(map(str, a))}-{s}x{s}" for n, a, s in UNETS]


@functools.lru_cache(maxsize=None)
def _jax_net(name, args, side):
    return getattr(jnn, name)(*args, seed=3, img_shape=(side, side))


def _jax_tree(variables):
    return jax.tree_util.tree_map(np.array, variables)


def _trees_equal(a, b):
    return (jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
            and all(np.array_equal(x, y) for x, y in
                    zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b))))


def _moved_stats(tree, seed=8):
    """``tree`` with its BatchNorm statistics away from their init values."""
    tree = _jax_tree(tree)
    rng = np.random.default_rng(seed)

    def move(node):
        for key, value in node.items():
            if key == "mean":
                node[key] = rng.normal(scale=0.3, size=value.shape).astype(
                    np.float32)
            elif key == "var":
                node[key] = rng.uniform(0.5, 2.0, value.shape).astype(
                    np.float32)
            else:
                move(value)

    move(tree["batch_stats"])
    return tree


def _port(name, args, side, variables):
    net = getattr(tnn, name)(*args, seed=11, img_shape=(side, side),
                             device="cpu")
    tckpt.load_jax_variables(net, _jax_tree(variables))
    return net


def _images(batch, side, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(batch, 1, side, side)).astype(np.float32)


def _labels(batch):
    return np.arange(batch) % 10


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _check_grads(tnet, jgrads):
    """The port's ``.grad`` of every parameter against ``jgrads`` (the flax
    params tree)."""
    params = dict(tnet.module.named_parameters())
    got, want = {}, {}
    for pname, (path, layout) in tckpt._flax_paths(tnet).items():
        if path[0] == "params":
            got[path] = tckpt._to_flax(params[pname].grad.numpy(), layout)
            want[path] = _at(jgrads, path[1:])
    top = max(np.abs(w).max() for w in want.values())
    assert top > 0
    for path, w in want.items():
        scale = max(np.abs(w).max(), GRAD_FLOOR * top)
        err = np.abs(got[path] - w).max()
        assert err <= GRAD_TOL * scale, (path, err, scale)


def _check_stats(tnet, new_vars):
    buffers = dict(tnet.module.named_buffers())
    paths = tckpt._flax_paths(tnet)
    held = 0
    for pname, (path, _) in paths.items():
        if path[0] == "batch_stats":
            np.testing.assert_allclose(buffers[pname].numpy(),
                                       _at(new_vars, path), rtol=STAT_TOL,
                                       atol=STAT_TOL, err_msg=str(path))
            held += 1
    assert held > 0


def _injecting(draw):
    """A ``noise_f`` that blends the JAX schedule's draw."""

    def noise_f(generator, data, tau, decay_mod):
        return tnoise.add_normal_noise_multiple(
            generator, data, tau, decay_mod, noise=torch.as_tensor(draw))

    return noise_f


@contextlib.contextmanager
def _x64():
    """Both packages in float64/complex128, restored afterwards."""
    jconfig.enable_x64(True)
    tconfig.enable_x64(True)
    try:
        yield
    finally:
        jconfig.enable_x64(False)
        tconfig.enable_x64(False)


def check_training_step(jnet, tnet, batch, tau, side, seed=4,
                        dtype=np.float32):
    """One training loss on ``batch`` images, its gradients and the
    BatchNorm statistics it leaves, in ``dtype`` (float64 needs
    ``_x64``), against ``jax.grad`` of the JAX package's loss on the same
    noise. The port's net starts in eval mode: the loss trains it, and the
    caller's mode comes back."""
    x = np.random.default_rng(seed).uniform(
        size=(batch, side * side)).astype(dtype)
    key = jax.random.PRNGKey(11)
    draw = np.array(jax.random.normal(key, x.shape, dtype=dtype))
    cast = functools.partial(jax.tree_util.tree_map,
                             lambda a: jnp.asarray(a, dtype))
    extra = cast(jnet.extra_variables)
    tnet.to(torch.float64 if dtype == np.float64 else torch.float32)
    assert not tnet.training
    if tnet.directed:  # an MSE of the labelled forward against the images
        y = _labels(batch)
        img = x.reshape(batch, 1, side, side)
        noisy = np.clip(img + 0.2 * draw.reshape(img.shape), 0.0, 1.0)

        def jloss(params):
            out, new = jnet.module.apply(
                {"params": params, **extra}, jnp.asarray(noisy),
                jnp.asarray(y), train=True, mutable=["batch_stats"])
            return jnp.mean((out - img) ** 2), new

        tnet.train()
        tloss = ((tnet(torch.as_tensor(noisy), torch.as_tensor(y))
                  - torch.as_tensor(img)) ** 2).mean()
        tnet.eval()
    else:
        jdiff = JDiffusion(jnet, prediction_goal="data", shape=(side, side))

        def jloss(params):
            loss, (_, _, new) = jdiff._chain_loss(
                params, extra, key, jnp.asarray(x), tau)
            return loss, new

        tdiff = TDiffusion(tnet, _injecting(0.5 + 0.2 * draw), "data",
                           (side, side))
        tloss, _ = tdiff.loss_fn(torch.as_tensor(x), tau)
    (want_loss, new_vars), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(cast(jnet.params))
    tloss.backward()
    assert not tnet.training
    assert abs(tloss.item() - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    _check_grads(tnet, jgrads)
    _check_stats(tnet, new_vars)


# --- the DeepConv baselines --------------------------------------------------

DEEP = [("DeepConvUndirected", ([1, 4, 4, 1], (8, 8))),
        ("DeepConvDirectedMulti", ([1, 4, 1], (8, 8))),
        ("DeepConvDirectedSingle", ([1, 4, 1], (8, 8)))]


@pytest.mark.parametrize("name,args", DEEP, ids=[d[0] for d in DEEP])
def test_deep_conv_forward_matches_jax(name, args):
    jnet = getattr(jnn, name)(*args, seed=2)
    tnet = getattr(tnn, name)(*args, seed=7, device="cpu")
    tckpt.load_jax_variables(tnet, _jax_tree(jnet.variables))
    assert tnet.save_name() == jnet.save_name()
    assert tnet.num_params() == jnet.num_params()
    assert tnet.directed == jnet.directed
    img = _images(3, 8)
    y = np.array([0, 3, 7])
    want = np.asarray(jnet(img, y) if jnet.directed else jnet(img))
    with torch.no_grad():
        got = (tnet(torch.as_tensor(img), torch.as_tensor(y))
               if tnet.directed else tnet(torch.as_tensor(img))).numpy()
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got, want, atol=VALUE_TOL)
    if tnet.directed:  # the labels reach the output
        with torch.no_grad():
            other = tnet(torch.as_tensor(img), torch.tensor([1, 1, 1]))
        assert not np.allclose(other.numpy(), got)
        with pytest.raises(ValueError, match="labels"):
            tnet(torch.as_tensor(img))


def test_deep_conv_rejects_unequal_end_channels():
    with pytest.raises(ValueError, match="must be equal"):
        tnn.DeepConvUndirected([1, 4, 2], (8, 8), device="cpu")


# --- the U-Nets at small size -----------------------------------------------

@pytest.mark.parametrize("name,args,side", UNETS, ids=UNET_IDS)
def test_unet_forward_matches_jax(name, args, side):
    """Eval mode, with BatchNorm statistics away from their init values."""
    jnet = _jax_net(name, args, side)
    variables = _moved_stats(jnet.variables)
    tnet = _port(name, args, side, variables)
    img = _images(3, side)
    y = _labels(3)
    apply = jax.jit(functools.partial(jnet.module.apply, train=False))
    want = np.asarray(apply(variables, jnp.asarray(img), jnp.asarray(y))
                      if jnet.directed else apply(variables, jnp.asarray(img)))
    with torch.no_grad():
        got = (tnet(torch.as_tensor(img), torch.as_tensor(y))
               if tnet.directed else tnet(torch.as_tensor(img))).numpy()
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got, want, atol=VALUE_TOL)


@pytest.mark.parametrize("name,args,side", UNETS, ids=UNET_IDS)
def test_unet_training_step_matches_jax_grad(name, args, side):
    """A batch of 2 images, tau 3 (6 rows); a directed class 4 labelled
    images. In float64 in both packages: a BatchNorm after a QConv
    normalises probabilities whose batch variance is small beside their
    square mean, and flax's variance E[x^2] - E[x]^2 cancels digits there:
    in float32 the port's own gradient of ``down0.bn0``'s scale at
    ``UNetUndirected(2, 2, 1)`` lies above 1e-4 (relative to its max norm)
    from its float64 gradient, so two float32 implementations cannot be
    held to 1e-4 at this size."""
    jnet = _jax_net(name, args, side)
    tnet = _port(name, args, side, jnet.variables)
    with _x64():
        check_training_step(jnet, tnet, 4 if tnet.directed else 2, 3, side,
                            dtype=np.float64)


@pytest.mark.parametrize("name,args,side", UNETS, ids=UNET_IDS)
def test_unet_sampling_matches_jax_step_by_step(name, args, side):
    """Three iterations, each from JAX's batch, with the port's net left in
    train mode: sampling evaluates all the same and moves no statistic. A
    directed class iterates its labelled forward."""
    jnet = _jax_net(name, args, side)
    variables = _moved_stats(jnet.variables)
    tnet = _port(name, args, side, variables)
    first_x = (_images(4, side, 1) * 0.75 + 0.5).astype(np.float32)
    tnet.train()
    before = {n: b.clone() for n, b in tnet.module.named_buffers()}
    if tnet.directed:
        y = _labels(4)
        apply = jax.jit(functools.partial(jnet.module.apply, train=False))
        stack = [first_x]
        for _ in range(3):
            stack.append(np.asarray(apply(variables, jnp.asarray(stack[-1]),
                                          jnp.asarray(y))))
        tnet.eval()
        step = lambda x: tnet(x, torch.as_tensor(y))  # noqa: E731
    else:
        stack = np.array(JDiffusion(jnet, shape=(side, side)).sample_stack_fn(
            jax.tree_util.tree_map(jnp.asarray, variables),
            jnp.asarray(first_x), 3))
        tdiff = TDiffusion(tnet, shape=(side, side))
        step = lambda x: tdiff.sample_stack_fn(x, 1)[1]  # noqa: E731
    with torch.no_grad():
        for t in range(3):
            got = step(torch.as_tensor(np.array(stack[t]))).numpy()
            np.testing.assert_allclose(got, stack[t + 1], atol=SAMPLE_TOL,
                                       err_msg=f"iteration {t + 1}")
    for n, b in tnet.module.named_buffers():
        assert torch.equal(b, before[n]), n


UNET_CLASSES = ["UNetUndirected", "UnetDirected", "UNetUndirectedS",
                "UnetDirectedS"]


@pytest.mark.parametrize("name", UNET_CLASSES)
def test_unet_names_params_and_signature_match_jax(name):
    # the simple blocks are QConvs whatever qdepth says: no qdepth 0
    for args in ((2, 2, 1), (3, 8, 3)) + (
            () if name.endswith("S") else ((3, 8, 0),)):
        jnet = _jax_net(name, args, 8)
        tnet = getattr(tnn, name)(*args, img_shape=(8, 8), device="cpu")
        assert tnet.save_name() == jnet.save_name()
        assert tnet.num_params() == jnet.num_params()
        assert tnet.directed == jnet.directed
        assert (tnet.depth, tnet.start_channels, tnet.qdepth) == args
    want = list(inspect.signature(getattr(jnn, name).__init__).parameters)
    got = list(inspect.signature(getattr(tnn, name).__init__).parameters)
    assert got == want + ["device"]


# --- UNetUndirected(3, 8, 3) at 28x28, the JAX bench's configuration --------

def test_full_width_unet_forward_and_training_step_match_jax():
    """13 QConv2d sites of 3 to 9 wires (the deepest 288 features): the
    eval forward on 8 images in float32, then one training step of 8
    images at tau 10 (80 rows, the bench's batch) in float64 in both
    packages. Its gradients are ill-conditioned in float32: each BatchNorm
    makes its input's gradient sum to zero over 6,272-62,720 positions,
    and a QConv's ``qweights`` gradient is what is left of that sum
    weighted by smooth patch derivatives, so float32 rounding of the
    BatchNorm backward reaches the weights' gradients at the per-cent
    level (chip_smoke.py's phase 37 prints the float32 floor beside the
    card's gradients)."""
    args, side = (3, 8, 3), 28
    jnet = _jax_net("UNetUndirected", args, side)
    variables = _moved_stats(jnet.variables)
    tnet = _port("UNetUndirected", args, side, variables)
    wires = sorted(m.wires for m in tnet.modules()
                   if isinstance(m, tnn.QConv2d))
    assert len(wires) == 13 and wires[0] == 3 and wires[-1] == 9
    img = _images(8, side, 5)
    want = np.asarray(jax.jit(functools.partial(
        jnet.module.apply, train=False))(variables, jnp.asarray(img)))
    with torch.no_grad():
        got = tnet(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(got, want, atol=VALUE_TOL)
    tnet = _port("UNetUndirected", args, side, jnet.variables)
    with _x64():
        check_training_step(jnet, tnet, 8, 10, side, dtype=np.float64)


# --- checkpoints ------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("UNetUndirected", (3, 2, 1)), ("UNetUndirected", (2, 4, 0)),
    ("UNetUndirectedS", (2, 2, 1)), ("UnetDirectedS", (2, 2, 1)),
    ("DeepConvDirectedMulti", ([1, 4, 1], (8, 8)))],
    ids=["quantum", "classical", "simple", "directed-simple", "deep-conv"])
def test_jax_checkpoint_round_trips_through_port(tmp_path, name, args):
    """JAX pickle -> load_jax_variables -> export_jax_variables: the same
    tree, names and values, ``batch_stats`` included."""
    if name.startswith("DeepConv"):
        jnet = getattr(jnn, name)(*args)
        tnet = getattr(tnn, name)(*args, device="cpu")
        tree = _jax_tree(jnet.variables)
    else:
        jnet = _jax_net(name, args, 8)
        tnet = getattr(tnn, name)(*args, img_shape=(8, 8), device="cpu")
        tree = _moved_stats(jnet.variables)
    path = jckpt.save_checkpoint(tmp_path / "jax.pt", tree, [0.5], 3)
    tckpt.load_jax_variables(tnet,
                             tckpt.load_checkpoint(path)["model_state_dict"])
    back = tckpt.export_jax_variables(tnet)
    assert _trees_equal(back, tree)
    out = tckpt.save_checkpoint(tmp_path / "torch.pt", back, [0.1], 1)
    assert _trees_equal(jckpt.load_checkpoint(out)["model_state_dict"], tree)


def test_unet_variable_tree_is_the_one_expected():
    """The nested paths the port maps: a classical conv's ``Conv_0``, a
    quantum conv's ``qweights``, BatchNorm scales and statistics, the up
    blocks' ``up_conv`` and the final conv; the simple blocks' ``qconv``,
    ``up_qconv`` and ``bn``."""
    flat = {"/".join(p): np.shape(v) for p, v in tckpt._flatten(_jax_tree(
        _jax_net("UNetUndirected", (3, 8, 0), 8).variables)).items()}
    assert flat["params/down0/conv0/Conv_0/kernel"] == (3, 3, 1, 8)
    assert flat["params/up1/up_conv/Conv_0/bias"] == (8,)
    assert flat["params/final_conv/Conv_0/kernel"] == (1, 1, 8, 1)
    assert flat["params/down2/bn1/scale"] == (32,)
    assert flat["batch_stats/up0/bn0/var"] == (16,)
    flat = {"/".join(p): np.shape(v) for p, v in tckpt._flatten(_jax_tree(
        _jax_net("UNetUndirected", (3, 8, 3), 8).variables)).items()}
    assert flat["params/down2/conv1/qweights"] == (3, 9, 3)
    assert flat["params/final_conv/qweights"] == (3, 3, 3)
    flat = {"/".join(p) for p in tckpt._flatten(_jax_tree(
        _jax_net("UNetUndirectedS", (2, 2, 1), 8).variables))}
    assert {"params/down0/qconv/qweights", "params/up0/up_qconv/qweights",
            "params/up0/bn/scale", "batch_stats/down1/bn/mean"} <= flat
    tnet = tnn.UNetUndirected(3, 8, 3, device="cpu")
    assert {path for path, _ in tckpt._flax_paths(tnet).values()} == {
        p for p in tckpt._flatten(_jax_tree(
            _jax_net("UNetUndirected", (3, 8, 3), 8).variables))}


# --- the drivers on the CPU -------------------------------------------------

def test_mnist_exm_trains_the_unet_and_its_checkpoint_serves(tmp_path,
                                                            monkeypatch):
    """One tiny epoch of ``UNetUndirected 2 2 1`` on mnist_8x8 through the
    training driver on the CPU; the sampling CLI serves its checkpoint,
    and so does the JAX package's loader."""
    from qiddm_tpu_torch.cli import mnist_exm as tmnist
    from qiddm_tpu_torch.cli import sample as tsample

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    margs = ["UNetUndirected", "2", "2", "1"]
    out = tmnist.main([
        "--data", "mnist_8x8", "--img_size", "8", "--model", *margs,
        "--ds-size", "60", "--epochs", "1", "--batch_size", "2",
        "--tau", "2", "--device", "cpu",
        "--save-path", f"{tmp_path}/run_", "--load-path", f"{tmp_path}/run_"])
    losses = out["UNetUndirected"]["loss"][0]
    assert len(losses) == 1 and np.isfinite(losses).all()
    ckpt = tmp_path / "run_4" / "noise_0" / "unet_undirected_d2_s2_d1_4.pt"
    tree = tckpt.load_checkpoint(ckpt)["model_state_dict"]
    assert "batch_stats" in tree
    imgs = tsample.main(["--ckpt", str(ckpt), "--model", *margs,
                         "--img_size", "8", "--n", "3", "--iters", "2",
                         "--device", "cpu", "--format", "npz", "--out",
                         str(tmp_path / "served")])
    assert imgs.shape == (3, 1, 8, 8) and np.isfinite(imgs).all()
    jdiff = JDiffusion(jnn.UNetUndirected(2, 2, 1, seed=9, img_shape=(8, 8)),
                       shape=(8, 8))
    assert jckpt.load_diffusion(jdiff, ckpt.parent, 4)[1] == 1
    assert _trees_equal(_jax_tree(jdiff.net.variables), tree)


def test_unet_precision_tool_runs_on_the_card_only():
    """The float32-spread tool of the quantum U-Net's sampling step trains
    and samples on the card, and refuses the CPU; its distance is the (max,
    root-mean-square) of |got - want|."""
    from qiddm_tpu_torch.tools import unet_precision

    got = unet_precision._dist(torch.tensor([1.0, 2.0]),
                               torch.tensor([1.0, 0.0], dtype=torch.float64))
    assert got == (2.0, pytest.approx(2**0.5))
    with pytest.raises(SystemExit, match="no CUDA device"):
        unet_precision.main(["--checkpoints", "1"])


def test_unet_precision_gradients_on_the_cpu():
    """The tool's gradient spread, run with the CPU in the card's place:
    the "card" float32 gradients are the CPU's own, and float64 against
    float64 is exact, over 3 Adam steps."""
    from qiddm_tpu_torch.tools import unet_precision

    images = np.random.default_rng(0).integers(0, 256, (24, 28, 28))
    steps = unet_precision.gradients(["UNetUndirected", "2", "2", "1"], 0,
                                     images, device="cpu")
    assert len(steps) == 3
    for s in steps:
        # BatchNorm's cancellations leave float32 well short of float64
        assert s["card32"] == s["cpu32"] and 1e-7 < s["cpu32"] < 1.0
        assert s["card64"] == 0.0
