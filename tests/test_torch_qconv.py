"""The U-Net's building blocks in qiddm_tpu_torch against qiddm_tpu on the
CPU, on the same numpy inputs made from a seed: ``QConv2d`` (forward,
gradients with respect to ``qweights`` and the input, the released
dead-circuit path), ``_prep_unitary`` and ``QConv2dMedium``, flax's
BatchNorm over the channel axis of NCHW, and ``nn/utils.py`` (``autopad``,
``autocrop``, both label embeddings) with the bilinear x2 upsample.

Tolerances: values 1e-5 absolute, gradients 1e-4 relative to the largest
|g| of the tensor.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu.nn import qconv as jqconv
from qiddm_tpu.nn import utils as jutils
from qiddm_tpu_torch.nn import layers as tlayers
from qiddm_tpu_torch.nn import qconv as tqconv
from qiddm_tpu_torch.nn import unet as tunet
from qiddm_tpu_torch.nn import utils as tutils

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _uniform(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- QConv2d ----------------------------------------------------------------

# (Cin, Cout, k, padding, side, compat): a 1x1 conv (up_conv's), Cout > d/2
# (the zero columns: 3 features on 2 wires, 4 outputs against 2 even rows),
# Cin k^2 not a power of two (18 features on 5 wires, 27 on 5), the U-Net's
# first conv, its final 1x1 conv to one channel, the deepest conv's 9 wires
# (32 x 9 = 288 features), and the released dead-circuit path
QCONV_CASES = [
    (4, 2, 1, 0, 5, False),
    (3, 4, 1, 0, 4, False),
    (2, 5, 3, 1, 6, False),
    (3, 8, 3, 0, 5, False),
    (1, 8, 3, 1, 7, False),
    (8, 1, 1, 0, 4, False),
    (32, 16, 3, 1, 3, False),
    (2, 5, 3, 1, 6, True),
    (1, 8, 3, 1, 5, True),
]
QCONV_IDS = [f"cin{c}-cout{o}-k{k}-p{p}" + ("-compat" if dead else "")
             for c, o, k, p, _, dead in QCONV_CASES]


def _qconv_pair(cin, cout, k, pad, side, dead, seed=0):
    jm = jqconv.QConv2d(in_channels=cin, out_channels=cout,
                        kernel_size=(k, k), padding=(pad, pad), qdepth=3,
                        compat_dead_qnode=dead)
    x = _uniform((2, cin, side, side), seed)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    tm = tqconv.QConv2d(cin, cout, kernel_size=k, padding=pad, qdepth=3,
                        compat_dead_qnode=dead,
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        tm.qweights.copy_(torch.as_tensor(
            np.array(variables["params"]["qweights"])))
    return jm, variables, tm, x


@pytest.mark.parametrize("cin,cout,k,pad,side,dead", QCONV_CASES,
                         ids=QCONV_IDS)
def test_qconv_forward_matches_jax(cin, cout, k, pad, side, dead):
    jm, variables, tm, x = _qconv_pair(cin, cout, k, pad, side, dead)
    assert tm.wires == jm.wires
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    got = tm(torch.as_tensor(x)).detach().numpy()
    out = side + 2 * pad - k + 1
    assert got.shape == want.shape == (2, cout, out, out)
    np.testing.assert_allclose(got, want, atol=VALUE_TOL)


@pytest.mark.parametrize("cin,cout,k,pad,side,dead", QCONV_CASES,
                         ids=QCONV_IDS)
def test_qconv_gradients_match_jax(cin, cout, k, pad, side, dead):
    """d/d qweights and d/d x of sum(out * r) for a seeded r."""
    jm, variables, tm, x = _qconv_pair(cin, cout, k, pad, side, dead, seed=1)
    out = side + 2 * pad - k + 1
    r = np.random.default_rng(9).normal(size=(2, cout, out, out)).astype(
        np.float32)

    def jloss(params, xj):
        return jnp.sum(jm.apply({"params": params}, xj) * r)

    jgw, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        variables["params"], jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    (tm(xt) * torch.as_tensor(r)).sum().backward()
    want_x = np.asarray(jgx)
    assert _rel(xt.grad.numpy(), want_x) <= GRAD_TOL
    want_w = np.asarray(jgw["qweights"])
    if dead:  # the released forward never runs its circuit
        assert not want_w.any()
        assert tm.qweights.grad is None or not tm.qweights.grad.any()
    else:
        assert _rel(tm.qweights.grad.numpy(), want_w) <= GRAD_TOL


def test_qconv_wires_and_init_range():
    """The U-Net's widths: 3 to 9 wires; the weights U[0, 1) pi - pi/2."""
    gen = torch.Generator().manual_seed(0)
    for cin, cout, k, wires in ((1, 8, 3, 4), (8, 8, 3, 7), (16, 16, 3, 8),
                                (16, 32, 3, 8), (32, 32, 3, 9),
                                (32, 16, 1, 5), (8, 1, 1, 3), (1, 1, 1, 1)):
        m = tqconv.QConv2d(cin, cout, kernel_size=k, qdepth=3, generator=gen)
        assert m.wires == wires == jqconv.QConv2d(
            in_channels=cin, out_channels=cout, kernel_size=(k, k)).wires
        w = m.qweights.detach()
        assert w.shape == (3, wires, 3)
        assert (w >= -np.pi / 2).all() and (w < np.pi / 2).all()


def test_qconv_rejects_the_wrong_channel_count():
    m = tqconv.QConv2d(2, 4, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Expected 2 channels"):
        m(torch.zeros(1, 3, 4, 4))


# --- _prep_unitary and QConv2dMedium ----------------------------------------

def test_prep_unitary_is_unitary_and_prepares_v():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(5, 16)) + 1j * rng.normal(size=(5, 16))
    v[3, 0] = 0.0  # <e0, v> = 0: the phase falls back to 1
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    u = tqconv._prep_unitary(torch.as_tensor(v, dtype=torch.complex64))
    u = u.numpy()
    for i in range(5):
        np.testing.assert_allclose(u[i] @ u[i].conj().T, np.eye(16),
                                   atol=VALUE_TOL)
        np.testing.assert_allclose(u[i][:, 0], v[i], atol=VALUE_TOL)
    want = np.asarray(jqconv._prep_unitary(jnp.asarray(v, jnp.complex64)))
    np.testing.assert_allclose(u, want, atol=VALUE_TOL)


@pytest.mark.parametrize("cin,cout,k,pad", [(2, 4, 3, 1), (3, 5, 3, 0),
                                            (1, 2, 2, 1)])
def test_qconv_medium_forward_matches_jax(cin, cout, k, pad):
    assert tqconv.QConv2dSlow is tqconv.QConv2dMedium
    jm = jqconv.QConv2dMedium(in_channels=cin, out_channels=cout,
                              kernel_size=(k, k), padding=(pad, pad),
                              qdepth=2)
    x = _uniform((2, cin, 5, 5), 4)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(x))
    tm = tqconv.QConv2dMedium(cin, cout, kernel_size=k, padding=pad,
                              qdepth=2,
                              generator=torch.Generator().manual_seed(0))
    assert tm.wires == jm.wires
    assert tm.qweights.shape == variables["params"]["qweights"].shape
    with torch.no_grad():
        tm.qweights.copy_(torch.as_tensor(
            np.array(variables["params"]["qweights"])))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    got = tm(torch.as_tensor(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=VALUE_TOL)


# --- flax's BatchNorm over NCHW's channel axis ------------------------------

def test_batchnorm_on_nchw_matches_flax_axis_1():
    """Train-mode outputs of two calls, the running mean and variance after
    them, and the eval output, against ``flax.linen.BatchNorm(axis=1)``;
    the statistics reduce over (N, H, W), the variance biased."""
    x1 = np.random.default_rng(5).normal(1.0, 2.0, (3, 4, 5, 6)).astype(
        np.float32)
    x2 = np.random.default_rng(6).normal(-0.5, 0.5, (3, 4, 5, 6)).astype(
        np.float32)
    scale = _uniform((4,), 7) + 0.5
    bias = np.random.default_rng(8).normal(size=4).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, axis=1)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.full(4, 0.2, np.float32),
                                 "var": np.full(4, 1.5, np.float32)}}
    port = tlayers.FlaxBatchNorm(4, axis=1).train()
    with torch.no_grad():
        port.weight.copy_(torch.as_tensor(scale))
        port.bias.copy_(torch.as_tensor(bias))
        port.running_mean.fill_(0.2)
        port.running_var.fill_(1.5)
    for x in (x1, x2):
        want, new = bn.apply(variables, x, mutable=["batch_stats"])
        variables = {"params": variables["params"], **new}
        got = port(torch.as_tensor(x)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=VALUE_TOL)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               rtol=VALUE_TOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               rtol=VALUE_TOL)
    # BatchNorm2d keeps the unbiased running variance: not this
    torch_bn = torch.nn.BatchNorm2d(4, momentum=0.1, eps=1e-5)
    with torch.no_grad():
        torch_bn.running_mean.fill_(0.2)
        torch_bn.running_var.fill_(1.5)
    for x in (x1, x2):
        torch_bn(torch.as_tensor(x))
    assert not np.allclose(torch_bn.running_var.numpy(),
                           np.asarray(new["batch_stats"]["var"]), rtol=1e-3)
    port.eval()
    want = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                         epsilon=1e-5, axis=1).apply(variables, x1)
    np.testing.assert_allclose(port(torch.as_tensor(x1)).detach().numpy(),
                               np.asarray(want), atol=VALUE_TOL)


# --- utils and the upsample -------------------------------------------------

@pytest.mark.parametrize("big,small", [((1, 2, 10, 10), (1, 2, 7, 8)),
                                       ((2, 1, 5, 5), (2, 1, 4, 4)),
                                       ((1, 3, 9, 6), (1, 3, 4, 3))])
def test_autopad_and_autocrop_match_jax_at_odd_differences(big, small):
    a, b = _uniform(big, 1), _uniform(small, 2)
    pairs = [(tutils.autopad(torch.as_tensor(a), torch.as_tensor(b)),
              jutils.autopad(jnp.asarray(a), jnp.asarray(b))),
             (tutils.autocrop(torch.as_tensor(b), torch.as_tensor(a)),
              jutils.autocrop(jnp.asarray(b), jnp.asarray(a)))]
    # the smaller first: both pad it, with a warning
    with pytest.warns(UserWarning, match="smaller"):
        swapped = tutils.autopad(torch.as_tensor(b), torch.as_tensor(a))
    with pytest.warns(UserWarning, match="smaller"):
        pairs.append((swapped, jutils.autopad(jnp.asarray(b),
                                              jnp.asarray(a))))
    for got, want in pairs:
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the extra row and column go first: ceil before, floor after
    _, padded = tutils.autopad(torch.zeros(1, 1, 5, 5), torch.ones(1, 1, 2, 4))
    assert padded[0, 0, :, 0].tolist() == [0.0] * 5
    assert padded[0, 0, :, 1].tolist() == [0.0, 0.0, 1.0, 1.0, 0.0]


def test_label_embeddings_match_jax():
    labels = np.array([0, 1, 4, 9, 1])
    for tfn, jfn in ((tutils._get_label_embedding_1,
                      jutils._get_label_embedding_1),
                     (tutils._get_label_embedding_2,
                      jutils._get_label_embedding_2)):
        for w, h in ((8, 8), (7, 5)):
            got = tfn(labels, w, h).numpy()
            want = np.asarray(jfn(jnp.asarray(labels), w, h))
            assert got.shape == want.shape == (5, 1, w, h)
            np.testing.assert_allclose(got, want, atol=1e-7)
    assert tutils.get_label_embedding is tutils._get_label_embedding_1
    with pytest.raises(ValueError, match="labels"):
        tutils.get_label_embedding(None, 8, 8)


def test_qasm_bridge_raises_naming_its_item():
    """The QASM bridge is ported (sim/qasm.py; tests/test_torch_qasm.py
    holds it in full): the reference's three names give the JAX bridge's
    text and counts. What is left to raise is the card's absence: the
    circuit runs on the card by default, and a host without one names the
    device it was asked for."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(2, 3, 3)).astype(np.float32)
    x = rng.normal(size=3).astype(np.float32)
    text = tutils.repeat_qasm(tutils.circuit_to_qasm(w, 3, x), 3, True, 2)
    assert text == jutils.repeat_qasm(jutils.circuit_to_qasm(w, 3, x), 3,
                                      True, 2)
    np.testing.assert_array_equal(
        tutils.sample_from_qiskit(text, shots=500, device="cpu"),
        jutils.sample_from_qiskit(text, shots=500))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tutils.sample_from_qiskit(text, shots=500)


@pytest.mark.parametrize("h,w", [(2, 2), (7, 7), (14, 14), (7, 2), (3, 5)])
def test_bilinear_upsample_matches_jax_image_resize(h, w):
    """x2 at even and odd sides: 7 -> 14 is the 28x28 U-Net's deepest
    level, 14 -> 28 the next; JAX renormalises the edge taps where torch
    clamps the source index."""
    x = np.random.default_rng(h * 10 + w).normal(size=(2, 3, h, w)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 2 * h, 2 * w),
                                       method="bilinear"))
    got = tunet._upsample(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=VALUE_TOL)
