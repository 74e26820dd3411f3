"""The SEL-chain model families of qiddm_tpu_torch — Qdense
(``QDenseUndirected_old``, ``QDenseUndirected_old_noise``), ``QNN_A`` and
QNN (``QNN_noise``, ``QNN``) — and the engine circuits beneath them
(``qdense_circuit``, ``qnn_circuit``) against qiddm_tpu on the CPU, with
the JAX weights carried across by ``load_jax_variables``.

On the CPU the JAX engine runs ``sel_apply_gates`` (a gate-by-gate
``lax.scan``, qiddm_tpu/sim/engine.py:265-267) below 2^w and the composed
``sel_unitary`` at or above it; the port runs its plain SEL chain or its
own composed unitary, so the small-batch cases compare two independent
formulations.

Tolerances:
* engine circuits: <= 1e-5 (probabilities and PauliZ expectations after up
  to 60 float32 gate layers);
* model images: <= 1e-4 (an 8 -> 784 linear over the circuit, or 64
  probabilities scaled by 64 pixels);
* the training loss: <= 1e-5 relative; gradients: each parameter's
  gradient within 1e-4 of its own max norm where that norm is at least
  1e-6 of the model's largest, and within 1e-4 of the largest otherwise.
  QNN's ``linear_down`` gradient is zero up to rounding in both packages:
  the circuit RZ-encodes |0...0>, so its input is a global phase
  (qiddm_tpu/sim/engine.py:683-686), and a relative check would divide by
  ~1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import ckpt as jckpt
from qiddm_tpu import nn as jnn
from qiddm_tpu import sim as jsim
from qiddm_tpu.diffusion import Diffusion as JDiffusion
from qiddm_tpu.sim import gates as jgates
from qiddm_tpu.sim import statevector as jsv
from qiddm_tpu_torch import ckpt as tckpt
from qiddm_tpu_torch import config as tconfig
from qiddm_tpu_torch import nn as tnn
from qiddm_tpu_torch import noise as tnoise
from qiddm_tpu_torch.diffusion import Diffusion as TDiffusion
from qiddm_tpu_torch.sim import engine as tengine
from qiddm_tpu_torch.sim import gates as tgates
from qiddm_tpu_torch.sim import sel_kernel
from qiddm_tpu_torch.sim import statevector as tsv

CIRCUIT_TOL = 1e-5
IMAGE_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-6

# (name, ctor args, batch); batch >= 2^w takes the composed route
MODELS = [
    ("QNN_noise", (784, 8, 14), 5),
    ("QNN", (64, 4, 3), 5),
    ("QNN", (64, 4, 3), 16),
    ("QDenseUndirected_old_noise", (60, 8), 5),
    ("QDenseUndirected_old", (5, 4), 5),
    ("QDenseUndirected_old", (5, 4), 20),
    ("QNN_A", (6, 8), 5),
    ("QNN_A", (4, 4), 16),
]


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


def _rng(seed):
    return np.random.default_rng(seed)


# --- simulator pieces --------------------------------------------------------

def test_weight_maps_and_amplitude_embed_match_jax():
    w = _rng(0).normal(size=(4, 3, 3)).astype(np.float32) * 2
    for name in ("none", "qw_tanh", "tanh"):
        np.testing.assert_allclose(
            tgates.WEIGHT_MAPS[name](torch.as_tensor(w)).numpy(),
            np.asarray(jgates.WEIGHT_MAPS[name](jnp.asarray(w))), atol=1e-6)
    x = _rng(1).uniform(size=(3, 60)).astype(np.float32)
    x[1] = 0.0  # the norm floor
    for n_feat, pad in ((60, 0.1), (64, 0.0), (5, 0.5)):
        got = tsv.amplitude_embed(torch.as_tensor(x[:, :n_feat]), 6, pad)
        want = jsv.amplitude_embed(jnp.asarray(x[:, :n_feat]), 6, pad)
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    with pytest.raises(ValueError, match="do not fit"):
        tsv.amplitude_embed(torch.zeros(2, 65), 6)


@pytest.mark.parametrize("batch", [3, 20], ids=["chain", "composed"])
@pytest.mark.parametrize("ring", ["cnot", "cz"])
@pytest.mark.parametrize("weight_map", ["qw_tanh", "tanh"])
def test_qdense_circuit_matches_jax(batch, ring, weight_map):
    wires, depth = 4, 9
    rng = _rng(2)
    x = rng.uniform(size=(batch, 13)).astype(np.float32)
    w = rng.normal(size=(depth, wires, 3)).astype(np.float32)
    want = np.asarray(jsim.qdense_circuit(
        jnp.asarray(x), jnp.asarray(w), wires=wires, pad_with=0.1,
        weight_map=weight_map, imprimitive=ring))
    with torch.no_grad():
        got = tengine.qdense_circuit(
            torch.as_tensor(x), torch.as_tensor(w), wires=wires, pad_with=0.1,
            weight_map=weight_map, imprimitive=ring).numpy()
    assert got.shape == (batch, 2**wires)
    np.testing.assert_allclose(got, want, atol=CIRCUIT_TOL)


@pytest.mark.parametrize("batch", [3, 20], ids=["chain", "composed"])
@pytest.mark.parametrize("readout,encode,ring", [
    ("expvalz", "rz", "cz"), ("probs", "rz", "cz"),
    ("expvalz", "rz_halfpi", "cnot"), ("probs", "rz", "cnot"),
    ("probs", "ry", "cnot"), ("expvalz", "ry", "cz")])
def test_qnn_circuit_matches_jax(batch, readout, encode, ring):
    wires, depth = 4, 7
    rng = _rng(3)
    x = rng.normal(size=(batch, wires)).astype(np.float32)
    w = (rng.normal(size=(depth, wires, 3)) * 0.4).astype(np.float32)
    want = np.asarray(jsim.qnn_circuit(
        jnp.asarray(x), jnp.asarray(w), encode=encode, imprimitive=ring,
        readout=readout))
    with torch.no_grad():
        got = tengine.qnn_circuit(
            torch.as_tensor(x), torch.as_tensor(w), encode=encode,
            imprimitive=ring, readout=readout).numpy()
    np.testing.assert_allclose(got, want, atol=CIRCUIT_TOL)


def test_small_batch_circuits_run_the_sel_chain_entry(monkeypatch):
    calls = []
    real = sel_kernel._SelChain.apply

    def spy(*a):
        calls.append(a[3:])
        return real(*a)

    monkeypatch.setattr(sel_kernel._SelChain, "apply", spy)
    x = torch.rand(3, 4)
    w = torch.rand(5, 4, 3)
    tengine.qnn_circuit(x, w)
    tengine.qdense_circuit(torch.rand(3, 16), w, wires=4)
    tengine.qnn_circuit(torch.rand(16, 4), w)  # composed: no chain
    assert calls == [(4, "cz"), (4, "cnot")]


_DAMPING = tengine.NoiseModel("amplitude_damping", 0.1, "encode")


@pytest.mark.parametrize("call,kwargs,match", [
    # a channel with n_traj takes the trajectory backend, which needs a
    # random source; without a channel n_traj changes nothing
    ("qnn", {"noise": _DAMPING, "n_traj": 4}, "random source"),
    ("qnn", {"n_traj": 4}, None),
    ("qnn", {"encode": "ry", "n_traj": 4}, None),
    ("qdense", {"noise": _DAMPING, "n_traj": 4}, "random source"),
    ("qdense", {"n_traj": 4}, None),
])
def test_unported_circuit_options_raise(call, kwargs, match):
    w = torch.rand(2, 3, 3, generator=torch.Generator().manual_seed(0))
    if call == "qnn":
        def run(**kw):
            return tengine.qnn_circuit(torch.ones(2, 3), w, **kw)
    else:
        def run(**kw):
            return tengine.qdense_circuit(torch.ones(2, 8), w, wires=3, **kw)
    if match is None:
        clean = {k: v for k, v in kwargs.items() if k != "n_traj"}
        assert torch.equal(run(**kwargs), run(**clean))
        return
    with pytest.raises(ValueError, match=match):
        run(**kwargs)
    out = run(traj_rng=torch.Generator().manual_seed(1), **kwargs)
    assert torch.isfinite(out).all()


def test_chain_route_limits_raise():
    """The SEL chain takes up to 12 wires (the trajectory route's width) in
    complex64. Past it the grouped chain runs (``wide.sel_chain_wide``,
    13 wires, against the JAX package's adjoint chain), and complex128
    below 9 wires ``sel_apply_gates`` (against the complex64 kernel
    route)."""
    out = tengine.qnn_circuit(torch.zeros(2, 11), torch.zeros(1, 11, 3))
    assert out.shape == (2, 11) and torch.isfinite(out).all()
    rng = _rng(8)
    x = rng.normal(size=(2, 13)).astype(np.float32)
    w = (rng.normal(size=(2, 13, 3)) * 0.4).astype(np.float32)
    tengine.reset_route_calls()
    with torch.no_grad():
        got = tengine.qnn_circuit(torch.as_tensor(x), torch.as_tensor(w),
                                  readout="probs").numpy()
    assert tengine.ROUTE_CALLS["wide"] == 1
    want = np.asarray(jsim.qnn_circuit(jnp.asarray(x), jnp.asarray(w),
                                       readout="probs"))
    np.testing.assert_allclose(got, want, atol=CIRCUIT_TOL)
    xd = torch.as_tensor(rng.uniform(size=(2, 8)), dtype=torch.float32)
    wd = torch.as_tensor(rng.normal(size=(3, 3, 3)), dtype=torch.float32)
    want = tengine.qdense_circuit(xd, wd, wires=3)
    tconfig.enable_x64(True)
    try:
        tengine.reset_route_calls()
        got = tengine.qdense_circuit(xd, wd, wires=3)
        assert tengine.ROUTE_CALLS["gates"] == 1
    finally:
        tconfig.enable_x64(False)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=CIRCUIT_TOL)


# --- models ------------------------------------------------------------------

@pytest.mark.parametrize("name,args,batch", MODELS)
def test_forward_matches_jax(name, args, batch):
    jnet, tnet = _pair(name, args)
    img = _rng(0).uniform(size=(batch, 1, *tnet.img_shape)).astype(
        np.float32)
    want = np.asarray(jnet(img))
    with torch.no_grad():
        got = tnet(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL)


@pytest.mark.parametrize("name,args", [
    ("QNN_noise", (784, 8, 14)), ("QNN_noise", ("28 * 28", 8, 14, "0")),
    ("QNN", (64, 4, 3)), ("QDenseUndirected_old_noise", (60, 8)),
    ("QDenseUndirected_old", (5, "4")), ("QDenseUndirected_old", (2, 28)),
    ("QNN_A", (6, 8)), ("QNN_A", ("3", 28, "0"))])
def test_save_name_and_param_count_match_jax(name, args):
    jnet = getattr(jnn, name)(*args)
    tnet = getattr(tnn, name)(*args, device="cpu")
    assert tnet.save_name() == jnet.save_name()
    assert tnet.num_params() == jnet.num_params()
    for attr in ("qdepth", "hidden_features", "add_noise", "width", "height",
                 "wires"):
        if hasattr(jnet, attr):
            assert getattr(tnet, attr) == getattr(jnet, attr), attr


def test_seed_fixes_weights_and_noise_raises():
    for name, args in (("QNN", (64, 4, 3)), ("QDenseUndirected_old", (5, 4))):
        cls = getattr(tnn, name)
        a = tckpt.export_jax_variables(cls(*args, seed=1, device="cpu"))
        b = tckpt.export_jax_variables(cls(*args, seed=1, device="cpu"))
        c = tckpt.export_jax_variables(cls(*args, seed=2, device="cpu"))
        assert _trees_equal(a, b) and not _trees_equal(a, c)
    # the noise codes build; the trajectory backend (the circuits' n_traj)
    # raises without a random source
    cpu = {"device": "cpu"}
    for net, family in ((tnn.QNN_noise(784, 8, 14, 1, **cpu), "qnn"),
                        (tnn.QDenseUndirected_old_noise(60, 8, 2, **cpu),
                         "qdense"),
                        (tnn.QNN_A(6, 8, 1, **cpu), "qnn_a")):
        assert net.module.add_noise == net.add_noise != 0
        with pytest.raises(ValueError, match="random source"):
            tengine.qnn_circuit(torch.zeros(2, 3), torch.zeros(1, 3, 3),
                                noise=tengine.noise_from_code(2, family),
                                n_traj=4)


@pytest.mark.parametrize("name,args", [("QNN_noise", (784, 8, 14)),
                                       ("QDenseUndirected_old_noise", (60, 8)),
                                       ("QNN_A", (6, 28))])
def test_jax_checkpoint_round_trips_through_port(tmp_path, name, args):
    jnet = getattr(jnn, name)(*args, seed=7)
    path = jckpt.save_checkpoint(tmp_path / "jax.pt", jnet.variables,
                                 [0.5], 3)
    tnet = getattr(tnn, name)(*args, device="cpu")
    tckpt.load_jax_variables(tnet,
                             tckpt.load_checkpoint(path)["model_state_dict"])
    back = tckpt.export_jax_variables(tnet)
    assert _trees_equal(back, _jax_tree(jnet))
    out = tckpt.save_checkpoint(tmp_path / "torch.pt", back, [0.1], 1)
    assert _trees_equal(jckpt.load_checkpoint(out)["model_state_dict"],
                        _jax_tree(jnet))


# --- one training step -------------------------------------------------------

def _injecting(draw):
    """A ``noise_f`` that blends the JAX schedule's draw."""

    def noise_f(generator, data, tau, decay_mod):
        return tnoise.add_normal_noise_multiple(
            generator, data, tau, decay_mod,
            noise=torch.as_tensor(np.array(draw)))

    return noise_f


def _grads_by_flax_path(tnet):
    params = dict(tnet.module.named_parameters())
    return {path: (params[name].grad.numpy().T if transpose
                   else params[name].grad.numpy())
            for name, (path, transpose) in tckpt._flax_paths(tnet).items()}


def assert_grads_close(got: dict, want: dict, tol=GRAD_TOL,
                       floor=GRAD_FLOOR):
    """Each gradient within ``tol`` of its own max norm where that norm is
    at least ``floor`` of the largest gradient norm, else within ``tol``
    of the largest. The second arm is for gradients that are zero up to
    rounding, as QNN's ``linear_down`` (see the module docstring)."""
    top = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        scale = np.abs(w).max()
        bound = tol * (scale if scale >= floor * top else top)
        err = np.abs(np.asarray(got[key]) - w).max()
        assert err <= bound, (key, err, bound)


@pytest.mark.parametrize("name,args,batch", [
    ("QNN", (64, 4, 3), 1), ("QNN", (64, 4, 3), 6),
    ("QNN_noise", (64, 6, 5), 2),
    ("QDenseUndirected_old", (5, 4), 1), ("QDenseUndirected_old", (5, 4), 6),
    ("QDenseUndirected_old_noise", (4, 8), 2), ("QNN_A", (5, 8), 1)])
def test_training_step_matches_jax_grad(name, args, batch):
    """batch x T=3 rows below 2^w run the SEL chain (its autograd Function
    on the CPU), at or above it the composed unitary."""
    jnet, tnet = _pair(name, args)
    shape = tnet.img_shape
    x = _rng(4).uniform(size=(batch, shape[0] * shape[1])).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jdiff = JDiffusion(jnet, prediction_goal="data", shape=shape)

    def jloss(params):
        return jdiff._chain_loss(params, jdiff.net.extra_variables, key,
                                 jnp.asarray(x), 3)[0]

    want_loss, jgrads = jax.value_and_grad(jloss)(jdiff.net.params)
    tdiff = TDiffusion(tnet, _injecting(
        0.5 + 0.2 * jax.random.normal(key, x.shape)), "data", shape)
    tloss, _ = tdiff._chain_loss(torch.as_tensor(x), 3, generator=None)
    tloss.backward()
    assert abs(tloss.item() - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    got = _grads_by_flax_path(tnet)
    want = {}
    for path in got:
        node = jgrads
        for k in path[1:]:
            node = node[k]
        want[path] = np.asarray(node)
    assert_grads_close(got, want)


def test_qnn_linear_down_gradient_is_zero_up_to_rounding():
    """The faithful quirk the gradient check allows for: QNN's circuit
    output does not depend on ``linear_down``."""
    _, tnet = _pair("QNN", (64, 4, 3))
    img = torch.as_tensor(_rng(5).uniform(size=(3, 1, 8, 8)),
                          dtype=torch.float32)
    (tnet(img) ** 2).sum().backward()
    down = tnet.module.linear_down.weight.grad.abs().max().item()
    up = tnet.module.linear_up.weight.grad.abs().max().item()
    assert down <= GRAD_FLOOR * up
