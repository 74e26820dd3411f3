"""The engine's routes past the kernels' widths and in complex128 against
qiddm_tpu on the CPU: re-uploading blocks (an RY encode above 10 wires, a
CNOT ring from 9, complex128 from 9) on the grouped chain, and under
``wide_mode("off")`` and ``adjoint_mode("off")`` on the per-gate adjoint
chain (past 10 wires) and ``sel_apply_gates``; QNN and Qdense above 12 wires and in
complex128; the trajectory backend at 13 wires on the JAX package's draws
(``sel_apply_gates`` and the PyTorch amplitude-damping pass), and in
complex128 at 4 wires (per-layer unitaries); density matrices at 11 wires
(the SEL chain on both sides of rho, past the dm kernel's 10) and in
complex128; the amplitude-damping pass against kernel #7's plain twin at
8-12 wires; and each route's counter in ``engine.ROUTE_CALLS``.

The JAX package runs on the CPU, where its routes differ (the per-gate
adjoint chain from 9 wires; no Pallas kernel): the port is held to its
values and gradients, not to its route. Trajectory draws are the JAX
package's, injected through ``ReplayDraws``.

Tolerances: float32 probabilities and expectations <= 1e-5, gradients
<= 1e-4 relative to the largest entry of JAX's; float64 <= 1e-10 and 1e-8;
the amplitude-damping pass against #7's twin <= 1e-7 with the same picks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import config as jconfig
from qiddm_tpu.sim import engine as jengine
from qiddm_tpu.sim import trajectories as jtraj
from qiddm_tpu_torch import config as tconfig
from qiddm_tpu_torch.sim import amp_damp_kernel
from qiddm_tpu_torch.sim import engine as tengine
from qiddm_tpu_torch.sim import trajectories as ttraj

TOL = {np.float32: 1e-5, np.float64: 1e-10}
GRAD_TOL = {np.float32: 1e-4, np.float64: 1e-8}
TWIN_TOL = 1e-7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small ops by the thousand: a thread pool in each of the test
    processes oversubscribes the cores. One thread gives the same
    results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def modes():
    """Sets the port's (wide, adjoint) modes for a test; restores 'auto'."""
    def set_modes(wide, adjoint):
        tconfig.set_wide_mode(wide)
        tconfig.set_adjoint_mode(adjoint)
    yield set_modes
    set_modes("auto", "auto")


def _rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _routes():
    return {k: v for k, v in tengine.ROUTE_CALLS.items() if v}


def _pair(jfn, tfn, x, w, dtype):
    """Value and (x, w) gradients of ``sum(coeff * f(x, w))`` in both
    packages, JAX under jit; the port's route counters from 0."""
    cdtype = torch.complex128 if dtype == np.float64 else torch.complex64
    x, w = x.astype(dtype), w.astype(dtype)

    def jloss(xx, ww):
        out = jfn(xx, ww)
        return jnp.sum(jnp.asarray(coeff) * out), out

    out_shape = jax.eval_shape(jfn, jnp.asarray(x), jnp.asarray(w)).shape
    coeff = np.random.default_rng(3).normal(size=out_shape).astype(dtype)
    (_, want), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.as_tensor(x).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    tengine.reset_route_calls()
    got = tfn(tx, tw, cdtype)
    (torch.as_tensor(coeff) * got).sum().backward()
    return (got.detach().numpy(), np.asarray(want),
            [tx.grad.numpy(), tw.grad.numpy()], [np.asarray(g) for g in jg])


def _check(run, dtype):
    got, want, tg, jg = run
    np.testing.assert_allclose(got, want, atol=TOL[dtype])
    for g, j in zip(tg, jg):
        _rel(g, j, GRAD_TOL[dtype])


def _block(encode, ring, wires, dtype, readout="expvalz", L=2, k=2, b=3):
    rng = np.random.default_rng(wires + len(encode) + len(ring))
    x = rng.normal(size=(b, wires))
    w = rng.normal(size=(L, k, wires, 3)) * 0.5
    kw = dict(encode=encode, imprimitive=ring, readout=readout)
    return _pair(lambda xx, ww: jengine.reupload_block(xx, ww, **kw),
                 lambda xx, ww, cd: tengine.reupload_block(xx, ww, cdtype=cd,
                                                           **kw),
                 x, w, dtype)


# (encode, ring, wires): an RY encode past the RY chain's 10 wires, a CNOT
# ring past the per-layer route's 8, both
@pytest.mark.parametrize("encode,ring,wires", [("ry", "cz", 11),
                                               ("rz", "cnot", 9),
                                               ("ry", "cnot", 10)])
def test_reupload_block_takes_the_grouped_chain(encode, ring, wires):
    run = _block(encode, ring, wires, np.float32)
    assert _routes() == {"wide": 1}
    _check(run, np.float32)


@pytest.mark.parametrize("wide,adjoint,route", [("off", "auto", "adjoint"),
                                                ("on", "off", "gates")])
def test_reupload_block_modes_pick_the_other_routes(wide, adjoint, route,
                                                    modes):
    """``wide_mode("off")``: the per-gate adjoint chain; ``adjoint_mode
    ("off")``: ``sel_apply_gates`` a spectrum layer under autograd (the
    grouped chain is off with it, whatever wide_mode says)."""
    modes(wide, adjoint)
    run = _block("ry", "cz", 11, np.float32)
    assert _routes() == {route: 2 if route == "gates" else 1}
    _check(run, np.float32)


@pytest.mark.parametrize("wires,route", [(10, "gates"), (11, "adjoint")])
def test_wide_mode_off_takes_the_adjoint_chain_past_10_wires(wires, route,
                                                            modes):
    """Under ``wide_mode("off")``, "auto" takes the per-gate adjoint chain
    past 10 wires, as the JAX package's ``_use_adjoint(wires, True)`` does;
    at 9-10 wires ``sel_apply_gates`` a spectrum layer."""
    modes("off", "auto")
    tengine.reset_route_calls()
    out = tengine.reupload_block(torch.zeros(2, wires),
                                 torch.zeros(2, 1, wires, 3),
                                 imprimitive="cnot")
    assert _routes() == {route: 2 if route == "gates" else 1}
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, atol=1e-5)


def test_modes_leave_the_kernels_routes_alone(modes, monkeypatch):
    """Where a kernel takes a call, the modes change nothing: an RZ block
    with a CZ ring at 12 wires stays on the wide chain's kernel wrapper."""
    calls = []
    real = tengine.wide_chain_planes

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(tengine, "wide_chain_planes", spy)
    for wide, adjoint in (("on", "on"), ("off", "off")):
        modes(wide, adjoint)
        tengine.reset_route_calls()
        tengine.reupload_block(torch.zeros(2, 12), torch.zeros(1, 2, 12, 3))
        assert not _routes()
    assert calls == [12, 12]


def test_reupload_block_in_complex128_takes_the_grouped_chain():
    jconfig.enable_x64(True)
    try:
        run = _block("rz", "cz", 9, np.float64, readout="probs")
    finally:
        jconfig.enable_x64(False)
    assert _routes() == {"wide": 1}
    _check(run, np.float64)


def _qnn(wires, dtype, encode="ry", ring="cz", depth=3):
    rng = np.random.default_rng(wires + depth)
    x = rng.normal(size=(2, wires))
    w = rng.normal(size=(depth, wires, 3)) * 0.5
    kw = dict(encode=encode, imprimitive=ring, readout="expvalz")
    return _pair(lambda xx, ww: jengine.qnn_circuit(xx, ww, **kw),
                 lambda xx, ww, cd: tengine.qnn_circuit(xx, ww, cdtype=cd,
                                                        **kw),
                 x, w, dtype)


def test_qnn_above_12_wires_takes_sel_chain_wide():
    run = _qnn(13, np.float32, ring="cnot")
    assert _routes() == {"wide": 1}
    _check(run, np.float32)


def test_qdense_above_12_wires_takes_sel_chain_wide():
    rng = np.random.default_rng(21)
    x = rng.uniform(size=(2, 100))
    w = rng.normal(size=(3, 13, 3))
    run = _pair(lambda xx, ww: jengine.qdense_circuit(xx, ww, wires=13),
                lambda xx, ww, cd: tengine.qdense_circuit(xx, ww, wires=13,
                                                          cdtype=cd),
                x, w, np.float32)
    assert _routes() == {"wide": 1}
    _check(run, np.float32)


@pytest.mark.parametrize("wires,route", [(5, "gates"), (9, "wide")])
def test_qnn_in_complex128(wires, route):
    """complex128 below 9 wires: ``sel_apply_gates``; from 9 the grouped
    chain."""
    jconfig.enable_x64(True)
    try:
        run = _qnn(wires, np.float64)
    finally:
        jconfig.enable_x64(False)
    assert _routes() == {route: 1}
    _check(run, np.float64)


def _jax_draw(key, kind, strength, w, n):
    """The draw the JAX ``apply_channel_trajectory`` takes from ``key``."""
    if kind == "amplitude_damping":
        return np.asarray(jax.random.uniform(key, (w, n)))
    p, _ = jtraj._pauli_mixture(kind, strength)
    return np.asarray(jax.random.categorical(
        key, jnp.log(jnp.maximum(p, 1e-30)), shape=(w, n)))


@pytest.mark.parametrize("encode,kind,placement", [
    ("rz", "amplitude_damping", "encode"), ("ry", "depolarizing", "end")])
def test_trajectories_at_13_wires_match_jax_on_its_draws(encode, kind,
                                                         placement):
    wires, L, b, n_traj, s = 13, 1, 2, 2, 0.3
    rng = np.random.default_rng(30)
    x = rng.normal(size=(b, wires)).astype(np.float32)
    w = (rng.normal(size=(L, 2, wires, 3)) * 0.4).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = (kind, s, placement)
    want = np.asarray(jengine.reupload_block(
        jnp.asarray(x), jnp.asarray(w), encode=encode, readout="probs",
        noise=jengine.NoiseModel(*noise), n_traj=n_traj, traj_key=key))
    keys = jax.random.split(key, L + 1)
    at = range(L) if placement == "encode" else [L]
    draws = ttraj.ReplayDraws([_jax_draw(keys[i], kind, s, wires,
                                         n_traj * b) for i in at])
    tengine.reset_route_calls()
    got = tengine.reupload_block(
        torch.as_tensor(x), torch.as_tensor(w), encode=encode,
        readout="probs", noise=tengine.NoiseModel(*noise), n_traj=n_traj,
        traj_rng=draws)
    want_routes = {"gates": L}
    if kind == "amplitude_damping":
        want_routes["amp_xla"] = L
    assert _routes() == want_routes
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[np.float32])


def test_trajectories_in_complex128_match_jax_on_its_draws():
    """complex128 below 10 wires: per-layer unitaries and the PyTorch
    amplitude-damping pass (no kernel takes complex128)."""
    wires, L, b, n_traj, s = 4, 2, 2, 2, 0.3
    rng = np.random.default_rng(31)
    x = rng.normal(size=(b, wires))
    w = rng.normal(size=(L, 2, wires, 3)) * 0.4
    key = jax.random.PRNGKey(5)
    jconfig.enable_x64(True)
    try:
        want = np.asarray(jengine.reupload_block(
            jnp.asarray(x), jnp.asarray(w), readout="expvalz",
            noise=jengine.NoiseModel("amplitude_damping", s, "encode"),
            n_traj=n_traj, traj_key=key))
        keys = jax.random.split(key, L + 1)
        draws = [_jax_draw(keys[i], "amplitude_damping", s, wires,
                           n_traj * b) for i in range(L)]
    finally:
        jconfig.enable_x64(False)
    tengine.reset_route_calls()
    got = tengine.reupload_block(
        torch.as_tensor(x), torch.as_tensor(w), readout="expvalz",
        noise=tengine.NoiseModel("amplitude_damping", s, "encode"),
        n_traj=n_traj, traj_rng=ttraj.ReplayDraws(draws),
        cdtype=torch.complex128)
    assert got.dtype == torch.float64
    assert _routes() == {"amp_xla": L}
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[np.float64])


@pytest.mark.parametrize("wires", [8, 10, 12])
def test_amp_damp_route_equals_the_kernel_twin(wires):
    """The PyTorch pass (the route past #7) and #7's plain twin, on the
    same states and draws: the same picks and values; a replay of the
    picks follows them."""
    rng = np.random.default_rng(40 + wires)
    n = 4
    st = rng.normal(size=(n, 2**wires)) + 1j * rng.normal(size=(n, 2**wires))
    st = torch.as_tensor(st / np.linalg.norm(st, axis=1, keepdims=True),
                         dtype=torch.complex64)
    # large enough a strength that both branches are taken
    u = torch.as_tensor(rng.uniform(size=(wires, n)) * 0.5,
                        dtype=torch.float32)
    got, picks = ttraj._amp_damp_xla(st, u, 0.6)
    want, want_picks = amp_damp_kernel.amp_damp_plain(st, u, 0.6)
    assert torch.equal(picks, want_picks) and 0 < picks.sum() < picks.numel()
    assert (got - want).abs().max().item() <= TWIN_TOL
    flipped = 1 - picks
    again, taken = ttraj._amp_damp_xla(st, u, 0.6, picks=flipped)
    assert torch.equal(taken, flipped) and torch.isfinite(again).all()


def test_amp_damp_route_matches_jax_in_complex128():
    wires, n, g = 6, 3, 0.4
    rng = np.random.default_rng(50)
    st = rng.normal(size=(n, 2**wires)) + 1j * rng.normal(size=(n, 2**wires))
    st /= np.linalg.norm(st, axis=1, keepdims=True)
    u = rng.uniform(size=(wires, n)) * 0.5
    jconfig.enable_x64(True)
    try:
        want = np.asarray(jtraj._amp_damp_xla(jnp.asarray(st),
                                              jnp.asarray(u), g))
    finally:
        jconfig.enable_x64(False)
    got, _ = ttraj._amp_damp_xla(torch.as_tensor(st), torch.as_tensor(u), g)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[np.float64])


def _dm_block(wires, encode, dtype, L, k):
    rng = np.random.default_rng(60 + wires)
    x = rng.normal(size=(1, wires)).astype(dtype)
    w = (rng.normal(size=(L, k, wires, 3)) * 0.5).astype(dtype)
    kw = dict(encode=encode, imprimitive="cz", readout="probs")
    want = np.asarray(jengine.reupload_block(
        jnp.asarray(x), jnp.asarray(w),
        noise=jengine.NoiseModel("amplitude_damping", 0.3, "encode"), **kw))
    tengine.reset_route_calls()
    cdtype = torch.complex128 if dtype == np.float64 else torch.complex64
    with torch.no_grad():
        got = tengine.reupload_block(
            torch.as_tensor(x), torch.as_tensor(w), cdtype=cdtype,
            noise=tengine.NoiseModel("amplitude_damping", 0.3, "encode"),
            **kw)
    return got.numpy(), want


def test_dm_at_11_wires_runs_the_sel_chain_on_both_sides(monkeypatch):
    """Past the dm kernel's 10 wires: the SEL chain's entry on both sides
    of rho (its plain version here), at L 1, k 1 and one image."""
    from qiddm_tpu_torch.sim import dm_kernel

    calls = []
    real = tengine.sel_chain_planes

    def spy(sr, si, *args):
        calls.append(sr.shape)
        return real(sr, si, *args)

    monkeypatch.setattr(tengine, "sel_chain_planes", spy)
    before = dm_kernel.DM_LAUNCHES
    got, want = _dm_block(11, "rz", np.float32, 1, 1)
    assert calls == [(2**11, 2**11)] * 2 and not _routes()
    assert dm_kernel.DM_LAUNCHES == before
    np.testing.assert_allclose(got, want, atol=TOL[np.float32])


def test_dm_in_complex128_runs_sel_apply_gates_on_both_sides():
    jconfig.enable_x64(True)
    try:
        got, want = _dm_block(4, "ry", np.float64, 2, 2)
    finally:
        jconfig.enable_x64(False)
    assert _routes() == {"gates": 4}
    np.testing.assert_allclose(got, want, atol=TOL[np.float64])


def test_dm_above_12_wires_raises_as_jax_does():
    noise = tengine.NoiseModel("amplitude_damping", 0.3, "encode")
    with pytest.raises(ValueError, match="capped at 12 wires"):
        tengine.reupload_block(torch.zeros(1, 13), torch.zeros(1, 1, 13, 3),
                               noise=noise)
    with pytest.raises(ValueError, match="capped at 12 wires"):
        tengine.qnn_circuit(torch.zeros(1, 13), torch.zeros(1, 13, 3),
                            noise=noise)
