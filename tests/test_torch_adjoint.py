"""The gate-by-gate SEL chain and the per-gate adjoint chains of
qiddm_tpu_torch against qiddm_tpu on the CPU: ``sel.sel_apply_gates``,
``wide.sel_chain_adjoint`` and ``wide.reupload_chain_adjoint``
(forward and gradients, both rings, the RZ and RY re-uploads, float32 and
float64), the adjoint backward against torch autograd through the same
forward with no Function and against ``torch.autograd.gradcheck`` in
complex128, the rings' deduplicated tables, the residuals a chain keeps,
and the two routing modes.

Gradients are taken in real inputs (encoding angles, weights, and the
features of an amplitude embedding), where both packages' conventions for
complex cotangents agree.

Tolerances: float32 states and probabilities <= 1e-5, gradients <= 1e-4
relative to the largest entry of JAX's; float64 <= 1e-10 and 1e-8; the
Function's backward against autograd through its own forward <= 1e-5
(float32) relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import config as jconfig
from qiddm_tpu.sim import adjoint as jadj
from qiddm_tpu.sim import sel as jsel
from qiddm_tpu.sim import statevector as jsv
from qiddm_tpu_torch import config as tconfig
from qiddm_tpu_torch.sim import sel as tsel
from qiddm_tpu_torch.sim import statevector as tsv
from qiddm_tpu_torch.sim import wide as tadj

STATE_TOL = {np.float32: 1e-5, np.float64: 1e-10}
GRAD_TOL = {np.float32: 1e-4, np.float64: 1e-8}
BWD_TOL = 1e-5


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
def x64():
    """float64 in both packages for the test, restored after."""
    jconfig.enable_x64(True)
    yield
    jconfig.enable_x64(False)


def _rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _coeff(n, d, dtype):
    return np.random.default_rng(99).normal(size=(n, d)).astype(dtype)


def _sel_pair(fn_j, fn_t, wires, depth, ring, dtype, batch=3):
    """Values and (features, weights) gradients of a weighted probability
    sum of an SEL chain on amplitude-embedded states, in both packages."""
    rng = np.random.default_rng(wires * 10 + depth)
    x = rng.uniform(size=(batch, 2**wires)).astype(dtype)
    w = (rng.normal(size=(depth, wires, 3)) * 0.6).astype(dtype)
    coeff = _coeff(batch, 2**wires, dtype)
    cj = jnp.complex128 if dtype == np.float64 else jnp.complex64
    ct = torch.complex128 if dtype == np.float64 else torch.complex64

    def jloss(xx, ww):
        st = fn_j(jsv.amplitude_embed(xx, wires, dtype=cj), ww, ring)
        return jnp.sum(jnp.asarray(coeff) * jsv.probs(st)), st

    (_, jst), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.as_tensor(x).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    st = fn_t(tsv.amplitude_embed(tx, wires, dtype=ct), tw, ring)
    (torch.as_tensor(coeff) * tsv.probs(st)).sum().backward()
    return (st.detach().numpy(), np.asarray(jst),
            [tx.grad.numpy(), tw.grad.numpy()], [np.asarray(g) for g in jg])


@pytest.mark.parametrize("wires,depth", [(1, 3), (3, 5), (5, 7)])
@pytest.mark.parametrize("ring", ["cz", "cnot"])
def test_sel_apply_gates_matches_jax(wires, depth, ring):
    got, want, tg, jg = _sel_pair(jsel.sel_apply_gates, tsel.sel_apply_gates,
                                  wires, depth, ring, np.float32)
    np.testing.assert_allclose(got, want, atol=STATE_TOL[np.float32])
    for g, j in zip(tg, jg):
        _rel(g, j, GRAD_TOL[np.float32])


@pytest.mark.parametrize("wires,depth", [(2, 3), (4, 6)])
@pytest.mark.parametrize("ring", ["cz", "cnot"])
def test_sel_chain_adjoint_matches_jax(wires, depth, ring):
    got, want, tg, jg = _sel_pair(jadj.sel_chain_adjoint,
                                  tadj.sel_chain_adjoint, wires, depth, ring,
                                  np.float32)
    np.testing.assert_allclose(got, want, atol=STATE_TOL[np.float32])
    for g, j in zip(tg, jg):
        _rel(g, j, GRAD_TOL[np.float32])


@pytest.mark.parametrize("ring", ["cz", "cnot"])
def test_sel_chain_adjoint_matches_jax_in_float64(ring, x64):
    got, want, tg, jg = _sel_pair(jadj.sel_chain_adjoint,
                                  tadj.sel_chain_adjoint, 4, 5, ring,
                                  np.float64)
    np.testing.assert_allclose(got, want, atol=STATE_TOL[np.float64])
    for g, j in zip(tg, jg):
        _rel(g, j, GRAD_TOL[np.float64])


def _reupload_pair(encode, ring, dtype, wires=4, L=3, k=2, batch=3):
    rng = np.random.default_rng(wires + L + len(encode))
    x = rng.normal(size=(batch, wires)).astype(dtype)
    w = (rng.normal(size=(L, k, wires, 3)) * 0.5).astype(dtype)
    coeff = _coeff(batch, 2**wires, dtype)
    cj = jnp.complex128 if dtype == np.float64 else jnp.complex64
    ct = torch.complex128 if dtype == np.float64 else torch.complex64

    def jloss(xx, ww):
        st = jadj.reupload_chain_adjoint(xx, ww, encode=encode,
                                         imprimitive=ring, cdtype=cj)
        return jnp.sum(jnp.asarray(coeff) * jsv.probs(st)), st

    (_, jst), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.as_tensor(x).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    st = tadj.reupload_chain_adjoint(tx, tw, encode=encode, imprimitive=ring,
                                     cdtype=ct)
    (torch.as_tensor(coeff) * tsv.probs(st)).sum().backward()
    return (st.detach().numpy(), np.asarray(jst),
            [tx.grad.numpy(), tw.grad.numpy()], [np.asarray(g) for g in jg])


@pytest.mark.parametrize("encode", ["rz", "ry"])
@pytest.mark.parametrize("ring", ["cz", "cnot"])
def test_reupload_chain_adjoint_matches_jax(encode, ring):
    got, want, tg, jg = _reupload_pair(encode, ring, np.float32)
    np.testing.assert_allclose(got, want, atol=STATE_TOL[np.float32])
    for g, j in zip(tg, jg):
        _rel(g, j, GRAD_TOL[np.float32])


@pytest.mark.parametrize("encode,ring", [("rz", "cnot"), ("ry", "cz")])
def test_reupload_chain_adjoint_matches_jax_in_float64(encode, ring, x64):
    got, want, tg, jg = _reupload_pair(encode, ring, np.float64)
    np.testing.assert_allclose(got, want, atol=STATE_TOL[np.float64])
    for g, j in zip(tg, jg):
        _rel(g, j, GRAD_TOL[np.float64])


@pytest.mark.parametrize("encode", ["rz", "ry"])
@pytest.mark.parametrize("ring", ["cz", "cnot"])
def test_adjoint_backward_matches_autograd_of_its_forward(encode, ring):
    """The Function's backward against torch autograd through the chain's
    own forward (``_WideConfig.forward`` with one-wire groups, plain ops,
    no Function)."""
    rng = np.random.default_rng(5)
    wires, L, k = 4, 2, 2
    x = torch.as_tensor(rng.normal(size=(3, wires)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(L, k, wires, 3)) * 0.5,
                        dtype=torch.float32)
    coeff = torch.as_tensor(_coeff(3, 2**wires, np.float32))
    grads = []
    for function in (True, False):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if function:
            st = tadj.reupload_chain_adjoint(xx, ww, encode=encode,
                                             imprimitive=ring)
        else:
            sizes = (1,) * wires
            kind, enc = tadj._encoding(xx, encode, wires, torch.complex64,
                                       sizes)
            gs = tadj._sublayer_groups(ww, sizes, torch.complex64)
            cfg = tadj._WideConfig(L, k, wires, ring, kind, False, sizes)
            st = cfg.forward(tsv.zero_state(3, wires, dtype=torch.complex64,
                                            device=x.device), enc, gs)
        (coeff * tsv.probs(st)).sum().backward()
        grads.append((xx.grad, ww.grad))
    for got, want in zip(*grads):
        _rel(got.numpy(), want.numpy(), BWD_TOL)


@pytest.mark.parametrize("ring", ["cz", "cnot"])
def test_adjoint_chains_pass_gradcheck_in_complex128(ring):
    rng = np.random.default_rng(6)
    st = torch.as_tensor(rng.normal(size=(2, 8)) + 1j * rng.normal(
        size=(2, 8))).requires_grad_(True)
    w = torch.as_tensor(rng.normal(size=(4, 3, 3))).requires_grad_(True)
    wgt = torch.linspace(0.0, 1.0, 8, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda s, q: (tsv.probs(tadj.sel_chain_adjoint(s, q, ring))
                      * wgt).sum(), (st, w))
    for encode in ("rz", "ry"):
        x = torch.as_tensor(rng.normal(size=(2, 4))).requires_grad_(True)
        wq = torch.as_tensor(rng.normal(size=(2, 2, 4, 3))).requires_grad_(
            True)
        wgt = torch.linspace(0.0, 1.0, 16, dtype=torch.float64)
        assert torch.autograd.gradcheck(
            lambda a, b: (tsv.probs(tadj.reupload_chain_adjoint(
                a, b, encode=encode, imprimitive=ring,
                cdtype=torch.complex128)) * wgt).sum(), (x, wq))


def test_ring_tables_are_deduplicated():
    """One row per distinct range: a re-upload block's ranges restart every
    layer (k rows), the SEL chain's cycle over its depth (at most w - 1)."""
    kind, ranges, idx = tadj._ring_tables(14, 2, 20, "cz", False)
    assert kind == "cz" and ranges == (1, 2)
    assert idx == ((0, 1),) * 14
    kind, ranges, idx = tadj._ring_tables(30, 1, 6, "cnot", True)
    assert ranges == (1, 2, 3, 4, 5)
    assert [ranges[i[0]] for i in idx] == tsel.sel_ranges(30, 6)
    assert tadj._ring_tables(3, 2, 1, "cz", True)[0] == "none"
    with pytest.raises(ValueError, match="unknown imprimitive"):
        tadj._ring_tables(3, 2, 4, "cy", True)


def _saved_states(fn, numel):
    """The complex tensors of ``numel`` elements that autograd saves while
    ``fn`` runs forward."""
    saved = []

    def pack(t):
        if t.is_complex() and t.numel() == numel:
            saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return len(saved)


def test_adjoint_chains_save_O1_states():
    """The adjoint chains save the final state and the RZ phases; autograd
    through ``sel_apply_gates`` saves a state a gate, L*k*w of them."""
    rng = np.random.default_rng(7)
    L, k, wires, b = 3, 2, 5, 4
    x = torch.as_tensor(rng.normal(size=(b, wires)), dtype=torch.float32,
                        ).requires_grad_(True)
    w = torch.as_tensor(rng.normal(size=(L, k, wires, 3)),
                        dtype=torch.float32).requires_grad_(True)
    numel = b * 2**wires
    adjoint = _saved_states(
        lambda: tadj.reupload_chain_adjoint(x, w, imprimitive="cz"), numel)

    def plain():
        st = tsv.zero_state(b, wires, dtype=torch.complex64, device=x.device)
        phases = tsv.rz_phases(x, wires)
        for l in range(L):
            st = tsel.sel_apply_gates(st * phases, w[l], "cz")

    assert adjoint <= 2
    assert _saved_states(plain, numel) >= L * k * wires
    st = tsv.amplitude_embed(x[:, :3].detach(), wires).requires_grad_(True)
    assert _saved_states(
        lambda: tadj.sel_chain_adjoint(st, w[0], "cnot"), numel) <= 1


def test_modes_are_validated_and_default_to_auto():
    assert tconfig.adjoint_mode() == "auto" and tconfig.wide_mode() == "auto"
    for setter in (tconfig.set_adjoint_mode, tconfig.set_wide_mode):
        with pytest.raises(ValueError):
            setter("sometimes")
    for mode in ("on", "off", "auto"):
        tconfig.set_adjoint_mode(mode)
        tconfig.set_wide_mode(mode)
        assert tconfig.adjoint_mode() == tconfig.wide_mode() == mode


def test_route_counters_count_calls():
    tsel.reset_route_calls()
    st = tsv.zero_state(2, 3, dtype=torch.complex64, device="cpu")
    w = torch.zeros(2, 3, 3)
    tsel.sel_apply_gates(st, w)
    tadj.sel_chain_adjoint(st, w)
    tadj.reupload_chain_adjoint(torch.zeros(2, 3), torch.zeros(1, 2, 3, 3))
    assert tsel.ROUTE_CALLS == {"gates": 1, "adjoint": 2, "wide": 0,
                                "amp_xla": 0}
