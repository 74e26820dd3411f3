"""The grouped-Kronecker chain of qiddm_tpu_torch (``wide.reupload_chain_wide``
and ``wide.sel_chain_wide``, the routes past the kernels' widths) against
qiddm_tpu's XLA grouped chain on the CPU: the RZ, RY and no encode, both
rings, float32 and float64, forward and gradients; its backward against
torch autograd through the same forward with no Function and against
``torch.autograd.gradcheck`` in complex128; the residuals it keeps; and
that it runs no kernel's plain twin.

Gradients are taken in real inputs (encoding angles, weights, the features
of an amplitude embedding), where both packages' conventions for complex
cotangents agree.

Tolerances: float32 states <= 1e-5, gradients <= 1e-4 relative to the
largest entry of JAX's; float64 <= 1e-10 and 1e-8; the backward against
autograd through its own forward <= 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import config as jconfig
from qiddm_tpu.sim import statevector as jsv
from qiddm_tpu.sim import wide as jwide
from qiddm_tpu_torch.sim import sel as tsel
from qiddm_tpu_torch.sim import statevector as tsv
from qiddm_tpu_torch.sim import wide as twide
from qiddm_tpu_torch.sim import wide_kernel

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


def _rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _dtypes(dtype):
    if dtype == np.float64:
        return jnp.complex128, torch.complex128
    return jnp.complex64, torch.complex64


def _reupload(encode, ring, dtype, wires, L=2, k=2, batch=3):
    rng = np.random.default_rng(wires + 3 * L + len(encode))
    x = rng.normal(size=(batch, wires)).astype(dtype)
    w = (rng.normal(size=(L, k, wires, 3)) * 0.5).astype(dtype)
    coeff = rng.normal(size=(batch, 2**wires)).astype(dtype)
    cj, ct = _dtypes(dtype)

    def jloss(xx, ww):
        st = jwide.reupload_chain_wide(xx, ww, encode=encode,
                                       imprimitive=ring, cdtype=cj)
        return jnp.sum(jnp.asarray(coeff) * jsv.probs(st)), st

    (_, jst), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.as_tensor(x).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    st = twide.reupload_chain_wide(tx, tw, encode=encode, imprimitive=ring,
                                   cdtype=ct)
    (torch.as_tensor(coeff) * tsv.probs(st)).sum().backward()
    return (st.detach().numpy(), np.asarray(jst),
            [tx.grad.numpy(), tw.grad.numpy()], [np.asarray(g) for g in jg])


def _check(run, dtype):
    got, want, tg, jg = run
    np.testing.assert_allclose(got, want, atol=STATE_TOL[dtype])
    for g, j in zip(tg, jg):
        _rel(g, j, GRAD_TOL[dtype])


# widths with one, two and three groups (3 -> (3,), 9 -> (5, 4),
# 15 -> (5, 5, 5)); each encode meets each ring once
@pytest.mark.parametrize("encode,ring,wires", [
    ("rz", "cz", 9), ("ry", "cnot", 9), ("rz", "cnot", 3), ("ry", "cz", 3)])
def test_reupload_chain_wide_matches_jax(encode, ring, wires):
    _check(_reupload(encode, ring, np.float32, wires), np.float32)


def test_reupload_chain_wide_matches_jax_at_three_groups():
    _check(_reupload("ry", "cnot", np.float32, 15, L=1, k=1, batch=2),
           np.float32)


@pytest.mark.parametrize("encode,ring", [("rz", "cnot"), ("ry", "cz")])
def test_reupload_chain_wide_matches_jax_in_float64(encode, ring):
    jconfig.enable_x64(True)
    try:
        run = _reupload(encode, ring, np.float64, 9)
    finally:
        jconfig.enable_x64(False)
    _check(run, np.float64)


def _sel(ring, dtype, wires, depth, batch=3):
    rng = np.random.default_rng(wires + depth)
    x = rng.uniform(size=(batch, 2**wires)).astype(dtype)
    w = (rng.normal(size=(depth, wires, 3)) * 0.6).astype(dtype)
    coeff = rng.normal(size=(batch, 2**wires)).astype(dtype)
    cj, ct = _dtypes(dtype)

    def jloss(xx, ww):
        st = jwide.sel_chain_wide(jsv.amplitude_embed(xx, wires, dtype=cj),
                                  ww, ring)
        return jnp.sum(jnp.asarray(coeff) * jsv.probs(st)), st

    (_, jst), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.as_tensor(x).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    st = twide.sel_chain_wide(tsv.amplitude_embed(tx, wires, dtype=ct), tw,
                              ring)
    (torch.as_tensor(coeff) * tsv.probs(st)).sum().backward()
    return (st.detach().numpy(), np.asarray(jst),
            [tx.grad.numpy(), tw.grad.numpy()], [np.asarray(g) for g in jg])


@pytest.mark.parametrize("ring,wires,depth", [("cz", 4, 9),
                                               ("cnot", 10, 3)])
def test_sel_chain_wide_matches_jax(ring, wires, depth):
    _check(_sel(ring, np.float32, wires, depth), np.float32)


@pytest.mark.parametrize("ring", ["cnot"])
def test_sel_chain_wide_matches_jax_in_float64(ring):
    jconfig.enable_x64(True)
    try:
        run = _sel(ring, np.float64, 9, 4)
    finally:
        jconfig.enable_x64(False)
    _check(run, np.float64)


@pytest.mark.parametrize("encode", ["rz", "ry", "none"])
@pytest.mark.parametrize("ring", ["cz", "cnot"])
def test_wide_backward_matches_autograd_of_its_forward(encode, ring):
    """The Function's backward against torch autograd through the chain's
    own forward (``_WideConfig.forward``, plain ops, no Function), with the
    start state a leaf too."""
    rng = np.random.default_rng(11)
    wires, L, k, b = 9, 2, 2, 3
    sizes = twide.group_sizes(wires)
    x = torch.as_tensor(rng.normal(size=(b, wires)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(L, k, wires, 3)) * 0.5,
                        dtype=torch.float32)
    s0 = tsv.amplitude_embed(torch.as_tensor(rng.uniform(size=(b, 40)),
                                             dtype=torch.float32), wires)
    coeff = torch.as_tensor(rng.normal(size=(b, 2**wires)),
                            dtype=torch.float32)
    cfg = twide._WideConfig(L, k, wires, ring, encode, encode == "none",
                            sizes)
    grads = []
    for function in (True, False):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        ss = s0.clone().requires_grad_(True)
        gs = twide._sublayer_groups(ww, sizes, torch.complex64)
        if encode == "none":
            enc = ()
        else:
            _, enc = twide._encoding(xx, encode, wires, torch.complex64,
                                     sizes)
        if function:
            st = twide._WideChain.apply(cfg, len(enc), ss, *enc, *gs)
        else:
            st = cfg.forward(ss, enc, gs)
        (coeff * tsv.probs(st)).sum().backward()
        grads.append((ss.grad, ww.grad) if encode == "none"
                     else (ss.grad, xx.grad, ww.grad))
    for got, want in zip(*grads):
        _rel(torch.view_as_real(got).numpy() if got.is_complex()
             else got.numpy(),
             torch.view_as_real(want).numpy() if want.is_complex()
             else want.numpy(), BWD_TOL)


@pytest.mark.parametrize("ring", ["cz", "cnot"])
def test_wide_chains_pass_gradcheck_in_complex128(ring):
    rng = np.random.default_rng(13)
    st = torch.as_tensor(rng.normal(size=(2, 16)) + 1j * rng.normal(
        size=(2, 16))).requires_grad_(True)
    w = torch.as_tensor(rng.normal(size=(3, 4, 3))).requires_grad_(True)
    wgt = torch.linspace(0.0, 1.0, 16, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda s, q: (tsv.probs(twide.sel_chain_wide(s, q, ring))
                      * wgt).sum(), (st, w))
    for encode in ("rz", "ry"):
        x = torch.as_tensor(rng.normal(size=(2, 3))).requires_grad_(True)
        wq = torch.as_tensor(rng.normal(size=(2, 2, 3, 3))).requires_grad_(
            True)
        wgt = torch.linspace(0.0, 1.0, 8, dtype=torch.float64)
        assert torch.autograd.gradcheck(
            lambda a, b: (tsv.probs(twide.reupload_chain_wide(
                a, b, encode=encode, imprimitive=ring,
                cdtype=torch.complex128)) * wgt).sum(), (x, wq))


def test_wide_chain_saves_O1_states():
    """The grouped chain saves the final state and the RZ phases; autograd
    through ``sel_apply_gates`` saves a state a gate, L*k*w of them."""
    rng = np.random.default_rng(14)
    L, k, wires, b = 3, 2, 9, 2
    x = torch.as_tensor(rng.normal(size=(b, wires)),
                        dtype=torch.float32).requires_grad_(True)
    w = torch.as_tensor(rng.normal(size=(L, k, wires, 3)),
                        dtype=torch.float32).requires_grad_(True)
    numel = b * 2**wires
    saved = {"wide": 0, "plain": 0}

    def pack_into(key):
        def pack(t):
            if t.is_complex() and t.numel() == numel:
                saved[key] += 1
            return t
        return pack

    with torch.autograd.graph.saved_tensors_hooks(pack_into("wide"),
                                                  lambda t: t):
        twide.reupload_chain_wide(x, w)
    with torch.autograd.graph.saved_tensors_hooks(pack_into("plain"),
                                                  lambda t: t):
        st = tsv.zero_state(b, wires, dtype=torch.complex64, device="cpu")
        phases = tsv.rz_phases(x, wires)
        for l in range(L):
            st = tsel.sel_apply_gates(st * phases, w[l], "cz")
    assert saved["wide"] <= 2
    assert saved["plain"] >= L * k * wires


def test_wide_chain_runs_no_kernel_twin(monkeypatch):
    """The grouped chain is its own code: it calls neither the wide chain
    kernels' wrapper nor their plain versions, and moves no launch count."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel's plain twin ran")

    for name in ("wide_chain_planes", "wide_chain_planes_plain",
                 "wide_chain_bwd_plain"):
        monkeypatch.setattr(wide_kernel, name, refuse)
    before = (wide_kernel.WIDE_LAUNCHES, wide_kernel.WIDE_BWD_LAUNCHES)
    x = torch.rand(2, 11, requires_grad=True)
    w = torch.rand(1, 2, 11, 3, requires_grad=True)
    tsel.reset_route_calls()
    twide.reupload_chain_wide(x, w).abs().sum().backward()
    assert tsel.ROUTE_CALLS["wide"] == 1
    assert (wide_kernel.WIDE_LAUNCHES,
            wide_kernel.WIDE_BWD_LAUNCHES) == before
    assert twide.max_group_bits() == 7
