"""The wide (11-20 wire) re-uploading chain of qiddm_tpu_torch against
qiddm_tpu on the CPU: the group partition and the group matrices, the
port's chain (its plain versions, run by ``wide_chain_planes`` on CPU
tensors) against the JAX package's XLA grouped chain
(``wide.reupload_chain_wide`` with ``wide_mode("on")``,
``wide_kernel_mode("off")``) and against its Pallas kernels in interpret
mode (``wide_kernel_mode("on")``, variants ``"scan"`` and ``"monolith"``,
the port's variant set the same), the variant switch against the JAX
package's, and the real-plane backward against torch autograd through the
plain forward.

Tolerances: final states <= 1e-5 and the gradients of a weighted
probability sum in ``x_enc`` and the weights <= 2e-5, both absolute, the
JAX package's own (tests/test_wide_kernel.py); the plain backward against
autograd <= 1e-5 relative to max(1, max|autograd|), as for the gate chain
(tests/test_torch_gate_kernel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import config as jconfig
from qiddm_tpu.sim import wide as jwide
from qiddm_tpu.sim.gates import rot_matrix as jrot
from qiddm_tpu_torch import config as tconfig
from qiddm_tpu_torch.sim import engine, gate_kernel, wide, wide_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix
from qiddm_tpu_torch.sim.statevector import rz_phase_planes

STATE_TOL = 1e-5
GRAD_TOL = 2e-5
BWD_TOL = 1e-5


def _angles(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.7).astype(
        np.float32)


def _jax_run(x, wq):
    """Loss, final states and (x, weights) gradients of the JAX chain."""
    def loss(x, wq):
        st = jwide.reupload_chain_wide(x, wq, encode="rz", imprimitive="cz")
        p = jnp.real(st) ** 2 + jnp.imag(st) ** 2
        return jnp.sum(p * jnp.linspace(0.0, 1.0, 2**x.shape[1])), st

    (val, st), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(jnp.asarray(x),
                                                        jnp.asarray(wq))
    return float(val), np.asarray(st), [np.asarray(g) for g in grads]


def _torch_run(x, wq):
    """The same through the port's plane entry, with the engine's RZ
    phases and rotations."""
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(wq).requires_grad_(True)
    L, k, w, _ = wq.shape
    flat = wt.reshape(L * k, w, 3)
    mats = rot_matrix(flat[..., 0], flat[..., 1], flat[..., 2])
    pr, pi = rz_phase_planes(xt, w)
    sr, si = wide_kernel.wide_chain_planes(pr, pi, mats, k, w)
    st = torch.complex(sr, si).T
    p = st.real ** 2 + st.imag ** 2
    val = (p * torch.linspace(0.0, 1.0, 2**x.shape[1])).sum()
    val.backward()
    return val.item(), st.detach().numpy(), [xt.grad.numpy(),
                                             wt.grad.numpy()]


@pytest.fixture
def jax_modes():
    """Set the JAX wide routes, and the same kernel variant in the port,
    for one test and restore them after."""
    prev = (jconfig.wide_mode(), jconfig.wide_kernel_mode(),
            jconfig.wide_kernel_variant(), tconfig.wide_kernel_variant())

    def set_modes(kernel: str, variant: str = "scan"):
        jconfig.set_wide_mode("on")
        jconfig.set_wide_kernel_mode(kernel)
        jconfig.set_wide_kernel_variant(variant)
        tconfig.set_wide_kernel_variant(variant)

    yield set_modes
    jconfig.set_wide_mode(prev[0])
    jconfig.set_wide_kernel_mode(prev[1])
    jconfig.set_wide_kernel_variant(prev[2])
    tconfig.set_wide_kernel_variant(prev[3])


@pytest.mark.parametrize("wires", list(range(1, 21)))
def test_group_sizes_match_jax(wires):
    got = wide.group_sizes(wires)
    assert got == jwide.group_sizes(wires, jwide.max_group_bits())
    assert sum(got) == wires and max(got) <= tconfig.MAX_GROUP_BITS == 7
    assert tconfig.MAX_GROUP_BITS == jwide.max_group_bits()


def test_group_sizes_reject_no_wires():
    with pytest.raises(ValueError, match="positive"):
        wide.group_sizes(0)


@pytest.mark.parametrize("wires", [4, 11, 16])
def test_group_gates_match_jax(wires):
    ang = _angles(wires, 3, wires, 3)
    sizes = wide.group_sizes(wires)
    want = jwide.group_gates(jrot(ang[..., 0], ang[..., 1], ang[..., 2]),
                             sizes)
    a = torch.as_tensor(ang)
    got = wide.group_gates(rot_matrix(a[..., 0], a[..., 1], a[..., 2]),
                           sizes)
    assert [tuple(g.shape) for g in got] == [(3, 2**s, 2**s) for s in sizes]
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-6)


def _check_against_jax(w, L, k, b):
    x = _angles(1, b, w)
    wq = _angles(2, L, k, w, 3) * 0.6
    v_j, st_j, g_j = _jax_run(x, wq)
    v_t, st_t, g_t = _torch_run(x, wq)
    np.testing.assert_allclose(st_t, st_j, atol=STATE_TOL)
    np.testing.assert_allclose(v_t, v_j, rtol=STATE_TOL)
    for got, want in zip(g_t, g_j):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL)


@pytest.mark.parametrize("w,L,k,b", [(11, 2, 2, 3), (13, 2, 1, 3),
                                     (16, 1, 2, 2)])
def test_chain_matches_jax_xla_grouped_chain(jax_modes, w, L, k, b):
    jax_modes("off")
    assert not jwide._use_wide_kernel(w, "rz", "cz", jnp.complex64)
    _check_against_jax(w, L, k, b)


@pytest.mark.parametrize("variant", ["scan", "monolith"])
@pytest.mark.parametrize("w,L,k,b", [(13, 2, 1, 3), (15, 1, 2, 2)])
def test_chain_matches_jax_pallas_scan_interpret(jax_modes, w, L, k, b,
                                                 variant):
    """The port's chain, with its kernel variant set as the JAX package's,
    against the JAX Pallas kernels in interpret mode: the per-sublayer
    scan (#11/#12) and the monolith (#9/#10), which the JAX package runs
    at any depth off the TPU."""
    jax_modes("on", variant)
    assert jwide._use_wide_kernel(w, "rz", "cz", jnp.complex64)
    assert tconfig.wide_kernel_variant() == variant
    _check_against_jax(w, L, k, b)


@pytest.mark.parametrize("variant", ["scan", "monolith", "off", "auto", "",
                                     "Monolith"])
def test_variant_switch_mirrors_jax(jax_modes, variant):
    """``set_wide_kernel_variant`` takes and refuses what the JAX package's
    takes and refuses, with a ValueError, and keeps its value on a
    refusal."""
    jax_modes("off")
    try:
        jconfig.set_wide_kernel_variant(variant)
    except ValueError:
        with pytest.raises(ValueError):
            tconfig.set_wide_kernel_variant(variant)
        assert tconfig.wide_kernel_variant() == "scan"
    else:
        tconfig.set_wide_kernel_variant(variant)
        assert tconfig.wide_kernel_variant() == variant


def _bwd_args(w, B, n_layers, k, seed=0):
    """Inputs of one backward call: phase planes, group planes, the plain
    forward's output and N(0, 1) cotangents."""
    rng = np.random.default_rng(seed)
    ang = torch.as_tensor(rng.normal(size=(n_layers, w, 3)),
                          dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(2**w, B)), dtype=torch.float32)
    mats = rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2])
    gplanes = wide_kernel._planes_of(
        wide.group_gates(mats, wide.group_sizes(w)))
    pr, pi = torch.cos(x), torch.sin(x)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    fr, fi = wide_kernel._chain_plain(pr, pi, gplanes, signs, k, w)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**w, B)),
                              dtype=torch.float32) for _ in range(2))
    return pr, pi, gplanes, signs, fr, fi, gr, gi


def _assert_rel(got, want, tol=BWD_TOL):
    err = (got - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("w,B,n_layers,k", [(1, 2, 2, 2), (3, 4, 4, 2),
                                            (8, 3, 6, 3), (11, 2, 4, 2),
                                            (15, 1, 2, 1)])
def test_bwd_plain_matches_autograd_of_plain_forward(w, B, n_layers, k):
    pr, pi, gplanes, signs, _, _, gr, gi = _bwd_args(w, B, n_layers, k)
    leaves = [t.clone().requires_grad_(True) for t in (pr, pi, *gplanes)]
    sr, si = wide_kernel._chain_plain(leaves[0], leaves[1], leaves[2:],
                                      signs, k, w)
    (sr * gr + si * gi).sum().backward()
    fr, fi = sr.detach(), si.detach()
    dpr, dpi, dg = wide_kernel.wide_chain_bwd_plain(pr, pi, gplanes, fr, fi,
                                                    gr, gi, k, w)
    for got, leaf in zip((dpr, dpi, *dg), leaves):
        assert got.shape == leaf.shape
        _assert_rel(got, leaf.grad)


def test_sublayer_plain_is_the_group_products_then_the_signs():
    """One sublayer against its dense unitary: the Kronecker product of
    the group matrices, then the ring's sign diagonal."""
    w, B = 9, 3
    pr, pi, gplanes, signs, *_ = _bwd_args(w, B, 2, 2, seed=4)
    sr, si = wide_kernel.wide_sub_plain(
        pr, pi, [g[1] for g in gplanes], signs[1], w)
    u = torch.ones((1, 1), dtype=torch.complex64)
    for j in range(0, len(gplanes), 2):
        u = torch.kron(u, torch.complex(gplanes[j][1], gplanes[j + 1][1]))
    want = signs[1] * (u @ torch.complex(pr, pi))
    np.testing.assert_allclose(torch.complex(sr, si).numpy(), want.numpy(),
                               atol=STATE_TOL)


def test_function_cpu_backward_matches_autograd_of_plain():
    """Through ``wide_chain_planes`` (the autograd Function, plain on the
    CPU) the gradients in the phases and the rotations equal autograd's
    through the plain chain, and nothing launches."""
    w, k = 11, 2
    rng = np.random.default_rng(6)
    ang = torch.as_tensor(rng.normal(size=(4, w, 3)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(2**w, 3)), dtype=torch.float32)
    grads = []
    before = (wide_kernel.WIDE_LAUNCHES, wide_kernel.WIDE_BWD_LAUNCHES)
    for fn in (wide_kernel.wide_chain_planes,
               wide_kernel.wide_chain_planes_plain):
        a = ang.clone().requires_grad_(True)
        xt = x.clone().requires_grad_(True)
        mats = rot_matrix(a[..., 0], a[..., 1], a[..., 2])
        sr, si = fn(torch.cos(xt), torch.sin(xt), mats, k, w)
        # the probs readout hands back a transposed view
        ((sr * sr + si * si).T[:, :50] ** 2).sum().backward()
        grads.append((a.grad, xt.grad))
    assert (wide_kernel.WIDE_LAUNCHES,
            wide_kernel.WIDE_BWD_LAUNCHES) == before
    for got, want in zip(*grads):
        _assert_rel(got, want)


def test_unported_wide_options_raise():
    """The wide SEL chain (the JAX package's ``sel_chain_wide``, QNN and
    Qdense above 12 wires) is ported: both circuits run it at 13 wires and
    a batch below 2^13, and match the JAX package's grouped chain."""
    w = 13
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, w)).astype(np.float32)
    xd = rng.uniform(size=(2, 16)).astype(np.float32)
    wq = (rng.normal(size=(2, w, 3)) * 0.5).astype(np.float32)
    from qiddm_tpu import sim as jsim

    jconfig.set_wide_mode("on")
    try:
        want = (np.asarray(jsim.qnn_circuit(jnp.asarray(x), jnp.asarray(wq),
                                            readout="probs")),
                np.asarray(jsim.qdense_circuit(jnp.asarray(xd),
                                               jnp.asarray(wq), wires=w)))
    finally:
        jconfig.set_wide_mode("auto")
    engine.reset_route_calls()
    with torch.no_grad():
        got = (engine.qnn_circuit(torch.as_tensor(x), torch.as_tensor(wq),
                                  readout="probs"),
               engine.qdense_circuit(torch.as_tensor(xd),
                                     torch.as_tensor(wq), wires=w))
    assert engine.ROUTE_CALLS["wide"] == 2
    for g, want_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), want_, atol=STATE_TOL)
