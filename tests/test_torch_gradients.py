"""Parameter-shift gradients in qiddm_tpu_torch (``sim/gradients.py``)
against qiddm_tpu's ``parameter_shift_grad`` and against the port's own
autograd, on the CPU: the three cases of tests/test_gradients.py, each at
its bound (2e-4 for a gradient, 1e-6 chunked against unchunked), and the
operators' batching rule, which runs the gate chain once for each shifted
weight set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import sim as jsim
from qiddm_tpu.sim.gradients import parameter_shift_grad as jshift
from qiddm_tpu_torch import sim as tsim
from qiddm_tpu_torch.sim import gate_kernel
from qiddm_tpu_torch.sim.gradients import parameter_shift_grad

GRAD_TOL = 2e-4
CHUNK_TOL = 1e-6


def _expvals_case():
    rng = np.random.default_rng(17)
    wires, L, k = 3, 2, 2
    w = (rng.normal(size=(L, k, wires, 3)) * 0.4).astype(np.float32)
    x = rng.normal(size=(4, wires)).astype(np.float32)
    coeff = rng.normal(size=(wires,)).astype(np.float32)

    def jf(w):
        ev = jsim.reupload_block(jnp.asarray(x), w, encode="rz",
                                 imprimitive="cz", readout="expvalz")
        return jnp.sum(ev @ jnp.asarray(coeff))

    def tf(w):
        ev = tsim.reupload_block(torch.as_tensor(x), w, encode="rz",
                                 imprimitive="cz", readout="expvalz")
        return torch.sum(ev @ torch.as_tensor(coeff))

    return w, jf, tf


def _probs_case():
    rng = np.random.default_rng(18)
    wires, depth = 3, 2
    w = (rng.normal(size=(depth, wires, 3)) * 0.4).astype(np.float32)
    x = (np.abs(rng.normal(size=(2, 5))) + 0.1).astype(np.float32)
    sel = rng.normal(size=(2**wires,)).astype(np.float32)

    def jf(w):
        p = jsim.qdense_circuit(jnp.asarray(x), w, wires=wires,
                                weight_map="none")
        return jnp.sum(p @ jnp.asarray(sel))

    def tf(w):
        p = tsim.qdense_circuit(torch.as_tensor(x), w, wires=wires,
                                weight_map="none")
        return torch.sum(p @ torch.as_tensor(sel))

    return w, jf, tf


@pytest.mark.parametrize("case", [_expvals_case, _probs_case],
                         ids=["expvals", "probs"])
def test_parameter_shift_matches_jax_and_autograd(case):
    w, jf, tf = case()
    want = np.asarray(jshift(jf, jnp.asarray(w)))
    got = parameter_shift_grad(tf, torch.as_tensor(w))
    assert got.shape == w.shape
    np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL)
    wr = torch.as_tensor(w).requires_grad_(True)
    (auto,) = torch.autograd.grad(tf(wr), wr)
    np.testing.assert_allclose(got.numpy(), auto.numpy(), atol=GRAD_TOL)


def test_parameter_shift_chunked():
    rng = np.random.default_rng(19)
    wires = 2
    w = rng.normal(size=(1, 1, wires, 3)).astype(np.float32)
    x = rng.normal(size=(2, wires)).astype(np.float32)

    def tf(w):
        return torch.sum(tsim.reupload_block(torch.as_tensor(x), w,
                                             readout="expvalz"))

    def jf(w):
        return jnp.sum(jsim.reupload_block(jnp.asarray(x), w,
                                           readout="expvalz"))

    full = parameter_shift_grad(tf, torch.as_tensor(w))
    chunked = parameter_shift_grad(tf, torch.as_tensor(w), chunk=4)
    np.testing.assert_allclose(full.numpy(), chunked.numpy(), atol=CHUNK_TOL)
    np.testing.assert_allclose(
        chunked.numpy(), np.asarray(jshift(jf, jnp.asarray(w), chunk=4)),
        atol=GRAD_TOL)


@pytest.mark.parametrize("chunk", [0, 5])
def test_the_gate_chain_runs_once_for_each_shifted_weight_set(chunk):
    """Under ``torch.func.vmap`` the operator's batching rule hands the
    gate chain one weight set at a time: 2P calls of (d, B) planes, as the
    card launches #1 2P times."""
    w, _, tf = _expvals_case()
    shapes = []

    def counting(pr, pi, g8, k, wires):
        shapes.append((tuple(pr.shape), tuple(g8.shape)))
        return gate_kernel._chain_plain(
            pr, pi, g8, gate_kernel._sign_planes_on(k, wires, pr.device), k,
            wires)

    lib = torch.library.Library("qiddm", "IMPL")
    lib.impl("gate_chain", counting, "CPU")
    try:
        got = parameter_shift_grad(tf, torch.as_tensor(w), chunk=chunk)
    finally:
        lib._destroy()
    assert len(shapes) == 2 * w.size
    assert set(shapes) == {((8, 4), (4, 3, 8))}
    assert torch.equal(got, parameter_shift_grad(tf, torch.as_tensor(w),
                                                 chunk=chunk))
