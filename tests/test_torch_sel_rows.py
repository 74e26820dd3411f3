"""The SEL chain's rows entry (``sel_kernel.sel_chain_rows``), the
trajectory route's: (N, d) complex64 states in and out, kernel
``sel_rows_fwd_kernel`` on the card. Its plain version against the JAX
Pallas kernel ``sel_chain_pallas`` (interpret mode, as
tests/test_torch_sel_kernel.py runs it), against the planes' plain version
on the transposed states, and at 11 and 12 wires against the JAX package's
gate-by-gate route; the autograd Function's CPU backward; the CNOT rings'
gather maps as GF(2) columns; the trajectory route's dispatch; and the
kernel against its plain version and against the planes' kernel on the
card.

Tolerances as in tests/test_torch_sel_kernel.py: <= 1e-5 absolute on
unit-norm float32 states through up to 14 layers; gradients <= 1e-5
relative to max(1, max|reference|).

The CUDA tests carry the ``cuda`` marker and skip without a card. This file
imports JAX only inside the tests that compare with it, so that on a machine
without JAX the card tests run with
``python -m pytest tests/test_torch_sel_rows.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import gate_kernel, sel_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

TOL = 1e-5
RINGS = ("cz", "cnot")

# the JAX comparison grid: w x ring x (N, depth): the trajectory route's
# depth (k = 2 a spectrum layer) and QNN's
JAX_CASES = [(w, ring, n, depth) for w in (1, 2, 3, 4, 5, 6) for ring in RINGS
             for n, depth in ((1, 2), (7, 14))]
# the card's grid: the small widths (one thread a state at w <= 4, several
# states a block below 12) and the route's widths at its batch
CARD_CASES = ([(w, ring, n, depth) for w in (1, 2, 3, 4, 5, 6, 8, 10)
               for ring in RINGS for n, depth in ((1, 14), (10, 2), (333, 14))]
              + [(w, ring, n, depth) for w in (11, 12) for ring in RINGS
                 for n in (1, 10, 1000) for depth in (2, 14)])


def _inputs(w, n, depth, seed=0):
    """Numpy angles (depth, w, 3) and normalized complex64 states (n, d)."""
    rng = np.random.default_rng(seed)
    ang = rng.normal(size=(depth, w, 3)).astype(np.float32)
    st = rng.normal(size=(n, 2**w)) + 1j * rng.normal(size=(n, 2**w))
    st /= np.linalg.norm(st, axis=1, keepdims=True)
    return ang, st.astype(np.complex64)


def _mats(ang, device="cpu"):
    a = torch.as_tensor(ang, device=device)
    return rot_matrix(a[..., 0], a[..., 1], a[..., 2])


def _planes(st, device="cpu"):
    return (torch.as_tensor(np.ascontiguousarray(st.real.T), device=device),
            torch.as_tensor(np.ascontiguousarray(st.imag.T), device=device))


def _assert_rel(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("w,ring,n,depth", JAX_CASES)
def test_rows_plain_matches_pallas_interpret_and_planes(w, ring, n, depth):
    import jax.numpy as jnp

    from qiddm_tpu.sim.gates import rot_matrix as jrot
    from qiddm_tpu.sim.pallas_gate_kernel import sel_chain_pallas

    ang, st = _inputs(w, n, depth, seed=w)
    want = np.asarray(sel_chain_pallas(
        jnp.asarray(st), jrot(ang[..., 0], ang[..., 1], ang[..., 2]), w,
        imprimitive=ring, interpret=True))
    mats = _mats(ang)
    got = sel_kernel.sel_chain_rows_plain(torch.as_tensor(st), mats, w, ring)
    assert got.shape == (n, 2**w) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    out_r, out_i = sel_kernel.sel_chain_planes_plain(*_planes(st), mats, w,
                                                     ring)
    np.testing.assert_allclose(got.real.numpy(), out_r.numpy().T, atol=TOL)
    np.testing.assert_allclose(got.imag.numpy(), out_i.numpy().T, atol=TOL)
    entry = sel_kernel.sel_chain_rows(torch.as_tensor(st), mats, w, ring)
    assert torch.equal(entry, got)


@pytest.mark.parametrize("w,ring", [(11, "cz"), (11, "cnot"), (12, "cz"),
                                    (12, "cnot")])
def test_rows_match_jax_gate_route_at_11_and_12_wires(w, ring):
    """The trajectory route's widths, where the JAX package runs
    ``sel_apply_gates`` off the TPU: the forward, and through the rows
    Function's CPU backward the gradients of a readout with respect to the
    start states and the angles."""
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim.sel import sel_apply_gates

    ang, st = _inputs(w, 3, 2, seed=w)
    wgt = np.linspace(0, 1, 2**w).astype(np.float32)

    def jloss(re, im, a):
        out = sel_apply_gates(re + 1j * im, a, imprimitive=ring)
        return jnp.sum(jnp.abs(out) ** 2 * wgt), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(st.real), jnp.asarray(st.imag), jnp.asarray(ang))
    re = torch.as_tensor(st.real).requires_grad_(True)
    im = torch.as_tensor(st.imag).requires_grad_(True)
    a = torch.as_tensor(ang).requires_grad_(True)
    mats = rot_matrix(a[..., 0], a[..., 1], a[..., 2])
    before = (sel_kernel.SEL_ROW_LAUNCHES, sel_kernel.SEL_LAUNCHES,
              sel_kernel.SEL_BWD_LAUNCHES)
    out = sel_kernel.sel_chain_rows(torch.complex(re, im), mats, w, ring)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=TOL)
    (out.abs().square() * torch.as_tensor(wgt)).sum().backward()
    assert (sel_kernel.SEL_ROW_LAUNCHES, sel_kernel.SEL_LAUNCHES,
            sel_kernel.SEL_BWD_LAUNCHES) == before
    for got, want_g in zip((re.grad, im.grad, a.grad), jgrads):
        _assert_rel(got.numpy(), want_g)


@pytest.mark.parametrize("w,ring,n,depth", [(1, "cz", 3, 4),
                                            (3, "cnot", 5, 5),
                                            (5, "cz", 4, 7),
                                            (5, "cnot", 4, 7)])
def test_rows_function_cpu_backward_matches_autograd_of_plain(w, ring, n,
                                                              depth):
    """The Function's backward (transposes and the planes' plain adjoint
    walk) against torch autograd through the rows' plain forward, for a
    readout that weighs real and imaginary parts apart."""
    ang, st = _inputs(w, n, depth, seed=3)
    cot = torch.as_tensor(np.random.default_rng(4).normal(
        size=(n, 2**w, 2)).astype(np.float32))
    grads = []
    for entry in (sel_kernel.sel_chain_rows, sel_kernel.sel_chain_rows_plain):
        s = torch.as_tensor(st).requires_grad_(True)
        a = torch.as_tensor(ang).requires_grad_(True)
        out = entry(s, rot_matrix(a[..., 0], a[..., 1], a[..., 2]), w, ring)
        (torch.view_as_real(out) * cot).sum().backward()
        grads.append((s.grad, a.grad))
    for g, w_ in zip(*grads):
        if g.is_complex():
            g, w_ = torch.view_as_real(g), torch.view_as_real(w_)
        _assert_rel(g.numpy(), w_.numpy())


@pytest.mark.parametrize("wires", [1, 2, 3, 5, 8, 12])
def test_ring_columns_rebuild_the_gather_tables(wires):
    """Every CNOT ring's gather map is linear over GF(2): the XOR of its
    columns over the set bits of i gives ``inv[i]`` for every i, which the
    kernel computes instead of reading the (p, d) table."""
    table = sel_kernel.ring_tables(wires, "cnot")
    cols = sel_kernel.ring_columns(wires)
    assert cols.shape == (max(wires - 1, 1), wires) and cols.dtype == np.int32
    idx = np.arange(2**wires)
    for q in range(table.shape[0]):
        rebuilt = np.zeros_like(idx)
        for b in range(wires):
            rebuilt ^= np.where((idx >> b) & 1, cols[q, b], 0)
        np.testing.assert_array_equal(rebuilt, table[q])


def test_trajectory_route_runs_the_rows_entry_on_cpu(monkeypatch):
    """The trajectory block takes the rows entry, one call a spectrum
    layer, on the plain version: no launch and no planes entry."""
    from qiddm_tpu_torch.sim import engine, trajectories

    calls = []
    real = sel_kernel.sel_chain_rows

    def spy(states, *args):
        calls.append(tuple(states.shape))
        return real(states, *args)

    def no_planes(*a, **kw):
        raise AssertionError("the trajectory route ran the planes entry")

    monkeypatch.setattr(trajectories, "sel_chain_rows", spy)
    monkeypatch.setattr(sel_kernel, "sel_chain_planes", no_planes)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(3, 5)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(2, 2, 5, 3)) * 0.4,
                        dtype=torch.float32)
    noise = engine.NoiseModel("amplitude_damping", 0.2, "encode")
    before = (sel_kernel.SEL_ROW_LAUNCHES, sel_kernel.SEL_LAUNCHES)
    with torch.no_grad():
        out = trajectories.reupload_block_trajectories(
            x, w, rng=torch.Generator().manual_seed(0), n_traj=4,
            noise=noise)
    assert calls == [(12, 32), (12, 32)]
    assert (sel_kernel.SEL_ROW_LAUNCHES, sel_kernel.SEL_LAUNCHES) == before
    assert out.shape == (3, 32) and torch.isfinite(out).all()


def test_rows_entry_rejects_bad_inputs():
    ang, st = _inputs(4, 3, 2)
    s, mats = torch.as_tensor(st), _mats(ang)
    with pytest.raises(ValueError, match="do not hold"):
        sel_kernel.sel_chain_rows(s, mats, 5, "cz")
    with pytest.raises(ValueError, match="do not hold"):
        sel_kernel.sel_chain_rows(s[0], mats, 4, "cz")
    with pytest.raises(ValueError, match="unknown imprimitive"):
        sel_kernel.sel_chain_rows(s, mats, 4, "cy")
    with pytest.raises(ValueError, match="no SEL-chain path"):
        sel_kernel.sel_chain_rows(s.to("meta"), mats.to("meta"), 4, "cz")
    x = torch.view_as_real(s)
    with pytest.raises(ValueError, match="CUDA device"):
        sel_kernel._sel_rows_cuda(x, gate_kernel._to_g8(mats), 4, "cz")


@pytest.mark.cuda
@pytest.mark.parametrize("w,ring,n,depth", CARD_CASES)
def test_rows_kernel_matches_plain_and_planes_kernel_on_card(cuda, w, ring,
                                                             n, depth):
    """The rows kernel against its plain version, and bit for bit against
    the planes' kernel on the transposed states (the same 2x2 arithmetic
    per pair in the same wire order, the ring's signs exact); a second call
    gives the same bits."""
    ang, st = _inputs(w, n, depth, seed=w + n)
    s, mats = torch.as_tensor(st, device=cuda), _mats(ang, cuda)
    before = (sel_kernel.SEL_ROW_LAUNCHES, sel_kernel.SEL_LAUNCHES)
    got = sel_kernel.sel_chain_rows(s, mats, w, ring)
    assert (sel_kernel.SEL_ROW_LAUNCHES, sel_kernel.SEL_LAUNCHES) == (
        before[0] + 1, before[1])
    want = sel_kernel.sel_chain_rows_plain(s, mats, w, ring)
    kr, ki = sel_kernel.sel_chain_planes(*_planes(st, cuda), mats, w, ring)
    torch.cuda.synchronize()
    assert got.device == cuda and got.dtype == torch.complex64
    assert (got - want).abs().max().item() <= TOL
    assert torch.equal(got.real, kr.T) and torch.equal(got.imag, ki.T)
    assert torch.equal(sel_kernel.sel_chain_rows(s, mats, w, ring), got)


@pytest.mark.cuda
@pytest.mark.parametrize("ring", RINGS)
def test_rows_backward_on_card_matches_cpu(cuda, ring):
    ang, st = _inputs(12, 10, 2, seed=9)
    wgt = np.linspace(0, 1, 2**12).astype(np.float32)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        s = torch.as_tensor(st, device=dev).requires_grad_(True)
        a = torch.as_tensor(ang, device=dev).requires_grad_(True)
        before = (sel_kernel.SEL_ROW_LAUNCHES, sel_kernel.SEL_BWD_LAUNCHES)
        out = sel_kernel.sel_chain_rows(
            s, rot_matrix(a[..., 0], a[..., 1], a[..., 2]), 12, ring)
        (out.abs().square() * torch.as_tensor(wgt, device=dev)).sum(
        ).backward()
        launched = (sel_kernel.SEL_ROW_LAUNCHES - before[0],
                    sel_kernel.SEL_BWD_LAUNCHES - before[1])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
        grads.append((torch.view_as_real(s.grad).cpu(), a.grad.cpu()))
    for g, w_ in zip(*grads):
        _assert_rel(g.numpy(), w_.numpy())


@pytest.mark.cuda
def test_rows_card_never_falls_back_to_plain(cuda, monkeypatch):
    ang, st = _inputs(6, 5, 2)
    s, mats = torch.as_tensor(st, device=cuda), _mats(ang, cuda)

    def no_plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    monkeypatch.setattr(sel_kernel, "_sel_rows_plain", no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        sel_kernel.sel_chain_rows(s, mats, 6, "cz")


@pytest.mark.cuda
def test_rows_kernel_rejects_unsupported_inputs(cuda):
    ang, st = _inputs(4, 6, 3)
    s, mats = torch.as_tensor(st, device=cuda), _mats(ang, cuda)
    x = torch.view_as_real(s)
    g8 = gate_kernel._to_g8(mats)
    with pytest.raises(ValueError, match="float32"):
        sel_kernel._sel_rows_cuda(x.double(), g8, 4, "cz")
    with pytest.raises(ValueError, match="float32"):
        sel_kernel._sel_rows_cuda(x.transpose(0, 1), g8, 4, "cz")
    with pytest.raises(ValueError, match="same CUDA device"):
        sel_kernel._sel_rows_cuda(x, g8.cpu(), 4, "cz")
    with pytest.raises(ValueError, match="bad shapes"):
        sel_kernel._sel_rows_cuda(x[:, :8].contiguous(), g8, 4, "cz")
    ang13, st13 = _inputs(13, 2, 1)
    with pytest.raises(ValueError, match="1..12 wires"):
        sel_kernel.sel_chain_rows(torch.as_tensor(st13, device=cuda),
                                  _mats(ang13, cuda), 13, "cz")
