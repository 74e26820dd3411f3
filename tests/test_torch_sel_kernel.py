"""The SEL-chain entry of qiddm_tpu_torch: its plain PyTorch versions
(forward and adjoint backward) against the JAX Pallas kernels
``_sel_fwd_kernel`` and ``_sel_bwd_kernel`` (interpret mode, as
tests/test_gate_kernel.py runs them on the CPU), the ring tables and the
composed unitary against JAX's, the device dispatch and the autograd
Function, and the CUDA kernels against the plain versions on the card
(also at their launch plans' edges; two calls give the same bits, and the
planes' forward the rows kernel's bits).

Tolerances: <= 1e-5 absolute on the forward's (d, B) float32 planes —
unit-norm start states through up to 60 layers of 2x2 gates and rings,
where each layer adds a few ulp. The backward's outputs are held to
<= 1e-5 relative to max(1, max|reference|): with N(0, 1) cotangents the
cotangent planes have norm ~sqrt(d B), and dg sums products over all d rows
and the batch. The composed unitary agrees to <= 1e-6 (a few ulp of up to 7
64x64 complex products).

At 11 and 12 wires, the trajectory route's widths, the plain chain is held
to the JAX package's gate-by-gate route (``sel_apply_gates``) by the same
tolerances, forward and gradients.

The CUDA tests carry the ``cuda`` marker and skip without a card. This file
imports JAX only inside the tests that compare with it, so that on a machine
without JAX the card tests run with
``python -m pytest tests/test_torch_sel_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import gate_kernel, sel_kernel
from qiddm_tpu_torch.sim import sel as tsel
from qiddm_tpu_torch.sim.gates import rot_matrix

TOL = 1e-5
UNITARY_TOL = 1e-6
RINGS = ("cz", "cnot")

# the JAX comparison grid: w x ring x B x depth
JAX_CASES = [(w, ring, B, depth) for w in (1, 2, 3, 4) for ring in RINGS
             for B in (1, 5) for depth in (3, 7)]
# the card's grid adds the models' widths and Qdense's depth
CARD_CASES = ([(w, ring, B, 14) for w in (1, 2, 4, 6, 8, 10)
               for ring in RINGS for B in (1, 10, 16, 80)]
              + [(6, "cnot", 16, 60)])
# the trajectory route's widths, at its batch (100 trajectories x 10
# images) and depth (k = 2 a spectrum layer) and at QNN's depth
WIDE_CARD_CASES = [(w, ring, B, depth) for w in (11, 12) for ring in RINGS
                   for B in (1, 10, 1000) for depth in (2, 14)]
# the edges of the kernels' launch plans (sel_fwd_plan, sel_bwd_plan) at
# each class of the layout (a warp a sample below 5 wires and to 7, 2, 4, 8
# and 16 warps): fewer samples than a CTA's slots, a last CTA with one live
# sample, the largest batch one cluster sums in the launch and the first
# that takes a second launch, and the engine's largest batch 2^w - 1
PLAN_EDGE_CASES = [(w, ring, B, 14) for w, B in (
    (1, 1), (3, 5), (5, 32), (5, 33), (7, 127), (8, 9), (8, 16), (8, 17),
    (9, 511), (10, 17), (10, 1023), (11, 8), (11, 9), (12, 8), (12, 9))
                   for ring in RINGS]


def _inputs(w, B, depth, seed=0):
    """Numpy angles (depth, w, 3) and normalized complex start states
    (B, d)."""
    rng = np.random.default_rng(seed)
    ang = rng.normal(size=(depth, w, 3)).astype(np.float32)
    st = rng.normal(size=(B, 2**w)) + 1j * rng.normal(size=(B, 2**w))
    st /= np.linalg.norm(st, axis=1, keepdims=True)
    return ang, st.astype(np.complex64)


def _torch_args(ang, st, device="cpu"):
    """(sr, si, mats) for the port: (d, B) planes and complex rotations."""
    a = torch.as_tensor(ang, device=device)
    sr = torch.as_tensor(np.ascontiguousarray(st.real.T), device=device)
    si = torch.as_tensor(np.ascontiguousarray(st.imag.T), device=device)
    return sr, si, rot_matrix(a[..., 0], a[..., 1], a[..., 2])


def _bwd_args(w, B, depth, ring, device="cpu", seed=0):
    """Inputs of one backward call, (g8, fr, fi, gr, gi), with N(0, 1)
    cotangents; also the start planes and the numpy cotangents."""
    ang, st = _inputs(w, B, depth, seed)
    cot = np.random.default_rng(seed + 1).normal(
        size=(2, 2**w, B)).astype(np.float32)
    sr, si, mats = _torch_args(ang, st, device)
    g8 = gate_kernel._to_g8(mats)
    fr, fi = sel_kernel._sel_plain(sr, si, g8, w, ring)
    gr, gi = (torch.as_tensor(c, device=device) for c in cot)
    return (g8, fr, fi, gr, gi), (sr, si), cot


def _assert_rel(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("w,ring,B,depth", JAX_CASES)
def test_plain_matches_pallas_interpret(w, ring, B, depth):
    import jax.numpy as jnp

    from qiddm_tpu.sim.gates import rot_matrix as jrot
    from qiddm_tpu.sim.pallas_gate_kernel import sel_chain_pallas

    ang, st = _inputs(w, B, depth)
    want = np.asarray(sel_chain_pallas(
        jnp.asarray(st), jrot(ang[..., 0], ang[..., 1], ang[..., 2]), w,
        imprimitive=ring, interpret=True))
    sr, si, mats = _torch_args(ang, st)
    out_r, out_i = sel_kernel.sel_chain_planes_plain(sr, si, mats, w, ring)
    np.testing.assert_allclose(out_r.numpy().T, want.real, atol=TOL)
    np.testing.assert_allclose(out_i.numpy().T, want.imag, atol=TOL)
    got = sel_kernel.sel_chain_rows(torch.as_tensor(st), mats, w, ring)
    assert got.shape == (B, 2**w) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("w,ring,B,depth", JAX_CASES)
def test_bwd_plain_matches_pallas_vjp(w, ring, B, depth):
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    args, (sr, si), cot = _bwd_args(w, B, depth, ring)
    _, vjp = jax.vjp(
        lambda a, b, c: jpgk._sel_chain(a, b, c, w, ring == "cz", True),
        jnp.asarray(sr.numpy()), jnp.asarray(si.numpy()),
        jnp.asarray(args[0].numpy()))
    want = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    got = sel_kernel.sel_chain_bwd_plain(*args, w, ring)
    for g, w_ in zip(got, want):
        _assert_rel(g.numpy(), w_)


@pytest.mark.parametrize("w,ring", [(11, "cz"), (12, "cnot")])
def test_plain_matches_jax_gate_route_at_11_and_12_wires(w, ring):
    """The trajectory route's widths, where the JAX package runs
    ``sel_apply_gates`` off the TPU: the forward and the gradients of a
    readout with respect to the start state and the angles."""
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
    sr, si, _ = _torch_args(ang, st)
    sr.requires_grad_(True)
    si.requires_grad_(True)
    a = torch.as_tensor(ang).requires_grad_(True)
    mats = rot_matrix(a[..., 0], a[..., 1], a[..., 2])
    out_r, out_i = sel_kernel.sel_chain_planes(sr, si, mats, w, ring)
    np.testing.assert_allclose(out_r.detach().numpy().T, np.real(want),
                               atol=TOL)
    np.testing.assert_allclose(out_i.detach().numpy().T, np.imag(want),
                               atol=TOL)
    ((out_r ** 2 + out_i ** 2) * torch.as_tensor(wgt)[:, None]).sum(
    ).backward()
    for got, want_g in zip((sr.grad.T, si.grad.T, a.grad), jgrads):
        _assert_rel(got.numpy(), want_g)


@pytest.mark.parametrize("w,ring,B,depth", [(1, "cz", 3, 4), (2, "cnot", 3, 5),
                                            (4, "cz", 6, 7),
                                            (4, "cnot", 6, 7)])
def test_bwd_plain_matches_autograd_of_plain_forward(w, ring, B, depth):
    args, (sr, si), _ = _bwd_args(w, B, depth, ring)
    g8, _, _, gr, gi = args
    leaves = [t.clone().requires_grad_(True) for t in (sr, si, g8)]
    out_r, out_i = sel_kernel._sel_plain(*leaves, w, ring)
    (out_r * gr + out_i * gi).sum().backward()
    dsr, dsi, dg = sel_kernel.sel_chain_bwd_plain(*args, w, ring)
    for g, leaf in zip((dsr, dsi, dg), leaves):
        _assert_rel(g.numpy(), leaf.grad.numpy())


@pytest.mark.parametrize("ring", RINGS)
def test_function_cpu_backward_matches_autograd_of_plain(ring):
    """The autograd Function's CPU backward (the plain adjoint walk), with
    a readout that hands back a transposed cotangent for one plane and none
    for the other, against torch autograd through the plain forward."""
    ang, st = _inputs(4, 6, 7)
    grads = []
    for entry in ("function", "plain"):
        sr, si, _ = _torch_args(ang, st)
        sr.requires_grad_(True)
        si.requires_grad_(True)
        a = torch.as_tensor(ang).requires_grad_(True)
        mats = rot_matrix(a[..., 0], a[..., 1], a[..., 2])
        if entry == "function":
            out_r, _ = sel_kernel.sel_chain_planes(sr, si, mats, 4, ring)
        else:
            out_r, _ = sel_kernel.sel_chain_planes_plain(sr, si, mats, 4,
                                                         ring)
        (out_r * out_r).T.sum(dim=0).square().sum().backward()
        grads.append((sr.grad, si.grad, a.grad))
    for g, w_ in zip(*grads):
        _assert_rel(g.numpy(), w_.numpy())


@pytest.mark.parametrize("wires", [1, 2, 3, 4, 6])
def test_ring_tables_match_jax(wires):
    from qiddm_tpu.sim import pallas_gate_kernel as jpgk
    from qiddm_tpu.sim import sel as jsel

    for rng in range(wires):
        np.testing.assert_array_equal(tsel.cnot_ring_perm(wires, rng),
                                      jsel.cnot_ring_perm(wires, rng))
    np.testing.assert_array_equal(
        sel_kernel.ring_tables(wires, "cz")[:, :, None], jpgk._sel_signs(wires))
    fwd = sel_kernel.ring_tables(wires, "cnot")
    inv = sel_kernel.ring_tables(wires, "cnot", inverse=True)
    assert fwd.dtype == inv.dtype == np.int32
    for f, i in zip(fwd, inv):  # the two tables undo each other
        np.testing.assert_array_equal(f[i], np.arange(2**wires))
    if wires == 2:  # CZ(0,1) CZ(1,0) is the identity; the CNOT ring is not
        assert (sel_kernel.ring_tables(2, "cz") == 1).all()
        assert not (fwd[0] == np.arange(4)).all()


@pytest.mark.parametrize("wires,depth", [(1, 2), (2, 3), (3, 5), (6, 7)])
@pytest.mark.parametrize("ring", RINGS)
def test_sel_unitary_matches_jax(wires, depth, ring):
    import jax.numpy as jnp

    from qiddm_tpu.sim import sel as jsel

    w = (np.random.default_rng(3).normal(size=(depth, wires, 3))
         * 0.4).astype(np.float32)
    want = np.asarray(jsel.sel_unitary(jnp.asarray(w), imprimitive=ring))
    got = tsel.sel_unitary(torch.as_tensor(w), ring).numpy()
    np.testing.assert_allclose(got, want, atol=UNITARY_TOL)


def test_cpu_dispatch_runs_plain_without_launching():
    ang, st = _inputs(4, 6, 5)
    args = _torch_args(ang, st)
    before = (sel_kernel.SEL_LAUNCHES, sel_kernel.SEL_BWD_LAUNCHES)
    got = sel_kernel.sel_chain_planes(*args, 4, "cnot")
    want = sel_kernel.sel_chain_planes_plain(*args, 4, "cnot")
    assert (sel_kernel.SEL_LAUNCHES, sel_kernel.SEL_BWD_LAUNCHES) == before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_other_devices_and_wrong_shapes_raise():
    ang, st = _inputs(4, 6, 3)
    sr, si, mats = _torch_args(ang, st)
    with pytest.raises(ValueError, match="do not hold"):
        sel_kernel.sel_chain_planes(sr, si, mats, 5, "cz")
    with pytest.raises(ValueError, match="unknown imprimitive"):
        sel_kernel.sel_chain_planes(sr, si, mats, 4, "cy")
    meta = [t.to("meta") for t in (sr, si, mats)]
    with pytest.raises(ValueError, match="no SEL-chain path"):
        sel_kernel.sel_chain_planes(*meta, 4, "cz")
    g8 = gate_kernel._to_g8(mats)
    with pytest.raises(ValueError, match="CUDA device"):
        sel_kernel._sel_chain_cuda(sr, si, g8, 4, "cz")
    with pytest.raises(ValueError, match="CUDA device"):
        sel_kernel._sel_chain_bwd_cuda(g8, sr, si, sr, si, 4, "cnot")


@pytest.mark.cuda
@pytest.mark.parametrize("w,ring,B,depth",
                         CARD_CASES + WIDE_CARD_CASES + PLAN_EDGE_CASES)
def test_kernel_matches_plain_on_card(cuda, w, ring, B, depth):
    ang, st = _inputs(w, B, depth)
    args = _torch_args(ang, st, cuda)
    before = sel_kernel.SEL_LAUNCHES
    kr, ki = sel_kernel.sel_chain_planes(*args, w, ring)
    assert sel_kernel.SEL_LAUNCHES == before + 1
    qr, qi = sel_kernel.sel_chain_planes_plain(*args, w, ring)
    torch.cuda.synchronize()
    assert kr.device == cuda and kr.dtype == torch.float32
    assert (kr - qr).abs().max().item() <= TOL
    assert (ki - qi).abs().max().item() <= TOL
    # samples are independent and their rings exact: the same bits on a
    # second call, and the rows kernel #5's bits on the same states
    again = sel_kernel.sel_chain_planes(*args, w, ring)
    assert torch.equal(kr, again[0]) and torch.equal(ki, again[1])
    rows = sel_kernel.sel_chain_rows(
        torch.complex(args[0], args[1]).T.contiguous(), args[2], w, ring)
    assert torch.equal(rows.real, kr.T) and torch.equal(rows.imag, ki.T)


@pytest.mark.cuda
@pytest.mark.parametrize("w,ring,B,depth",
                         CARD_CASES + WIDE_CARD_CASES + PLAN_EDGE_CASES)
def test_bwd_kernel_matches_plain_on_card(cuda, w, ring, B, depth):
    args, _, _ = _bwd_args(w, B, depth, ring, cuda)
    before = (sel_kernel.SEL_BWD_LAUNCHES, sel_kernel.SEL_BWD_BATCH_SUMS)
    got = sel_kernel._sel_chain_bwd_cuda(*args, w, ring)
    # one launch a call; a second one for dg's batch sum only past a cluster
    second = not sel_kernel.sel_bwd_plan(w, B).in_launch
    assert (sel_kernel.SEL_BWD_LAUNCHES, sel_kernel.SEL_BWD_BATCH_SUMS) == (
        before[0] + 1, before[1] + second)
    want = sel_kernel.sel_chain_bwd_plain(*args, w, ring)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g.device == cuda and g.dtype == torch.float32
        assert ((g - w_).abs().max().item()
                <= TOL * max(1.0, w_.abs().max().item()))
    # the batch sum of dg runs in a fixed order: the same bits every time
    again = sel_kernel._sel_chain_bwd_cuda(*args, w, ring)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("ring", RINGS)
def test_backward_on_card_matches_cpu_autograd(cuda, ring):
    ang, st = _inputs(8, 10, 14)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        sr, si, _ = _torch_args(ang, st, dev)
        sr.requires_grad_(True)
        a = torch.as_tensor(ang, device=dev).requires_grad_(True)
        mats = rot_matrix(a[..., 0], a[..., 1], a[..., 2])
        before = (sel_kernel.SEL_LAUNCHES, sel_kernel.SEL_BWD_LAUNCHES)
        out_r, out_i = sel_kernel.sel_chain_planes(sr, si, mats, 8, ring)
        (out_r * out_r + out_i * out_i).T.sum(dim=0).square().sum().backward()
        launched = (sel_kernel.SEL_LAUNCHES - before[0],
                    sel_kernel.SEL_BWD_LAUNCHES - before[1])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
        grads.append((sr.grad.cpu(), a.grad.cpu()))
    for g, w_ in zip(*grads):
        torch.testing.assert_close(g, w_, rtol=0,
                                   atol=TOL * max(1.0, w_.abs().max()))


@pytest.mark.cuda
def test_card_never_falls_back_to_plain(cuda, monkeypatch):
    """A library that fails to build after a forward pass: the next
    forward and the pending ``backward()`` raise, and neither runs a plain
    version."""
    ang, st = _inputs(4, 6, 5)
    sr, si, mats = _torch_args(ang, st, cuda)
    mats.requires_grad_(True)
    out_r, out_i = sel_kernel.sel_chain_planes(sr, si, mats, 4, "cnot")

    def no_plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    for name in ("_sel_plain", "sel_chain_planes_plain",
                 "sel_chain_bwd_plain"):
        monkeypatch.setattr(sel_kernel, name, no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        sel_kernel.sel_chain_planes(sr, si, mats.detach(), 4, "cnot")
    with pytest.raises(RuntimeError, match="build failed"):
        (out_r.sum() + out_i.sum()).backward()


@pytest.mark.cuda
def test_kernel_rejects_unsupported_inputs(cuda):
    args, (sr, si), _ = _bwd_args(4, 6, 3, "cz", cuda)
    g8 = args[0]
    with pytest.raises(ValueError, match="float32"):
        sel_kernel._sel_chain_cuda(sr.double(), si, g8, 4, "cz")
    with pytest.raises(ValueError, match="float32"):
        sel_kernel._sel_chain_cuda(sr.T.contiguous().T, si, g8, 4, "cz")
    with pytest.raises(ValueError, match="same CUDA device"):
        sel_kernel._sel_chain_bwd_cuda(*args[:4], args[4].cpu(), 4, "cz")
    with pytest.raises(ValueError, match="bad shapes"):
        sel_kernel._sel_chain_bwd_cuda(*args[:3], args[3][:, :3].contiguous(),
                                       args[4][:, :3].contiguous(), 4, "cz")
    ang13, st13 = _inputs(13, 2, 1)
    with pytest.raises(ValueError, match="1..12 wires"):
        sel_kernel.sel_chain_planes(*_torch_args(ang13, st13, cuda), 13, "cz")
