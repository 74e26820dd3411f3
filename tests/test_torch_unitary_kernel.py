"""The unitary-streaming chain of qiddm_tpu_torch (kernels #13/#14) and the
per-layer-unitary route of ``reupload_block`` that runs it: the plain
PyTorch versions against the JAX Pallas kernels ``_fwd_kernel`` and
``_bwd_kernel`` of ``qiddm_tpu/sim/pallas_kernels.py`` (interpret mode, as
tests/test_pallas.py runs them on the CPU) and against torch autograd, the
per-layer unitaries against JAX's ``sel_layer_unitaries``, the engine's
CNOT-ring and complex128 blocks against ``qiddm_tpu.sim.reupload_block``
(values and gradients), the routing with the card faked, the wrappers'
guards, #13's launch plan at every shape the card runs, #14's
(``unitary_bwd_plan``) at 1-8 wires and its refusals, and on the card the
kernels against their plain versions, #14 also at its plan's edges.

Tolerances: the forward's (d, B) float32 planes within 1e-5 absolute (the
JAX test's bound: unit-norm states through up to 28 dense layers); the
backward within 3e-5 absolute of JAX's VJP (dU sums d B products over the
batch, in another order), and within 1e-5 of max(1, max|reference|)
against autograd and, on the card, against plain (the rule of
``chip_smoke.py`` phase 4); the engine's values within 1e-5 and its
gradients within 3e-5; complex128 within 1e-10.

The CUDA tests carry the ``cuda`` marker and skip without a card. This
file imports JAX only inside the tests that compare with it, so on a
machine without JAX the card tests run with
``python -m pytest tests/test_torch_unitary_kernel.py -m cuda
--noconftest``.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch import config as tconfig
from qiddm_tpu_torch.sim import engine as tengine
from qiddm_tpu_torch.sim import gate_kernel, unitary_kernel
from qiddm_tpu_torch.sim import sel as tsel
from qiddm_tpu_torch.sim.statevector import rz_phase_planes

TOL = 1e-5
BWD_TOL = 3e-5
X64_TOL = 1e-10
RINGS = ("cz", "cnot")

# (w, L, k, B): tests/test_pallas.py's shapes
JAX_CASES = [(3, 2, 2, 8), (4, 5, 2, 16), (5, 3, 3, 8), (3, 4, 1, 4)]
# chip_smoke.py phase 26: (w, L, k, B) at L*k = 28, k = 2, the route's
# largest batch at 8 wires, and k = 3 and k = 1
CARD_CASES = ([(w, 14, 2, b) for w in (1, 3, 6, 8) for b in (1, 16, 80)]
              + [(8, 14, 2, 255), (6, 14, 3, 16), (3, 4, 1, 4)])
# #13's plan boundaries: one sample, a tile's edge at 80 (10 tiles of 8
# or 5 of 16), and the route's largest batch at 8 wires
BOUNDARY_BATCHES = (1, 79, 80, 81, 255)
COUNTERS = ("UNITARY_LAUNCHES", "UNITARY_BWD_LAUNCHES")


def _counts():
    return tuple(getattr(unitary_kernel, c) for c in COUNTERS)


def _numpy_inputs(w, L, k, B, seed=0):
    """Block weights (L, k, w, 3) and encoding angles (B, w)."""
    rng = np.random.default_rng(seed)
    weights = (rng.normal(size=(L, k, w, 3)) * 0.4).astype(np.float32)
    x = rng.normal(size=(B, w)).astype(np.float32)
    return weights, x


def _planes(w, L, k, B, ring, device="cpu", seed=0):
    """(pr, pi, ur, ui) of one chain call: RZ phase planes and the flat
    per-layer unitary planes."""
    weights, x = _numpy_inputs(w, L, k, B, seed)
    pr, pi = rz_phase_planes(torch.as_tensor(x, device=device), w)
    lus = tsel.sel_layer_unitaries(torch.as_tensor(weights, device=device),
                                   ring).reshape(L * k, 2**w, 2**w)
    return pr, pi, lus.real.contiguous(), lus.imag.contiguous()


def _bwd_args(w, L, k, B, ring, device="cpu", seed=0):
    """(pr, pi, ur, ui, fr, fi, gr, gi) with N(0, 1) cotangents."""
    pr, pi, ur, ui = _planes(w, L, k, B, ring, device, seed)
    fr, fi = unitary_kernel.unitary_chain_planes_plain(pr, pi, ur, ui, k)
    cot = np.random.default_rng(seed + 1).normal(size=(2, 2**w, B))
    gr, gi = (torch.as_tensor(c, dtype=torch.float32, device=device)
              for c in cot)
    return pr, pi, ur, ui, fr, fi, gr, gi


def _assert_rel(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


# --- the plain versions against JAX ------------------------------------------

@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("w,L,k", [(1, 2, 2), (3, 2, 3), (6, 2, 2)])
def test_sel_layer_unitaries_match_jax(w, L, k, ring):
    import jax.numpy as jnp

    from qiddm_tpu.sim.sel import sel_layer_unitaries as jslu

    weights, _ = _numpy_inputs(w, L, k, 1)
    want = np.asarray(jslu(jnp.asarray(weights), ring))
    got = tsel.sel_layer_unitaries(torch.as_tensor(weights), ring)
    assert got.shape == (L, k, 2**w, 2**w) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _jax_planes(w, L, k, B, ring):
    """The JAX package's phases and layer unitaries of the same inputs, as
    numpy planes in its (B, d) and (L*k, d, d) layouts."""
    import jax.numpy as jnp

    from qiddm_tpu.sim.sel import sel_layer_unitaries as jslu
    from qiddm_tpu.sim.statevector import rz_phases as jrz

    weights, x = _numpy_inputs(w, L, k, B)
    phases = np.asarray(jrz(jnp.asarray(x), w))
    lus = np.asarray(jslu(jnp.asarray(weights), ring))
    return phases, lus


def _torch_planes(phases, lus):
    flat = lus.reshape(-1, *lus.shape[2:])
    return tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in (
        phases.real.T, phases.imag.T, flat.real, flat.imag))


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("w,L,k,B", JAX_CASES)
def test_plain_matches_pallas_interpret(w, L, k, B, ring):
    import jax.numpy as jnp

    from qiddm_tpu.sim.pallas_kernels import reupload_chain_pallas

    phases, lus = _jax_planes(w, L, k, B, ring)
    want = np.asarray(reupload_chain_pallas(jnp.asarray(phases),
                                            jnp.asarray(lus), k,
                                            interpret=True))
    sr, si = unitary_kernel.unitary_chain_planes_plain(
        *_torch_planes(phases, lus), k)
    np.testing.assert_allclose(sr.numpy().T, want.real, atol=TOL)
    np.testing.assert_allclose(si.numpy().T, want.imag, atol=TOL)


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("w,L,k,B", JAX_CASES)
def test_bwd_plain_matches_pallas_vjp(w, L, k, B, ring):
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim.pallas_kernels import fused_reupload_chain

    phases, lus = _jax_planes(w, L, k, B, ring)
    pr, pi, ur, ui = _torch_planes(phases, lus)
    cot = np.random.default_rng(7).normal(size=(2, B, 2**w)).astype(
        np.float32)
    _, vjp = jax.vjp(
        lambda a, b, c, d: fused_reupload_chain(a, b, c, d, k, True),
        jnp.asarray(pr.numpy().T), jnp.asarray(pi.numpy().T),
        jnp.asarray(ur.numpy()), jnp.asarray(ui.numpy()))
    jdpr, jdpi, jdur, jdui = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    fr, fi = unitary_kernel.unitary_chain_planes_plain(pr, pi, ur, ui, k)
    gr, gi = (torch.as_tensor(np.ascontiguousarray(c.T)) for c in cot)
    dpr, dpi, dur, dui = unitary_kernel.unitary_chain_bwd_plain(
        pr, pi, ur, ui, fr, fi, gr, gi, k)
    for got, want in ((dpr.numpy().T, jdpr), (dpi.numpy().T, jdpi),
                      (dur.numpy(), jdur), (dui.numpy(), jdui)):
        np.testing.assert_allclose(got, np.asarray(want), atol=BWD_TOL)


@pytest.mark.parametrize("w,L,k,B,ring", [(1, 2, 2, 3, "cnot"),
                                          (4, 3, 2, 5, "cnot"),
                                          (5, 2, 3, 7, "cz")])
def test_bwd_plain_matches_autograd_of_plain_forward(w, L, k, B, ring):
    args = _bwd_args(w, L, k, B, ring, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in args[:4]]
    sr, si = unitary_kernel.unitary_chain_planes_plain(*leaves, k)
    (sr * args[6] + si * args[7]).sum().backward()
    got = unitary_kernel.unitary_chain_bwd_plain(*args, k)
    for g, leaf in zip(got, leaves):
        _assert_rel(g.numpy(), leaf.grad.numpy())


@pytest.mark.parametrize("ring", RINGS)
def test_function_cpu_backward_matches_autograd_of_plain(ring):
    """On CPU tensors the Function runs the plain versions and launches
    nothing; its gradients (the adjoint walk, states rebuilt through U^H)
    match autograd through the plain forward."""
    args = _planes(4, 3, 2, 6, ring, seed=4)
    grads = []
    before = _counts()
    for fn in (unitary_kernel.unitary_chain_planes,
               unitary_kernel.unitary_chain_planes_plain):
        leaves = [t.clone().requires_grad_(True) for t in args]
        sr, si = fn(*leaves, 2)
        ((sr * sr + si * si).T[:, :10].square()).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    assert _counts() == before
    for g, q in zip(*grads):
        _assert_rel(g.numpy(), q.numpy())


# --- the engine's per-layer-unitary route against JAX ------------------------

def _engine_pair(w, L, k, B, encode, readout, ring, dtype=np.float32,
                 noise=None):
    """Values and gradients (in the angles and the block weights) of
    ``sum(coeff * reupload_block(...))`` through both packages."""
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim import engine as jengine

    weights, x = _numpy_inputs(w, L, k, B, seed=w + B)
    weights, x = weights.astype(dtype), x.astype(dtype)
    width = 2**w if readout == "probs" else w
    coeff = np.random.default_rng(9).normal(size=(B, width)).astype(dtype)
    kw = dict(encode=encode, imprimitive=ring, readout=readout)
    jnoise = None if noise is None else jengine.NoiseModel(*noise)
    tnoise = None if noise is None else tengine.NoiseModel(*noise)

    def jloss(xx, ww):
        out = jengine.reupload_block(xx, ww, noise=jnoise, **kw)
        return jnp.sum(jnp.asarray(coeff) * out), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(x), jnp.asarray(weights))
    tx = torch.as_tensor(x).requires_grad_(True)
    tw = torch.as_tensor(weights).requires_grad_(True)
    tout = tengine.reupload_block(tx, tw, noise=tnoise, **kw)
    (torch.as_tensor(coeff) * tout).sum().backward()
    return ((tout.detach().numpy(), tx.grad.numpy(), tw.grad.numpy()),
            tuple(np.asarray(a) for a in (jout, *jgrads)))


@pytest.mark.parametrize("w,B", [(3, 5), (6, 16), (4, 20)],
                         ids=["w3-chain", "w6-chain", "w4-composed"])
@pytest.mark.parametrize("readout", ["probs", "expvalz"])
@pytest.mark.parametrize("encode", ["rz", "rz_halfpi", "ry"])
def test_engine_cnot_block_matches_jax(encode, readout, w, B):
    """A CNOT-ring block below 2^w (the per-layer route: #13/#14's plain
    versions for RZ, complex matmuls for RY) and above it (composed), in
    values and in the gradients of the angles and the block weights."""
    got, want = _engine_pair(w, 3, 2, B, encode, readout, "cnot")
    np.testing.assert_allclose(got[0], want[0], atol=TOL)
    for g, q in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, q, atol=BWD_TOL)


@pytest.mark.parametrize("encode", ["rz", "ry"])
@pytest.mark.parametrize("ring", RINGS)
def test_engine_complex128_matches_jax(ring, encode):
    """complex128 below 2^w runs the per-layer route in both packages."""
    from qiddm_tpu import config as jconfig

    jconfig.enable_x64(True)
    tconfig.enable_x64(True)
    try:
        got, want = _engine_pair(5, 3, 2, 8, encode, "probs", ring,
                                 dtype=np.float64)
    finally:
        jconfig.enable_x64(False)
        tconfig.enable_x64(False)
    assert got[0].dtype == np.float64
    for g, q in zip(got, want):
        np.testing.assert_allclose(g, q, atol=X64_TOL)


@pytest.mark.parametrize("encode", ["rz", "ry"])
def test_noisy_cnot_block_runs_the_sel_chain_not_the_dm_kernel(monkeypatch,
                                                              encode):
    """Amplitude damping after each encode on the density-matrix route: a
    CNOT block runs the SEL chain's CNOT branch on both sides of rho and
    never the dm kernel #8, which is CZ-only, even where autograd does not
    record; values match the JAX package's (and gradients, recorded)."""
    rings = []
    real_sel = tengine.sel_chain_planes

    def sel_spy(sr, si, mats, wires, imprimitive):
        rings.append(imprimitive)
        return real_sel(sr, si, mats, wires, imprimitive)

    def no_dm(*args, **kwargs):
        raise AssertionError("the dm kernel ran on a CNOT block")

    monkeypatch.setattr(tengine, "sel_chain_planes", sel_spy)
    monkeypatch.setattr(tengine, "dm_chain", no_dm)
    noise = ("amplitude_damping", 0.1, "encode")
    got, want = _engine_pair(3, 2, 2, 4, encode, "probs", "cnot",
                             noise=noise)
    np.testing.assert_allclose(got[0], want[0], atol=TOL)
    for g, q in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, q, atol=BWD_TOL)
    with torch.no_grad():
        out = tengine.reupload_block(
            torch.as_tensor(_numpy_inputs(3, 2, 2, 4)[1]),
            torch.as_tensor(_numpy_inputs(3, 2, 2, 4)[0]), encode=encode,
            imprimitive="cnot", noise=tengine.NoiseModel(*noise))
    assert torch.isfinite(out).all()
    assert rings and set(rings) == {"cnot"}


# --- routing and guards ------------------------------------------------------

def test_engine_routes_cnot_rz_blocks_to_the_unitary_chain(monkeypatch):
    """Below 2^w, a complex64 CNOT block with an RZ encode runs
    ``unitary_chain_planes`` once a call; RY, complex128, a CZ ring and a
    batch of at least 2^w do not; a CZ ring keeps the gate chain."""
    calls = []
    real = tengine.unitary_chain_planes
    real_gate = tengine.gate_chain_planes

    def spy(pr, pi, ur, ui, k):
        calls.append(("unitary", pr.shape[0], ur.shape[0], k))
        return real(pr, pi, ur, ui, k)

    def gate_spy(pr, pi, mats, k, wires):
        calls.append(("gate", wires))
        return real_gate(pr, pi, mats, k, wires)

    monkeypatch.setattr(tengine, "unitary_chain_planes", spy)
    monkeypatch.setattr(tengine, "gate_chain_planes", gate_spy)
    w = torch.rand(3, 2, 8, 3)
    for encode in ("rz", "rz_halfpi"):
        tengine.reupload_block(torch.rand(5, 8), w, encode=encode,
                               imprimitive="cnot")
    tengine.reupload_block(torch.rand(5, 8), w, encode="ry",
                           imprimitive="cnot")
    tengine.reupload_block(torch.rand(5, 8), w, imprimitive="cnot",
                           cdtype=torch.complex128)
    tengine.reupload_block(torch.rand(256, 8), w, imprimitive="cnot")
    tengine.reupload_block(torch.rand(5, 8), w, imprimitive="cz")
    assert calls == [("unitary", 256, 6, 2)] * 2 + [("gate", 8)]


@pytest.mark.parametrize("kwargs", [{"imprimitive": "cnot"},
                                    {"cdtype": torch.complex128},
                                    {"imprimitive": "cnot", "encode": "ry",
                                     "cdtype": torch.complex128}])
def test_engine_route_limits_raise_naming_item_5(kwargs):
    """The per-layer route stops at 8 wires (the kernels' 256 amplitudes):
    a CNOT ring or complex128 at 9 wires and a batch below 2^9 takes the
    grouped chain instead (ROADMAP item 5), and agrees with the per-gate
    adjoint chain (``adjoint_mode("on")``; "auto" takes it only past 10
    wires) and with ``sel_apply_gates`` under autograd (``wide_mode("off")``
    or ``adjoint_mode("off")`` at 9 wires)."""
    out = tengine.reupload_block(torch.zeros(3, 8), torch.zeros(1, 2, 8, 3),
                                 **kwargs)
    assert out.shape == (3, 256) and torch.isfinite(out).all()
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(3, 9)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(2, 2, 9, 3)) * 0.5,
                        dtype=torch.float32)
    runs = {}
    for wide, adjoint, route in (("auto", "auto", "wide"),
                                 ("off", "auto", "gates"),
                                 ("off", "on", "adjoint"),
                                 ("auto", "off", "gates")):
        tconfig.set_wide_mode(wide)
        tconfig.set_adjoint_mode(adjoint)
        tengine.reset_route_calls()
        try:
            runs[wide, adjoint] = tengine.reupload_block(x, w, **kwargs)
        finally:
            tconfig.set_wide_mode("auto")
            tconfig.set_adjoint_mode("auto")
        assert tengine.ROUTE_CALLS[route] >= 1
    for got in runs.values():
        _assert_rel(got.numpy(), runs["auto", "auto"].numpy(), X64_TOL
                    if "cdtype" in kwargs else TOL)
    with pytest.raises(ValueError, match="unknown imprimitive"):
        tengine.reupload_block(torch.zeros(3, 4), torch.zeros(1, 2, 4, 3),
                               imprimitive="cy")


def test_card_route_calls_only_the_kernel_launchers(monkeypatch):
    """With every tensor taken for a card tensor (the route patched, and
    the forward operator ``qiddm::unitary_chain`` handing CPU tensors to
    the #13 launcher), the Function calls the #13 and #14 launchers once
    each, and never the plain versions; the results are the plain ones."""
    args = _planes(4, 3, 2, 6, "cnot", seed=2)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in args]
        sr, si = unitary_kernel.unitary_chain_planes(*leaves, 2)
        ((sr * sr + si * si).T[:, :10].square()).sum().backward()
        return sr.detach(), [leaf.grad for leaf in leaves]

    want = run()
    real_fwd = unitary_kernel.unitary_chain_planes_plain
    real_bwd = unitary_kernel.unitary_chain_bwd_plain
    calls = []

    def fwd(pr, pi, ur, ui, k):
        calls.append("fwd")
        return real_fwd(pr, pi, ur, ui, k)

    def bwd(*a):
        calls.append("bwd")
        return real_bwd(*a)

    def never(*a, **kw):
        raise AssertionError("a plain version ran on a card tensor")

    monkeypatch.setattr(unitary_kernel, "_on_card", lambda device: True)
    monkeypatch.setattr(unitary_kernel, "_unitary_chain_cuda", fwd)
    monkeypatch.setattr(unitary_kernel, "_unitary_chain_bwd_cuda", bwd)
    monkeypatch.setattr(unitary_kernel, "unitary_chain_planes_plain", never)
    monkeypatch.setattr(unitary_kernel, "unitary_chain_bwd_plain", never)
    lib = torch.library.Library("qiddm", "IMPL")
    lib.impl("unitary_chain",
             lambda *a: unitary_kernel._unitary_chain_cuda(*a), "CPU")
    try:
        got = run()
    finally:
        lib._destroy()
    assert calls == ["fwd", "bwd"]
    assert torch.equal(got[0], want[0])
    for g, q in zip(got[1], want[1]):
        assert torch.equal(g, q)


def test_entry_guards_raise():
    pr, pi, ur, ui = _planes(3, 2, 2, 4, "cnot")
    chain = unitary_kernel.unitary_chain_planes
    with pytest.raises(ValueError, match="float32"):
        chain(pr.double(), pi, ur, ui, 2)
    with pytest.raises(ValueError, match="bad shapes"):
        chain(pr[:, :3], pi, ur, ui, 2)
    with pytest.raises(ValueError, match="bad shapes"):
        chain(pr, pi, ur[:, :4], ui, 2)
    with pytest.raises(ValueError, match="bad shapes"):
        chain(pr, pi, ur, ui, 0)
    big = torch.zeros(512, 2)
    with pytest.raises(ValueError, match="at most 256 amplitudes"):
        chain(big, big, torch.zeros(1, 512, 512), torch.zeros(1, 512, 512), 1)
    meta = [t.to("meta") for t in (pr, pi, ur, ui)]
    with pytest.raises(ValueError, match="no unitary-chain path"):
        chain(*meta, 2)


def test_launchers_take_only_card_tensors():
    args = _bwd_args(3, 2, 2, 4, "cnot")
    with pytest.raises(ValueError, match="CUDA device"):
        unitary_kernel._unitary_chain_cuda(*args[:4], 2)
    with pytest.raises(ValueError, match="CUDA device"):
        unitary_kernel._unitary_chain_bwd_cuda(*args, 2)


def _tiles_cover(plan, w, B):
    d = 2**w
    assert plan.cluster * unitary_kernel.FWD_ROWS >= d
    assert plan.cluster == max(1, d // 16) and plan.cluster <= 16
    assert plan.cols in (8, 16) and plan.tiles == -(-B // plan.cols)
    assert (plan.tiles - 1) * plan.cols < B <= plan.tiles * plan.cols
    assert plan.threads == 256
    # the warps cover the product's 8-deep steps, each once
    assert plan.warps * plan.steps_per_warp == max(8, d) // 8
    assert 1 <= plan.warps <= 8


@pytest.mark.parametrize("w,L,k,B", CARD_CASES + [
    (w, 14, 2, b) for w in range(1, 9) for b in BOUNDARY_BATCHES])
def test_fwd_plan_at_every_card_shape(w, L, k, B):
    """#13's plan (pure Python) at every shape the card tests and phase 26
    run: a cluster of max(1, d / 16) CTAs a tile of 8 or 16 samples, the
    tiles covering the batch once, the warps the product's depth once, and
    the shared memory the kernel's formula and within the card's 227 KB."""
    plan = unitary_kernel.unitary_plan(w, B)
    _tiles_cover(plan, w, B)
    # the smaller tile whenever every CTA finds one of the 132 SMs
    small = -(-B // 8) * plan.cluster <= 132
    assert plan.cols == (8 if small else 16)
    depth = max(8, 2**w)
    assert plan.smem_bytes == 4 * (4 * depth * (plan.cols | 8)
                                   + 64 * (depth + 4) + 256 * plan.cols)
    assert plan.smem_bytes <= gate_kernel._MAX_SMEM_BYTES
    for cols in (8, 16):
        forced = unitary_kernel.unitary_plan(w, B, cols)
        _tiles_cover(forced, w, B)
        assert forced.cols == cols
        assert forced.smem_bytes <= gate_kernel._MAX_SMEM_BYTES


def test_fwd_plan_at_the_timed_shapes():
    """(8, 80): 5 clusters of 16 CTAs (80 SMs), 16 samples a tile, 4 steps
    for each of 8 warps; (6, 16): 2 clusters of 4, 8 samples a tile."""
    assert unitary_kernel.unitary_plan(8, 80) == unitary_kernel.UnitaryPlan(
        16, 16, 5, 256, 181248, 8, 4)
    assert unitary_kernel.unitary_plan(6, 16) == unitary_kernel.UnitaryPlan(
        4, 8, 2, 256, 33792, 8, 1)
    assert unitary_kernel.unitary_plan(8, 255).tiles == 16
    with pytest.raises(ValueError, match="cols must be"):
        unitary_kernel.unitary_plan(8, 80, 32)


# #14's plan: every width at one sample, the sampling batch, the route's
# widest batch, the card's SM count and the largest batch at 8 wires
BWD_PLAN_BATCHES = (1, 16, 80, 132, 255)


@pytest.mark.parametrize("B", BWD_PLAN_BATCHES)
@pytest.mark.parametrize("w", range(1, 9))
def test_bwd_plan_at_every_width(w, B):
    """#14's plan (pure Python): #13's clusters and tiles covering the batch
    once, the warps the product's depth once, the shared memory the
    kernel's formula and within the card's 227 KB, the clusters resident
    and the waves they make, the workspace's samples and the dU blocks."""
    plan = unitary_kernel.unitary_bwd_plan(w, B)
    _tiles_cover(plan, w, B)
    depth, d = max(8, 2**w), 2**w
    for cols in (8, 16):
        forced = unitary_kernel.unitary_bwd_plan(w, B, cols)
        _tiles_cover(forced, w, B)
        red = 16 * 2 * cols + (8 if cols == 16 else 16)
        assert forced.smem_bytes == 4 * (8 * depth * cols + 64 * depth
                                         + 16 * red)
        assert forced.smem_bytes <= gate_kernel._MAX_SMEM_BYTES
        # one CTA an SM from 16 samples at 8 wires: 132 SMs / 16 CTAs
        per_sm = min(8, 233472 // (forced.smem_bytes + 1024))
        assert forced.resident == 132 * per_sm // forced.cluster >= 1
        assert forced.waves == -(-forced.tiles // forced.resident)
        assert forced.ws_samples == forced.tiles * cols
        assert forced.ws_samples % 8 == 0 and forced.ws_samples >= B
        assert forced.du_blocks == (-(-d // 64))**2
    # 8 samples a tile when its clusters all fit at once, else 16
    eight = unitary_kernel.unitary_bwd_plan(w, B, 8)
    assert plan.cols == (8 if eight.tiles <= eight.resident else 16)


def test_bwd_plan_at_the_timed_shapes():
    """(8, 80): 5 clusters of 16 CTAs in one wave at 16 samples a tile
    (at 8, 10 clusters and 8 resident: two waves); (6, 16): 2 clusters of
    4 CTAs, 8 samples a tile; (8, 255): 16 clusters in two waves."""
    plan = unitary_kernel.unitary_bwd_plan
    assert plan(8, 80) == unitary_kernel.UnitaryBwdPlan(
        16, 16, 5, 256, 229888, 8, 4, 8, 1, 80, 16)
    assert plan(8, 80, 8) == unitary_kernel.UnitaryBwdPlan(
        16, 8, 10, 256, 148480, 8, 4, 8, 2, 80, 16)
    assert plan(6, 16) == unitary_kernel.UnitaryBwdPlan(
        4, 8, 2, 256, 50176, 8, 1, 132, 1, 16, 1)
    assert plan(8, 255)[:3] == (16, 16, 16) and plan(8, 255).waves == 2


@pytest.mark.parametrize("args,match", [
    ((0, 4), "no backward plan"), ((9, 4), "no backward plan"),
    ((4, 0), "no backward plan"), ((8, 80, 32), "cols must be"),
    ((3, 5, 4), "cols must be")])
def test_bwd_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        unitary_kernel.unitary_bwd_plan(*args)


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("w,L,k,B", CARD_CASES)
def test_kernels_match_plain_on_card(cuda, w, L, k, B, ring):
    args = _bwd_args(w, L, k, B, ring, cuda)
    pr, pi, ur, ui, fr, fi = args[:6]
    before = _counts()
    kr, ki = unitary_kernel._unitary_chain_cuda(pr, pi, ur, ui, k)
    got = unitary_kernel._unitary_chain_bwd_cuda(*args, k)
    assert _counts() == (before[0] + 1, before[1] + 1)
    want = unitary_kernel.unitary_chain_bwd_plain(*args, k)
    torch.cuda.synchronize()
    assert kr.device == cuda and kr.dtype == torch.float32
    assert (kr - fr).abs().max().item() <= TOL
    assert (ki - fi).abs().max().item() <= TOL
    for g, w_ in zip(got, want):
        assert g.device == cuda and g.shape == w_.shape
        assert ((g - w_).abs().max().item()
                <= TOL * max(1.0, w_.abs().max().item()))
    # no atomics and fixed-order sums: the same bits every time
    again_f = unitary_kernel._unitary_chain_cuda(pr, pi, ur, ui, k)
    again_b = unitary_kernel._unitary_chain_bwd_cuda(*args, k)
    assert torch.equal(again_f[0], kr) and torch.equal(again_f[1], ki)
    assert all(torch.equal(a, b) for a, b in zip(got, again_b))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [8, 16])
def test_every_tile_matches_plain_on_card(cuda, cols):
    """#13 and #14 at both tiles of samples: each sample's arithmetic is
    the same in either tile, so #14 gives the same bits at both."""
    k = 2
    args = _bwd_args(8, 14, k, 80, "cnot", cuda, seed=5)
    kr, ki = unitary_kernel._unitary_chain_cuda(*args[:4], k, cols)
    got = unitary_kernel._unitary_chain_bwd_cuda(*args, k, cols)
    other = unitary_kernel._unitary_chain_bwd_cuda(*args, k, 24 - cols)
    want = unitary_kernel.unitary_chain_bwd_plain(*args, k)
    torch.cuda.synchronize()
    assert (kr - args[4]).abs().max().item() <= TOL
    assert (ki - args[5]).abs().max().item() <= TOL
    for g, w_, o in zip(got, want, other):
        assert ((g - w_).abs().max().item()
                <= TOL * max(1.0, w_.abs().max().item()))
        assert torch.equal(g, o)


@pytest.mark.cuda
@pytest.mark.parametrize("B", BOUNDARY_BATCHES)
@pytest.mark.parametrize("w", range(1, 9))
def test_bwd_kernel_at_plan_boundaries_on_card(cuda, w, B):
    """#14 against plain at its plan's edges, both rings, L*k = 28; the
    library's shared memory agrees with the plan at both tiles and the card
    holds the plan's clusters; two calls give the same bits."""
    plan = unitary_kernel.unitary_bwd_plan(w, B)
    lib = gate_kernel._library()
    for cols in (8, 16):
        assert (lib.unitary_chain_bwd_smem_bytes(w, cols)
                == unitary_kernel.unitary_bwd_plan(w, B, cols).smem_bytes)
    assert lib.unitary_chain_bwd_active_clusters(w, plan.cols, 0) >= 1
    for ring in RINGS:
        args = _bwd_args(w, 14, 2, B, ring, cuda, seed=w + B)
        got = unitary_kernel._unitary_chain_bwd_cuda(*args, 2)
        again = unitary_kernel._unitary_chain_bwd_cuda(*args, 2)
        want = unitary_kernel.unitary_chain_bwd_plain(*args, 2)
        torch.cuda.synchronize()
        for g, w_, a in zip(got, want, again):
            assert ((g - w_).abs().max().item()
                    <= TOL * max(1.0, w_.abs().max().item()))
            assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("B", BOUNDARY_BATCHES)
@pytest.mark.parametrize("w", range(1, 9))
def test_fwd_kernel_at_plan_boundaries_on_card(cuda, w, B):
    """#13 against plain at its plan's edges, both rings, L*k = 28; the
    library's shared memory and the card's clusters agree with the plan."""
    plan = unitary_kernel.unitary_plan(w, B)
    lib = gate_kernel._library()
    assert lib.unitary_chain_fwd_smem_bytes(w, plan.cols) == plan.smem_bytes
    assert lib.unitary_chain_fwd_active_clusters(w, plan.cols, 0) >= 1
    for ring in RINGS:
        pr, pi, ur, ui = _planes(w, 14, 2, B, ring, cuda, seed=w + B)
        kr, ki = unitary_kernel._unitary_chain_cuda(pr, pi, ur, ui, 2)
        qr, qi = unitary_kernel.unitary_chain_planes_plain(pr, pi, ur, ui, 2)
        torch.cuda.synchronize()
        assert (kr - qr).abs().max().item() <= TOL
        assert (ki - qi).abs().max().item() <= TOL


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """The route on the card: one #13 launch a forward, one #14 a
    backward, no gate-chain launch; values and gradients match the CPU."""
    weights, x = _numpy_inputs(6, 14, 2, 16, seed=8)
    results = []
    for dev in (cuda, torch.device("cpu")):
        tx = torch.as_tensor(x, device=dev).requires_grad_(True)
        tw = torch.as_tensor(weights, device=dev).requires_grad_(True)
        before = _counts() + (gate_kernel.LAUNCHES,)
        out = tengine.reupload_block(tx, tw, imprimitive="cnot",
                                     readout="expvalz")
        out.square().sum().backward()
        after = _counts() + (gate_kernel.LAUNCHES,)
        launched = tuple(a - b for a, b in zip(after, before))
        assert launched == ((1, 1, 0) if dev.type == "cuda" else (0, 0, 0))
        results.append([t.detach().cpu() for t in (out, tx.grad, tw.grad)])
    for g, q in zip(*results):
        torch.testing.assert_close(g, q, rtol=0,
                                   atol=TOL * max(1.0, q.abs().max()))


@pytest.mark.cuda
def test_card_never_falls_back_to_plain(cuda, monkeypatch):
    """A library that fails to build after a forward pass: the next
    forward and the pending ``backward()`` raise, and neither runs a plain
    version."""
    pr, pi, ur, ui = _planes(4, 3, 2, 6, "cnot", cuda)
    ur.requires_grad_(True)
    sr, si = unitary_kernel.unitary_chain_planes(pr, pi, ur, ui, 2)

    def no_plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    for name in ("unitary_chain_planes_plain", "unitary_chain_bwd_plain"):
        monkeypatch.setattr(unitary_kernel, name, no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        unitary_kernel.unitary_chain_planes(pr, pi, ur.detach(), ui, 2)
    with pytest.raises(RuntimeError, match="build failed"):
        (sr.sum() + si.sum()).backward()


@pytest.mark.cuda
def test_kernels_reject_unsupported_inputs(cuda):
    args = _bwd_args(4, 3, 2, 6, "cnot", cuda)
    pr, pi, ur, ui = args[:4]
    launch = unitary_kernel._unitary_chain_cuda
    with pytest.raises(ValueError, match="float32"):
        launch(pr.double(), pi, ur, ui, 2)
    with pytest.raises(ValueError, match="float32"):
        launch(pr.T.contiguous().T, pi, ur, ui, 2)
    with pytest.raises(ValueError, match="bad shapes"):
        launch(pr, pi, ur[:2].contiguous(), ui, 2)
    with pytest.raises(ValueError, match="same CUDA device"):
        launch(pr, pi, ur.cpu(), ui, 2)
    with pytest.raises(ValueError, match="cols must be"):
        launch(pr, pi, ur, ui, 2, 3)
    with pytest.raises(ValueError, match="same CUDA device"):
        unitary_kernel._unitary_chain_bwd_cuda(*args[:7], args[7].cpu(), 2)
    with pytest.raises(ValueError, match="cols must be"):
        unitary_kernel._unitary_chain_bwd_cuda(*args, 2, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        unitary_kernel._unitary_chain_bwd_cuda(
            *args[:6], args[6][:, :3].contiguous(),
            args[7][:, :3].contiguous(), 2)
    big = torch.zeros((512, 2), device=cuda)
    wide = torch.zeros((1, 512, 512), device=cuda)
    with pytest.raises(ValueError, match="at most 256 amplitudes"):
        launch(big, big, wide, wide, 1)
