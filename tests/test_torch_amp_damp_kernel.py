"""The amplitude-damping trajectory pass of qiddm_tpu_torch
(``sim/amp_damp_kernel.py``): its plain twin with and without forced branch
picks, the autograd Function on the CPU (its backward replays the twin with
the forward's picks), and the CUDA kernel against the twin on the card.
The twin's parity with the JAX twin and the Pallas kernel is held in
tests/test_torch_trajectories.py.

Tolerances: <= 1e-6 between two CPU formulations of the same float32
arithmetic; on the card <= 1e-5 (the kernel's float32 rsqrt and its own
order of operations on unit-norm states), with equal picks: both sum
P(wire = 1) in float64, so a pick could differ only at a tie within ~1e-16.

The CUDA tests carry the ``cuda`` marker and skip without a card. This file
imports no JAX, so on a machine without JAX the card tests run with
``python -m pytest tests/test_torch_amp_damp_kernel.py -m cuda
--noconftest``.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import amp_damp_kernel, gate_kernel

TOL = 1e-6
CARD_TOL = 1e-5
CARD_SHAPES = [(w, n) for w in (1, 4, 8, 12) for n in (1, 10, 1000)]
# the kernel's plan boundaries: one state, a warp's worth of states on
# either side of 32, and the route's batch of 1,000 and one past it
BOUNDARY_N = (1, 31, 32, 33, 1000, 1001)
# chip_smoke.py phase 15's shapes
SMOKE_SHAPES = [(w, n) for w in (1, 2, 4, 6, 8, 10, 12) for n in (1, 10, 1000)]


def _inputs(w, n, seed=0, device="cpu"):
    """Unit-norm complex64 states (n, 2**w) and uniforms (w, n)."""
    rng = np.random.default_rng(seed)
    st = rng.normal(size=(n, 2**w)) + 1j * rng.normal(size=(n, 2**w))
    st /= np.linalg.norm(st, axis=1, keepdims=True)
    u = rng.uniform(size=(w, n))
    return (torch.as_tensor(st, dtype=torch.complex64, device=device),
            torch.as_tensor(u, dtype=torch.float32, device=device))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _per_wire(states, u, g):
    """The same channel written out wire by wire with the Kraus gates
    K_i / sqrt(p_i), as the JAX twin writes it."""
    n, d = states.shape
    w = d.bit_length() - 1
    picks = []
    for j in range(w):
        v = states.reshape(n, 2**j, 2, d >> (j + 1))
        p1 = g * (v[:, :, 1].abs() ** 2).sum(dim=(1, 2))
        pick = u[j] < p1
        k0 = torch.tensor([[1, 0], [0, np.sqrt(1 - g)]], dtype=states.dtype)
        k1 = torch.tensor([[0, np.sqrt(g)], [0, 0]], dtype=states.dtype)
        scale = torch.where(pick, torch.rsqrt(p1), torch.rsqrt(1 - p1))
        gate = torch.where(pick[:, None, None], k1, k0) * scale[:, None, None]
        states = torch.einsum("bxy,blyr->blxr", gate, v).reshape(n, d)
        picks.append(pick)
    return states, torch.stack(picks).to(torch.uint8)


@pytest.mark.parametrize("w,n", [(1, 4), (3, 5), (6, 3)])
def test_twin_matches_the_kraus_gates(w, n):
    states, u = _inputs(w, n, seed=w)
    got, picks = amp_damp_kernel.amp_damp_plain(states, u, 0.4)
    want, want_picks = _per_wire(states, u, 0.4)
    assert torch.equal(picks, want_picks)
    assert picks.sum() > 0 and (1 - picks).sum() > 0  # both branches taken
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    norms = (got.abs() ** 2).sum(dim=1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)


def test_twin_follows_forced_picks():
    states, u = _inputs(4, 6, seed=1)
    own, picks = amp_damp_kernel.amp_damp_plain(states, u, 0.5)
    again, same = amp_damp_kernel.amp_damp_plain(states, u, 0.5, picks=picks)
    assert torch.equal(own, again) and torch.equal(picks, same)
    flipped = picks.clone()
    flipped[0] = 1 - flipped[0]
    other, taken = amp_damp_kernel.amp_damp_plain(states, u, 0.5,
                                                  picks=flipped)
    assert torch.equal(taken, flipped)
    assert (other - own).abs().max() > 1e-2
    # forced picks override the uniforms: u = 1 would never pick K1
    ones = torch.ones_like(u)
    forced, _ = amp_damp_kernel.amp_damp_plain(states, ones, 0.5,
                                               picks=picks)
    assert torch.equal(forced, own)
    none, none_picks = amp_damp_kernel.amp_damp_plain(states, ones, 0.5)
    assert none_picks.sum() == 0
    np.testing.assert_allclose((none.abs() ** 2).sum(dim=1).numpy(), 1.0,
                               atol=1e-5)


def test_tensor_strength_equals_the_float():
    states, u = _inputs(5, 4, seed=2)
    a, pa = amp_damp_kernel.amp_damp(states, u, 0.3)
    b, pb = amp_damp_kernel.amp_damp(states, u, torch.tensor(0.3))
    assert torch.equal(a, b) and torch.equal(pa, pb)
    zero, pz = amp_damp_kernel.amp_damp(states, u, 0.0)
    assert torch.equal(zero, states) and pz.sum() == 0


def test_cpu_function_runs_the_twin_and_its_backward_replays_it():
    """On the CPU the Function runs the twin without launching; its
    backward, a replay of the twin with the forward's picks, gives autograd's
    gradients through the twin itself."""
    states, u = _inputs(5, 6, seed=3)
    wgt = torch.linspace(0, 1, 32)
    grads = []
    for entry in ("function", "plain"):
        re = states.real.clone().requires_grad_(True)
        im = states.imag.clone().requires_grad_(True)
        g = torch.tensor(0.35, requires_grad=True)
        fn = (amp_damp_kernel.amp_damp if entry == "function"
              else amp_damp_kernel.amp_damp_plain)
        before = amp_damp_kernel.AMP_DAMP_LAUNCHES
        out, picks = fn(torch.complex(re, im), u, g)
        assert amp_damp_kernel.AMP_DAMP_LAUNCHES == before
        assert not picks.requires_grad
        ((out.abs() ** 2) * wgt).sum().backward()
        grads.append((re.grad, im.grad, g.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    # a float strength carries no gradient; the state's still flows
    re = states.real.clone().requires_grad_(True)
    out, _ = amp_damp_kernel.amp_damp(torch.complex(re, states.imag), u, 0.35)
    out.abs().sum().backward()
    assert re.grad is not None and torch.isfinite(re.grad).all()


def test_backward_follows_the_forward_picks():
    """The replay takes the forward's picks, not fresh ones: with forced
    picks the gradient is the forced realization's."""
    states, u = _inputs(3, 4, seed=4)
    _, picks = amp_damp_kernel.amp_damp_plain(states, u, 0.6)
    flipped = 1 - picks
    grads = []
    for fn in (amp_damp_kernel.amp_damp, amp_damp_kernel.amp_damp_plain):
        re = states.real.clone().requires_grad_(True)
        out, _ = fn(torch.complex(re, states.imag), u, 0.6, picks=flipped)
        (out.real ** 3).sum().backward()
        grads.append(re.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=TOL)


def test_other_devices_and_wrong_inputs_raise():
    states, u = _inputs(3, 2)
    with pytest.raises(ValueError, match="whole wires"):
        amp_damp_kernel.amp_damp(states[:, :6], u, 0.1)
    with pytest.raises(ValueError, match="no amplitude-damping path"):
        amp_damp_kernel.amp_damp(states.to("meta"), u.to("meta"), 0.1)
    with pytest.raises(ValueError, match="CUDA device"):
        amp_damp_kernel._amp_damp_cuda(states, u, 0.1, None)


@pytest.mark.parametrize("w,n", sorted(set(
    CARD_SHAPES + SMOKE_SHAPES
    + [(w, n) for w in range(1, 13) for n in BOUNDARY_N])))
def test_plan_at_every_card_shape(w, n):
    """The kernel's layout (pure Python) at every shape the card runs: the
    threads of a state hold its 2**w amplitudes once, a warp (or d lanes
    of one) a state up to 9 wires and a block from 10, whole warps a
    block, and the blocks cover the n states once."""
    plan = amp_damp_kernel.amp_damp_plan(w, n)
    d = 2**w
    assert plan.amps * plan.threads_per_state == d
    assert plan.amps == (1 if w < 5 else min(d // 32, 16))
    assert plan.threads == plan.per_block * plan.threads_per_state
    assert plan.threads % 32 == 0 and plan.threads <= 256
    if w <= 9:
        assert plan.threads_per_state <= 32 and plan.threads == 128
        assert plan.warps_per_state == 1
    else:
        assert plan.per_block == 1 and plan.amps == 16
        assert plan.warps_per_state == plan.threads_per_state // 32 > 1
    assert (plan.blocks - 1) * plan.per_block < n <= (plan.blocks
                                                      * plan.per_block)


def _xor_mask_pass(states, u, g: float):
    """The kernel's algorithm on the CPU: nothing moves while the wires
    run. Logical amplitude i stays at physical index i ^ F; wire j sums
    |psi|^2 over the physical indices with its bit set (in float64) and
    scales every amplitude by a factor of that bit alone (a pick zeroes
    bit 0 and renormalizes bit 1, then flips the bit in F); the store
    writes physical p to p ^ F."""
    n, d = states.shape
    w = d.bit_length() - 1
    phys = states.clone()
    flip = torch.zeros(n, dtype=torch.int64)
    idx = torch.arange(d)
    g32 = torch.tensor(g, dtype=torch.float32)
    sq1g = torch.sqrt(1.0 - g32)
    picks = []
    for j in range(w):
        one = ((idx >> (w - 1 - j)) & 1).bool()
        prob1 = (phys.real.double() ** 2 + phys.imag.double() ** 2)[
            :, one].sum(1)
        p1d = g32.double() * prob1
        pick = u[j].double() < p1d
        p1 = p1d.float()
        c1 = torch.sqrt(g32) * torch.rsqrt(p1.clamp(min=1e-30))
        c0 = torch.rsqrt((1.0 - p1).clamp(min=1e-30))
        s0 = torch.where(pick, 0.0, c0)
        s1 = torch.where(pick, c1, c0 * sq1g)
        phys = phys * torch.where(one[None, :], s1[:, None], s0[:, None])
        flip ^= pick.long() << (w - 1 - j)
        picks.append(pick)
    out = torch.empty_like(phys)
    out.scatter_(1, idx[None, :] ^ flip[:, None], phys)
    return out, torch.stack(picks).to(torch.uint8)


@pytest.mark.parametrize("w,n", [(1, 5), (3, 7), (6, 20), (9, 10),
                                 (12, 4)])
def test_xor_mask_algorithm_is_the_twin(w, n):
    """The register design's arithmetic (no amplitude moves, an xor mask
    of picked wires) gives the twin's states and picks."""
    states, u = _inputs(w, n, seed=3 * w + n)
    for g in (0.05, 0.3, 0.8):
        got, picks = _xor_mask_pass(states, u, g)
        want, want_picks = amp_damp_kernel.amp_damp_plain(states, u, g)
        assert torch.equal(picks, want_picks), g
        assert picks.any() or g == 0.05
        assert (got - want).abs().max().item() <= TOL, g


def test_library_build_covers_the_amp_damp_source():
    assert gate_kernel._CSRC / "amp_damp.cu" in gate_kernel._SOURCES
    assert (gate_kernel._CSRC / "amp_damp.cu").is_file()


@pytest.mark.cuda
@pytest.mark.parametrize("w,n", CARD_SHAPES)
def test_kernel_matches_twin_on_card(cuda, w, n):
    states, u = _inputs(w, n, seed=w + n, device=cuda)
    for g in (0.05, 0.3, 0.8):
        before = amp_damp_kernel.AMP_DAMP_LAUNCHES
        got, picks = amp_damp_kernel.amp_damp(states, u, g)
        assert amp_damp_kernel.AMP_DAMP_LAUNCHES == before + 1
        want, want_picks = amp_damp_kernel.amp_damp_plain(states, u, g)
        torch.cuda.synchronize()
        assert got.device == cuda and got.dtype == torch.complex64
        assert picks.dtype == torch.uint8 and picks.shape == (w, n)
        assert torch.equal(picks, want_picks), g
        assert (got - want).abs().max().item() <= CARD_TOL, g
        # and with the picks forced, the same states
        forced, _ = amp_damp_kernel.amp_damp(states, u, g, picks=picks)
        assert torch.equal(forced, got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", BOUNDARY_N)
@pytest.mark.parametrize("w", range(1, 13))
def test_kernel_at_plan_boundaries_on_card(cuda, w, n):
    """The kernel against the twin at the edges of its layout, the picks
    equal and, forced, the same bits."""
    states, u = _inputs(w, n, seed=7 * w + n, device=cuda)
    for g in (0.05, 0.3, 0.8):
        got, picks = amp_damp_kernel.amp_damp(states, u, g)
        want, want_picks = amp_damp_kernel.amp_damp_plain(states, u, g)
        torch.cuda.synchronize()
        assert torch.equal(picks, want_picks), g
        assert (got - want).abs().max().item() <= CARD_TOL, g
        forced, again = amp_damp_kernel.amp_damp(states, u, g, picks=picks)
        assert torch.equal(forced, got) and torch.equal(again, picks)


@pytest.mark.cuda
def test_device_strength_is_read_on_the_card(cuda):
    states, u = _inputs(6, 10, device=cuda)
    g = torch.tensor(0.3, dtype=torch.float32, device=cuda)
    a, _ = amp_damp_kernel.amp_damp(states, u, g)
    b, _ = amp_damp_kernel.amp_damp(states, u, 0.3)
    assert torch.equal(a, b)
    g.fill_(0.7)
    c, _ = amp_damp_kernel.amp_damp(states, u, g)
    d, _ = amp_damp_kernel.amp_damp(states, u, 0.7)
    assert torch.equal(c, d) and not torch.equal(a, c)


@pytest.mark.cuda
def test_gradient_on_card_matches_cpu(cuda):
    states, u = _inputs(8, 10, seed=5)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        re = states.real.to(dev).requires_grad_(True)
        g = torch.tensor(0.3, device=dev).requires_grad_(True)
        out, _ = amp_damp_kernel.amp_damp(
            torch.complex(re, states.imag.to(dev)), u.to(dev), g)
        (out.abs() ** 2 * torch.linspace(0, 1, 256, device=dev)).sum(
        ).backward()
        grads.append((re.grad.cpu(), g.grad.cpu()))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=CARD_TOL * max(1.0, want.abs().max()))


@pytest.mark.cuda
def test_card_never_falls_back_to_plain(cuda, monkeypatch):
    """A library that fails to build: the forward raises without running
    the twin, and so does a backward() through a fresh forward (the replay
    in the backward is the design, not a way around the kernel)."""
    states, u = _inputs(4, 6, device=cuda)
    re = states.real.clone().requires_grad_(True)

    def no_plain(*a, **kw):
        raise AssertionError("plain twin ran in place of the kernel")

    def broken_build():
        raise RuntimeError("build failed")

    monkeypatch.setattr(amp_damp_kernel, "amp_damp_plain", no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        amp_damp_kernel.amp_damp(states, u, 0.2)
    with pytest.raises(RuntimeError, match="build failed"):
        out, _ = amp_damp_kernel.amp_damp(torch.complex(re, states.imag), u,
                                          0.2)
        out.abs().sum().backward()
    assert re.grad is None


@pytest.mark.cuda
def test_kernel_rejects_unsupported_inputs(cuda):
    states, u = _inputs(4, 6, device=cuda)
    with pytest.raises(ValueError, match="complex64"):
        amp_damp_kernel._amp_damp_cuda(states.to(torch.complex128), u, 0.1,
                                       None)
    with pytest.raises(ValueError, match="same CUDA device"):
        amp_damp_kernel._amp_damp_cuda(states, u, torch.tensor(0.1), None)
    with pytest.raises(ValueError, match="bad shapes"):
        amp_damp_kernel._amp_damp_cuda(states, u[:, :3].contiguous(), 0.1,
                                       None)
    wide, uw = _inputs(13, 1, device=cuda)
    with pytest.raises(ValueError, match="1..12 wires"):
        amp_damp_kernel.amp_damp(wide, uw, 0.1)
