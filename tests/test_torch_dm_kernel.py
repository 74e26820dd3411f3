"""The density-matrix block of qiddm_tpu_torch (``sim/dm_kernel.py``): its
plain PyTorch version against the JAX Pallas kernel (interpret mode, as
tests/test_pallas.py runs it on the CPU), the device dispatch and the
forward-only autograd Function, and the CUDA kernel against the plain
version on the card.

Tolerances: <= 1e-5 absolute on rho — unit-trace density matrices through
up to 3 spectrum layers of a channel on every wire and 2-3 SEL layers on
both sides, each step adding a few ulp; rho Hermitian and of trace 1 within
1e-5 (every step is CPTP); and the channel must act: rho differs from the
clean block (strength 0) by more than 1e-4. On the card the kernel is held
to its plain version by the same 1e-5 at the chip_smoke.py shapes (up to 8
wires and 6 spectrum layers, and at 9 and 10 wires).

The CUDA tests carry the ``cuda`` marker and skip without a card. This file
imports JAX only inside the tests that compare with it, so that on a machine
without JAX the card tests run with
``python -m pytest tests/test_torch_dm_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import dm_kernel, gate_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix
from qiddm_tpu_torch.sim.statevector import rz_phases

TOL = 1e-5
ACTS = 1e-4
KINDS = ["amplitude_damping", "depolarizing", "phase_damping"]
# (wires, L, k, batch)
SHAPES = [(3, 2, 2, 3), (4, 3, 2, 2), (4, 2, 3, 1)]
# chip_smoke.py's shapes: (wires, batch), at (L, k) = (6, 2)
CARD_SHAPES = [(w, b) for w in (1, 2, 4, 6, 7, 8) for b in (1, 10)]
# every shape chip_smoke.py holds the kernel at: (wires, batch, L, RY)
SMOKE_SHAPES = ([(w, b, 6, ry) for w, b in CARD_SHAPES for ry in (False, True)]
                + [(6, 10, 14, False), (8, 10, 6, True)]
                + [(w, b, n, ry) for w, b, n in ((9, 2, 2), (10, 1, 1))
                   for ry in (False, True)])


def _inputs(w, L, k, B, seed=0):
    """Numpy rotation angles (L*k, w, 3) and encode angles (B, w)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(L * k, w, 3)).astype(np.float32),
            (2 * rng.normal(size=(B, w))).astype(np.float32))


def _torch_args(ang, x, ry, device="cpu"):
    """(enc, mats): the RY angles or the RZ phases, and the rotations."""
    a = torch.as_tensor(ang, device=device)
    xt = torch.as_tensor(x, device=device)
    enc = xt if ry else rz_phases(xt, x.shape[1])
    return enc, rot_matrix(a[..., 0], a[..., 1], a[..., 2])


def _check_density(rho, tol=TOL):
    rho = torch.as_tensor(rho)
    herm = (rho - rho.conj().transpose(-1, -2)).abs().max().item()
    trace = torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1)
    assert herm <= tol, herm
    assert (trace - 1).abs().max().item() <= tol, trace


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("w,L,k,B", SHAPES)
@pytest.mark.parametrize("ry", [False, True], ids=["rz", "ry"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_interpret(kind, ry, w, L, k, B):
    import jax.numpy as jnp

    from qiddm_tpu.sim.gates import rot_matrix as jrot
    from qiddm_tpu.sim.pallas_dm_kernel import dm_reupload_chain_pallas
    from qiddm_tpu.sim.statevector import rz_phases as jphases

    ang, x = _inputs(w, L, k, B)
    want = np.asarray(dm_reupload_chain_pallas(
        None if ry else jphases(jnp.asarray(x), w),
        jrot(ang[..., 0], ang[..., 1], ang[..., 2]), k, w, kind, 0.3,
        interpret=True, ry_angles=jnp.asarray(x) if ry else None))
    args = _torch_args(ang, x, ry)
    got = dm_kernel.dm_chain_plain(*args, k, w, kind, 0.3, ry=ry)
    assert got.dtype == torch.complex64 and got.shape == (B, 2**w, 2**w)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    _check_density(got)
    clean = dm_kernel.dm_chain_plain(*args, k, w, kind, 0.0, ry=ry)
    assert (got - clean).abs().max().item() > ACTS


def test_tensor_strength_equals_the_float():
    ang, x = _inputs(3, 2, 2, 2)
    args = _torch_args(ang, x, False)
    for kind in KINDS:
        a = dm_kernel.dm_chain(*args, 2, 3, kind, 0.2)
        b = dm_kernel.dm_chain(*args, 2, 3, kind,
                               torch.tensor(0.2, dtype=torch.float32))
        assert torch.equal(a, b)


def test_cpu_dispatch_runs_plain_without_launching():
    ang, x = _inputs(4, 2, 2, 3)
    args = _torch_args(ang, x, True)
    before = dm_kernel.DM_LAUNCHES
    got = dm_kernel.dm_chain(*args, 2, 4, "depolarizing", 0.1, ry=True)
    want = dm_kernel.dm_chain_plain(*args, 2, 4, "depolarizing", 0.1,
                                    ry=True)
    assert dm_kernel.DM_LAUNCHES == before
    assert torch.equal(got, want)


def test_backward_raises_instead_of_running_plain():
    """Forward only, as the JAX kernel (no VJP): a backward through the
    Function raises; the engine routes autograd elsewhere."""
    ang, x = _inputs(3, 2, 2, 2)
    enc, mats = _torch_args(ang, x, False)
    mats.requires_grad_(True)
    rho = dm_kernel.dm_chain(enc, mats, 2, 3, "amplitude_damping", 0.1)
    assert rho.requires_grad
    with pytest.raises(NotImplementedError, match="forward-only"):
        torch.diagonal(rho, dim1=-2, dim2=-1).real.sum().backward()


def test_kernel_encode_layout():
    ang, x = _inputs(3, 1, 2, 4)
    enc, _ = _torch_args(ang, x, False)
    pairs = dm_kernel._kernel_enc(enc, 3, False)
    assert pairs.shape == (4, 8, 2) and pairs.dtype == torch.float32
    assert torch.equal(pairs[..., 0], enc.real)
    cs = dm_kernel._kernel_enc(torch.as_tensor(x), 3, True)
    assert cs.shape == (4, 3, 2)
    np.testing.assert_allclose(cs[..., 0].numpy(), np.cos(x / 2), atol=1e-7)
    np.testing.assert_allclose(cs[..., 1].numpy(), np.sin(x / 2), atol=1e-7)


def test_other_devices_kinds_and_wrong_shapes_raise():
    ang, x = _inputs(3, 2, 2, 2)
    enc, mats = _torch_args(ang, x, False)
    with pytest.raises(ValueError, match="no closed-form"):
        dm_kernel.dm_chain(enc, mats, 2, 3, "phase_shift", 0.1)
    with pytest.raises(ValueError, match="do not hold"):
        dm_kernel.dm_chain(enc, mats, 2, 4, "depolarizing", 0.1)
    with pytest.raises(ValueError, match="do not fit"):
        dm_kernel.dm_chain(enc[:, :2].real, mats, 2, 3, "depolarizing", 0.1,
                           ry=True)
    with pytest.raises(ValueError, match="no dm-chain path"):
        dm_kernel.dm_chain(enc.to("meta"), mats.to("meta"), 2, 3,
                           "depolarizing", 0.1)
    with pytest.raises(ValueError, match="CUDA device"):
        dm_kernel._dm_chain_cuda(enc, gate_kernel._to_g8(mats), 0.1, 2, 3,
                                 1, False)


@pytest.mark.parametrize("w,B,L,ry", SMOKE_SHAPES)
def test_cluster_plan_fits_the_card(w, B, L, ry):
    """The plan for every shape the card runs: a power-of-two cluster of
    at most 16 CTAs whose rows tile rho, within a CTA's shared memory; rho
    in shared memory up to 9 wires, in device memory at 10."""
    plan = dm_kernel.cluster_plan(w, B, 2 * L, ry)
    c = plan.cluster
    assert 1 <= c <= dm_kernel.MAX_CLUSTER and c & (c - 1) == 0
    assert c == 1 or c <= 2**w // 2
    assert plan.rows_per_cta * c == 2**w
    assert 0 < plan.smem_bytes <= gate_kernel._MAX_SMEM_BYTES
    side = (w if ry else 2**w) * 8 + 2 * L * w * 8 * 4
    rho = 4**w * 8 // c if plan.rho_in_smem else 0
    assert plan.smem_bytes == side + rho
    assert plan.rho_in_smem == (w <= 9)
    # no more clusters than the card has SMs for, unless rho needs them
    assert B * c <= dm_kernel.SM_COUNT or (w == 9 and c == 16)


def test_cluster_plan_spreads_the_sweep_shapes():
    """The noisy sweep's two dm shapes run a cluster a sample: 80 CTAs at
    (8, 10), each with 32 rows (64 KB) of rho; 40 at (6, 10)."""
    assert dm_kernel.cluster_plan(8, 10, 12, True) == dm_kernel.DmPlan(
        8, 32, 8 * 8 + 12 * 8 * 32 + 256 * 256 * 8 // 8, True)
    assert dm_kernel.cluster_plan(6, 10, 28, False).cluster == 4
    assert dm_kernel.cluster_plan(10, 1, 2, False) == dm_kernel.DmPlan(
        16, 64, 1024 * 8 + 2 * 10 * 32, False)


def test_library_build_covers_the_dm_source():
    """The library's hash and its nvcc jobs include csrc/dm_chain.cu, so an
    edit of it rebuilds the library."""
    assert gate_kernel._CSRC / "dm_chain.cu" in gate_kernel._SOURCES
    assert (gate_kernel._CSRC / "dm_chain.cu").is_file()


@pytest.mark.cuda
@pytest.mark.parametrize("w,B", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, w, B):
    ang, x = _inputs(w, 6, 2, B, seed=w)
    for ry in (False, True):
        args = _torch_args(ang, x, ry, cuda)
        for kind in KINDS:
            for strength in (0.05, 0.8):
                before = dm_kernel.DM_LAUNCHES
                got = dm_kernel.dm_chain(*args, 2, w, kind, strength, ry=ry)
                assert dm_kernel.DM_LAUNCHES == before + 1
                want = dm_kernel.dm_chain_plain(*args, 2, w, kind, strength,
                                                ry=ry)
                torch.cuda.synchronize()
                assert got.device == cuda and got.dtype == torch.complex64
                err = (got - want).abs().max().item()
                assert err <= TOL, (ry, kind, strength, err)
                _check_density(got.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("w,B,L,ry", [(6, 10, 14, False), (8, 10, 6, True)],
                         ids=["QIDDM_LL_noise", "QIDDM_PL_noise1"])
def test_kernel_matches_plain_on_card_at_the_model_shapes(cuda, w, B, L, ry):
    ang, x = _inputs(w, L, 2, B, seed=1)
    args = _torch_args(ang, x, ry, cuda)
    for kind in KINDS:
        got = dm_kernel.dm_chain(*args, 2, w, kind, 0.3, ry=ry)
        want = dm_kernel.dm_chain_plain(*args, 2, w, kind, 0.3, ry=ry)
        assert (got - want).abs().max().item() <= TOL, kind


@pytest.mark.cuda
@pytest.mark.parametrize("w,B,L", [(9, 2, 2), (10, 1, 1)])
def test_kernel_matches_plain_on_card_at_9_and_10_wires(cuda, w, B, L):
    """The kernel's widest shapes, where rho (2 MB and 8 MB a sample) does
    not fit in shared memory and the passes go through L2 and device
    memory: every channel and both encodes against the plain version."""
    ang, x = _inputs(w, L, 2, B, seed=w)
    for ry in (False, True):
        args = _torch_args(ang, x, ry, cuda)
        for kind in KINDS:
            got = dm_kernel.dm_chain(*args, 2, w, kind, 0.3, ry=ry)
            want = dm_kernel.dm_chain_plain(*args, 2, w, kind, 0.3, ry=ry)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            assert err <= TOL, (ry, kind, err)
            _check_density(got.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("in_smem", [True, False], ids=["smem", "device"])
def test_every_cluster_and_route_matches_plain_on_card(cuda, cluster,
                                                       in_smem):
    """The kernel at plans other than the default, at w = 8: every cluster
    size with rho in shared memory (where it fits) and in device memory,
    the same rho within 1e-5 of plain, and bit for bit from call to
    call."""
    w, L, B = 8, 2, 3
    side = w * 8 + 2 * L * w * 8 * 4
    rho = 4**w * 8 // cluster
    if in_smem and side + rho > gate_kernel._MAX_SMEM_BYTES:
        pytest.skip("rho does not fit in this cluster's shared memory")
    plan = dm_kernel.DmPlan(cluster, 2**w // cluster,
                            side + (rho if in_smem else 0), in_smem)
    ang, x = _inputs(w, L, 2, B, seed=11)
    enc, mats = _torch_args(ang, x, True, cuda)
    g8 = gate_kernel._to_g8(mats)
    got = dm_kernel._dm_chain_cuda(enc, g8, 0.3, 2, w, 0, True, plan)
    want = dm_kernel.dm_chain_plain(enc, mats, 2, w, "amplitude_damping",
                                    0.3, ry=True)
    again = dm_kernel._dm_chain_cuda(enc, g8, 0.3, 2, w, 0, True, plan)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_refused_cluster_raises(cuda):
    """A plan the kernel cannot launch (a cluster of 32) raises; nothing
    falls back to another layout."""
    ang, x = _inputs(6, 2, 2, 2)
    enc, mats = _torch_args(ang, x, False, cuda)
    g8 = gate_kernel._to_g8(mats)
    side = 2**6 * 8 + 4 * 6 * 8 * 4
    plan = dm_kernel.DmPlan(32, 2, side + 4**6 * 8 // 32, True)
    with pytest.raises(RuntimeError, match="launch failed"):
        dm_kernel._dm_chain_cuda(enc, g8, 0.3, 2, 6, 1, False, plan)


@pytest.mark.cuda
def test_device_strength_is_read_on_the_card(cuda):
    """A 0-d float32 tensor strength reaches the kernel as a pointer: the
    same rho as the float, and a fill of the tensor changes the next
    call's channel."""
    ang, x = _inputs(4, 2, 2, 3)
    args = _torch_args(ang, x, False, cuda)
    g = torch.tensor(0.3, dtype=torch.float32, device=cuda)
    a = dm_kernel.dm_chain(*args, 2, 4, "amplitude_damping", g)
    b = dm_kernel.dm_chain(*args, 2, 4, "amplitude_damping", 0.3)
    assert torch.equal(a, b)
    g.fill_(0.5)
    c = dm_kernel.dm_chain(*args, 2, 4, "amplitude_damping", g)
    d = dm_kernel.dm_chain(*args, 2, 4, "amplitude_damping", 0.5)
    assert torch.equal(c, d) and not torch.equal(a, c)


@pytest.mark.cuda
def test_card_never_falls_back_to_plain(cuda, monkeypatch):
    ang, x = _inputs(4, 2, 2, 3)
    args = _torch_args(ang, x, False, cuda)

    def no_plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    monkeypatch.setattr(dm_kernel, "dm_chain_plain", no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        dm_kernel.dm_chain(*args, 2, 4, "depolarizing", 0.1)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_inputs(cuda):
    ang, x = _inputs(4, 2, 2, 3)
    enc, mats = _torch_args(ang, x, False, cuda)
    g8 = gate_kernel._to_g8(mats)
    with pytest.raises(ValueError, match="float32"):
        dm_kernel._dm_chain_cuda(enc, g8.double(), 0.1, 2, 4, 1, False)
    with pytest.raises(ValueError, match="same CUDA device"):
        dm_kernel._dm_chain_cuda(enc, g8, torch.tensor(0.1), 2, 4, 1, False)
    with pytest.raises(ValueError, match="bad shapes"):
        dm_kernel._dm_chain_cuda(enc, g8, 0.1, 3, 4, 1, False)
    with pytest.raises(ValueError, match="unknown channel"):
        dm_kernel._dm_chain_cuda(enc, g8, 0.1, 2, 4, 5, False)
    ang11, x11 = _inputs(11, 1, 2, 1)
    enc11, mats11 = _torch_args(ang11, x11, True, cuda)
    with pytest.raises(ValueError, match="1..10 wires"):
        dm_kernel.dm_chain(enc11, mats11, 2, 11, "depolarizing", 0.1,
                           ry=True)


@pytest.mark.cuda
def test_engine_takes_the_kernel_without_grad_and_chains_under_it(cuda):
    """reupload_block with encode-placed damping: under no_grad one kernel
    launch; with weights that require grad the two-sided SEL chains (kernel
    #5 and its adjoint #6), whose gradients match the CPU's."""
    from qiddm_tpu_torch.sim import engine, sel_kernel

    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(4, 6)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(3, 2, 6, 3)) * 0.4,
                        dtype=torch.float32)
    noise = engine.NoiseModel("amplitude_damping", 0.2, "encode")
    before = dm_kernel.DM_LAUNCHES
    with torch.no_grad():
        fast = engine.reupload_block(x.to(cuda), w.to(cuda), noise=noise,
                                     readout="expvalz")
    assert dm_kernel.DM_LAUNCHES == before + 1
    wc = w.to(cuda).requires_grad_(True)
    sel_before = sel_kernel.SEL_BWD_LAUNCHES
    out = engine.reupload_block(x.to(cuda), wc, noise=noise,
                                readout="expvalz")
    assert dm_kernel.DM_LAUNCHES == before + 1
    (out ** 2).sum().backward()
    assert sel_kernel.SEL_BWD_LAUNCHES == sel_before + 2 * 3
    torch.testing.assert_close(out.detach(), fast, rtol=0, atol=TOL)
    wcpu = w.clone().requires_grad_(True)
    (engine.reupload_block(x, wcpu, noise=noise, readout="expvalz") ** 2
     ).sum().backward()
    scale = wcpu.grad.abs().max().item()
    assert (wc.grad.cpu() - wcpu.grad).abs().max().item() <= 1e-4 * scale
