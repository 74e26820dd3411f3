"""The wide chain's kernels #11 (grouped sublayer forward) and #12 (its
adjoint backward) in qiddm_tpu_torch: the wrappers' guards and device
dispatch on the CPU, and on the card the kernels against their plain
versions, the autograd Function's launches, and a broken build that makes
the forward and ``backward()`` raise.

Tolerances: <= 1e-5 absolute on the forward's (d, B) float32 planes
(unit-norm states through up to 28 sublayers of group products, each
adding a few ulp). The backward's outputs are held to <= 2e-5 relative to
max(1, max|plain|): dG sums 2^w B / 2^s products a sublayer (164k at
w=20, B=8, s=6) and the kernel sums them in column tiles and splits, the
plain version in cuBLAS's order, which differs by ~1e-6 relative at that
length; the kernels multiply in 3xTF32 on the tensor cores, whose
rounding toward zero shrinks the states by ~2^-25 a product, up to ~8e-6
relative over the 28-sublayer walks; the JAX package holds its own wide
kernel's gradients to 2e-5 (tests/test_wide_kernel.py).

The card cases cover each group width, column counts that are not a
multiple of a tile (B = 3, 5: a ragged last tile, 4-byte copies), B = 10
(40-byte rows), B = 1, and walks of many tiles a block.

The CUDA tests carry the ``cuda`` marker and skip without a card; this file
does not import JAX, so on the card they run with
``python -m pytest tests/test_torch_wide_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import engine, gate_kernel, wide, wide_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

TOL = 1e-5
BWD_TOL = 2e-5

# (w, B, L*k, k): each width's group shapes, both rings, the models' and
# the JAX benchmark's shapes
CASES = [(1, 3, 2, 2), (3, 5, 4, 2), (4, 16, 4, 2), (9, 7, 6, 3),
         (11, 10, 4, 2), (11, 3, 4, 2), (12, 3, 2, 1), (13, 10, 4, 2),
         (13, 5, 4, 2), (16, 10, 28, 2), (16, 1, 4, 2), (20, 2, 2, 2)]


def _args(w, B, n_layers, device="cpu", seed=0):
    """Phase planes and rotations of one chain call."""
    rng = np.random.default_rng(seed)
    ang = torch.as_tensor(rng.normal(size=(n_layers, w, 3)),
                          dtype=torch.float32, device=device)
    x = torch.as_tensor(rng.normal(size=(2**w, B)), dtype=torch.float32,
                        device=device)
    return (torch.cos(x), torch.sin(x),
            rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2]))


def _gplanes(mats, w):
    return wide_kernel._planes_of(wide.group_gates(mats, wide.group_sizes(w)))


def _bwd_args(w, B, n_layers, k, device="cpu", seed=0):
    """(pr, pi, gplanes, fr, fi, gr, gi) with N(0, 1) cotangents."""
    pr, pi, mats = _args(w, B, n_layers, device, seed)
    gplanes = _gplanes(mats, w)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    fr, fi = wide_kernel._chain_plain(pr, pi, gplanes, signs, k, w)
    rng = np.random.default_rng(seed + 1)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**w, B)),
                              dtype=torch.float32, device=device)
              for _ in range(2))
    return pr, pi, gplanes, fr, fi, gr, gi


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_cpu_dispatch_runs_plain_without_launching():
    pr, pi, mats = _args(11, 3, 4)
    before = (wide_kernel.WIDE_LAUNCHES, wide_kernel.WIDE_BWD_LAUNCHES)
    got = wide_kernel.wide_chain_planes(pr, pi, mats, 2, 11)
    want = wide_kernel.wide_chain_planes_plain(pr, pi, mats, 2, 11)
    assert (wide_kernel.WIDE_LAUNCHES,
            wide_kernel.WIDE_BWD_LAUNCHES) == before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_other_devices_and_wrong_shapes_raise():
    pr, pi, mats = _args(4, 6, 4)
    with pytest.raises(ValueError, match="do not hold"):
        wide_kernel.wide_chain_planes(pr, pi, mats, 2, 5)
    meta = [t.to("meta") for t in (pr, pi, mats)]
    with pytest.raises(ValueError, match="no wide-chain path"):
        wide_kernel.wide_chain_planes(*meta, 2, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        wide_kernel._wide_chain_cuda(pr, pi, _gplanes(mats, 4), 2, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        wide_kernel._wide_chain_bwd_cuda(*_bwd_args(4, 6, 4, 2), 2, 4)


def test_engine_routes_rz_at_11_to_20_wires_to_the_wide_chain(monkeypatch):
    """RZ blocks above the gate chain's 10 wires take the wide chain's
    kernels; 10 wires do not, and an RY encode, 21 wires and complex128
    take the grouped chain in PyTorch (``wide.reupload_chain_wide``)."""
    calls = []
    real = engine.wide_chain_planes

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(engine, "wide_chain_planes", spy)
    for w in (10, 11, 12):
        out = engine.reupload_block(torch.zeros(2, w),
                                    torch.zeros(1, 2, w, 3),
                                    readout="expvalz")
        assert out.shape == (2, w) and torch.isfinite(out).all()
    assert calls == [11, 12]
    for w, kwargs in ((11, {"encode": "ry"}), (21, {}),
                      (11, {"cdtype": torch.complex128})):
        engine.reset_route_calls()
        with torch.no_grad():
            out = engine.reupload_block(torch.zeros(1, w),
                                        torch.zeros(1, 2, w, 3),
                                        readout="expvalz", **kwargs)
        # zero angles leave |0...0>: every PauliZ expectation is 1
        assert torch.allclose(out, torch.ones_like(out))
        assert engine.ROUTE_CALLS["wide"] == 1
    assert calls == [11, 12]


@pytest.mark.cuda
@pytest.mark.parametrize("w,B,n_layers,k", CASES)
def test_kernel_matches_plain_on_card(cuda, w, B, n_layers, k):
    pr, pi, mats = _args(w, B, n_layers, cuda)
    before = wide_kernel.WIDE_LAUNCHES
    kr, ki = wide_kernel.wide_chain_planes(pr, pi, mats, k, w)
    # one group-kernel launch per wire group of each sublayer
    assert (wide_kernel.WIDE_LAUNCHES
            == before + n_layers * len(wide.group_sizes(w)))
    qr, qi = wide_kernel.wide_chain_planes_plain(pr, pi, mats, k, w)
    torch.cuda.synchronize()
    assert kr.device == cuda and kr.dtype == torch.float32
    assert (kr - qr).abs().max().item() <= TOL
    assert (ki - qi).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("w,B,n_layers,k", CASES)
def test_bwd_kernel_matches_plain_on_card(cuda, w, B, n_layers, k):
    args = _bwd_args(w, B, n_layers, k, cuda)
    before = wide_kernel.WIDE_BWD_LAUNCHES
    got = wide_kernel._wide_chain_bwd_cuda(*args, k, w)
    assert (wide_kernel.WIDE_BWD_LAUNCHES
            == before + n_layers * len(wide.group_sizes(w)))
    want = wide_kernel.wide_chain_bwd_plain(*args, k, w)
    torch.cuda.synchronize()
    got, want = (got[0], got[1], *got[2]), (want[0], want[1], *want[2])
    for g, w_ in zip(got, want):
        assert g.device == cuda and g.dtype == torch.float32
        assert g.shape == w_.shape
        assert ((g - w_).abs().max().item()
                <= BWD_TOL * max(1.0, w_.abs().max().item()))
    # the dG sums run in a fixed order: the same bits every time
    again = wide_kernel._wide_chain_bwd_cuda(*args, k, w)
    again = (again[0], again[1], *again[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_bwd_kernel_rebuilds_in_place_over_many_tiles(cuda):
    """At (19, 3): 384 to 820 column tiles a group launch, many a
    persistent block, odd rows (4-byte copies in the last group); the
    two-right-hand-side launch rebuilds the state in place over its work
    copies, so the caller's planes stay as they were, the result holds the
    plain version, and a second run gives the same bits."""
    w, B, n_layers, k = 19, 3, 2, 2
    args = _bwd_args(w, B, n_layers, k, cuda, seed=5)
    kept = [t.clone() for t in (args[0], args[1], *args[3:])]
    fr, fi = wide_kernel._wide_chain_cuda(*args[:3], k, w)
    got = wide_kernel._wide_chain_bwd_cuda(*args, k, w)
    again = wide_kernel._wide_chain_bwd_cuda(*args, k, w)
    want = wide_kernel.wide_chain_bwd_plain(*args, k, w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in
               zip(kept, (args[0], args[1], *args[3:])))
    assert max((fr - args[3]).abs().max().item(),
               (fi - args[4]).abs().max().item()) <= TOL
    got, again, want = ((t[0], t[1], *t[2]) for t in (got, again, want))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w_ in zip(got, want):
        assert ((g - w_).abs().max().item()
                <= BWD_TOL * max(1.0, w_.abs().max().item()))


@pytest.mark.cuda
def test_backward_on_card_matches_cpu_autograd(cuda):
    w, k = 13, 2
    pr, pi, mats = _args(w, 10, 4, cuda, seed=3)
    mats.requires_grad_(True)
    before = (wide_kernel.WIDE_LAUNCHES, wide_kernel.WIDE_BWD_LAUNCHES)
    sr, si = wide_kernel.wide_chain_planes(pr, pi, mats, k, w)
    (sr * sr + si * si).T[:, :100].square().sum().backward()
    # 4 sublayers over the groups (7, 6)
    assert (wide_kernel.WIDE_LAUNCHES,
            wide_kernel.WIDE_BWD_LAUNCHES) == (before[0] + 8, before[1] + 8)
    cpu = mats.detach().cpu().requires_grad_(True)
    r, i = wide_kernel.wide_chain_planes(pr.cpu(), pi.cpu(), cpu, k, w)
    (r * r + i * i).T[:, :100].square().sum().backward()
    torch.testing.assert_close(mats.grad.cpu(), cpu.grad, rtol=0,
                               atol=BWD_TOL * max(1.0, cpu.grad.abs().max()))


@pytest.mark.cuda
def test_card_never_falls_back_to_plain(cuda, monkeypatch):
    pr, pi, mats = _args(11, 3, 2, cuda)

    def no_plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    monkeypatch.setattr(wide_kernel, "_chain_plain", no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        wide_kernel.wide_chain_planes(pr, pi, mats, 2, 11)


@pytest.mark.cuda
def test_card_backward_never_falls_back_to_plain(cuda, monkeypatch):
    pr, pi, mats = _args(11, 3, 2, cuda)
    mats.requires_grad_(True)
    sr, si = wide_kernel.wide_chain_planes(pr, pi, mats, 2, 11)

    def no_plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    monkeypatch.setattr(wide_kernel, "wide_chain_bwd_plain", no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        (sr.sum() + si.sum()).backward()


@pytest.mark.cuda
def test_kernels_reject_unsupported_inputs(cuda):
    pr, pi, mats = _args(4, 6, 4, cuda)
    gplanes = _gplanes(mats, 4)
    with pytest.raises(ValueError, match="float32"):
        wide_kernel._wide_chain_cuda(pr.double(), pi, gplanes, 2, 4)
    with pytest.raises(ValueError, match="float32"):
        wide_kernel._wide_chain_cuda(pr.T.contiguous().T, pi, gplanes, 2, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        wide_kernel._wide_chain_cuda(pr, pi, gplanes, 3, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        wide_kernel._wide_chain_cuda(pr, pi, gplanes * 2, 2, 4)
    args = _bwd_args(4, 6, 4, 2, cuda)
    with pytest.raises(ValueError, match="same CUDA device"):
        wide_kernel._wide_chain_bwd_cuda(*args[:6], args[6].cpu(), 2, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        wide_kernel._wide_chain_bwd_cuda(*args[:5], args[5][:, :3].contiguous(),
                                         args[6][:, :3].contiguous(), 2, 4)
    p21 = torch.zeros((1, 1), device=cuda)
    with pytest.raises(ValueError, match="1..20 wires"):
        wide_kernel._wide_chain_cuda(p21, p21, gplanes, 2, 21)


@pytest.mark.cuda
def test_kernel_indexes_planes_past_2_31_elements(cuda):
    """At w=20, B=2048 a plane holds 2^31 floats, past a 32-bit index. The
    batch columns are independent, so the first and the last 8 columns of
    the full call must equal a call on those columns alone (forward only:
    the backward's dozen planes of 8 GB do not fit the card)."""
    w, B, n_layers = 20, 2048, 2
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((2**w, B), generator=gen, device=cuda)
    pr, pi = torch.cos(x), torch.sin(x)
    del x
    mats = _args(w, 1, n_layers, cuda)[2]
    gplanes = _gplanes(mats, w)
    sr, si = wide_kernel._wide_chain_cuda(pr, pi, gplanes, 2, w)
    for cols in (slice(0, 8), slice(B - 8, B)):
        qr, qi = wide_kernel._wide_chain_cuda(pr[:, cols].contiguous(),
                                              pi[:, cols].contiguous(),
                                              gplanes, 2, w)
        assert torch.equal(sr[:, cols], qr) and torch.equal(si[:, cols], qi)
