"""The wide chain's monolithic kernels #9 (the whole forward chain in one
cooperative launch) and #10 (its adjoint walk in one launch) in
qiddm_tpu_torch: the kernel-variant switch, the route the autograd Function
takes for each variant and device (on the CPU, with the card faked by
patching the route and handing CPU tensors to the forward operators' card
launchers), and on the card the kernels against their plain
versions and bit for bit against #11/#12, the Function's launches,
repeat-bit equality, the index width, the launch geometry, a broken build
that makes the forward and ``backward()`` raise, and rejected inputs.

Tolerances against plain are test_torch_wide_kernel.py's: <= 1e-5
absolute on the forward's (d, B) float32 planes; the backward's outputs
<= 2e-5 relative to max(1, max|plain|), since dG sums 2^w B / 2^s products
a sublayer in column tiles and splits on the card and in cuBLAS's order in
the plain version. #9/#10 run #11/#12's tensor-core units (3xTF32) on the
same column tiles, dG splits and fixed-order sums, one pass a launch of
theirs, so against #11/#12 they are held to equality.

The CUDA tests carry the ``cuda`` marker and skip without a card; this file
does not import JAX, so on the card they run with
``python -m pytest tests/test_torch_wide_mono_kernel.py -m cuda
--noconftest``.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from qiddm_tpu_torch import config
from qiddm_tpu_torch.sim import gate_kernel, wide, wide_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

TOL = 1e-5
BWD_TOL = 2e-5

# (w, B, L*k, k): test_torch_wide_kernel.py's shapes, one to three groups,
# the model's (16, 10, 28), the widest, and the bench blocks' full depth at
# 16 and 20 wires, where #10 rebuilds the state through 28 sublayers; and
# fewer column tiles than blocks (11, 1), rows that cp.async copies 4 bytes
# at a time (odd B) into L1 across the grid barriers, as (13, 10) and
# (16, 10) copy 8
CASES = [(1, 3, 2, 2), (3, 5, 4, 2), (4, 16, 4, 2), (9, 7, 6, 3),
         (11, 10, 4, 2), (12, 3, 2, 1), (13, 10, 4, 2), (16, 10, 28, 2),
         (20, 2, 2, 2), (16, 8, 28, 2), (20, 8, 28, 2), (11, 1, 4, 2),
         (11, 3, 4, 2), (13, 5, 4, 2), (19, 3, 4, 2)]
COUNTERS = ("WIDE_LAUNCHES", "WIDE_BWD_LAUNCHES", "WIDE_MONO_LAUNCHES",
            "WIDE_MONO_BWD_LAUNCHES")


def _counts():
    return tuple(getattr(wide_kernel, c) for c in COUNTERS)


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


def _grads(pr, pi, mats, k, w, fn=wide_kernel.wide_chain_planes):
    """The states and the gradients in the phases and rotations of a
    weighted probability readout through ``fn``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (pr, pi, mats)]
    sr, si = fn(*leaves, k, w)
    ((sr * sr + si * si).T[:, :50].square()).sum().backward()
    return sr.detach(), si.detach(), [t.grad for t in leaves]


@pytest.fixture
def variant():
    """Set the wide kernel variant for one test and restore it after."""
    prev = config.wide_kernel_variant()
    yield config.set_wide_kernel_variant
    config.set_wide_kernel_variant(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_variant_switch_validates_and_defaults_to_scan(variant):
    assert config.wide_kernel_variant() == "scan"
    variant("monolith")
    assert config.wide_kernel_variant() == "monolith"
    for bad in ("off", "on", "auto", "Monolith", "", None):
        with pytest.raises(ValueError):
            config.set_wide_kernel_variant(bad)
        assert config.wide_kernel_variant() == "monolith"
    variant("scan")
    assert config.wide_kernel_variant() == "scan"


@pytest.mark.parametrize("name", ["scan", "monolith"])
def test_route_follows_the_device_then_the_variant(variant, name):
    variant(name)
    assert wide_kernel._route(torch.device("cpu")) == "plain"
    assert wide_kernel._route(torch.device("cuda")) == name
    assert wide_kernel._route(torch.device("cuda", 1)) == name


@pytest.mark.parametrize("w,B,n_layers,k", [(11, 3, 4, 2), (13, 2, 2, 1)])
def test_cpu_variants_give_identical_plain_results(variant, w, B, n_layers,
                                                   k):
    """On CPU tensors both variants run the plain versions: equal states
    and gradients, equal to autograd through the plain chain, and no
    counter moves."""
    pr, pi, mats = _args(w, B, n_layers, seed=w)
    want = _grads(pr, pi, mats, k, w, wide_kernel.wide_chain_planes_plain)
    before = _counts()
    for name in ("scan", "monolith"):
        variant(name)
        got = _grads(pr, pi, mats, k, w)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for g, q in zip(got[2], want[2]):
            torch.testing.assert_close(g, q, rtol=0, atol=1e-6)
    assert _counts() == before


@contextlib.contextmanager
def _card_ops():
    """Fake the card for the forward operators ``qiddm::wide_chain`` and
    ``qiddm::wide_mono``: CPU tensors go to their card launchers (looked up
    on ``wide_kernel`` at call time) in place of the plain chain, until the
    block ends."""
    lib = torch.library.Library("qiddm", "IMPL")
    for op, launcher in (("wide_chain", "_wide_chain_cuda"),
                         ("wide_mono", "_wide_mono_cuda")):
        lib.impl(op, lambda *a, _l=launcher: getattr(wide_kernel, _l)(*a),
                 "CPU")
    try:
        yield
    finally:
        lib._destroy()


@pytest.mark.parametrize("name,launchers", [
    ("monolith", ("_wide_mono_cuda", "_wide_mono_bwd_cuda")),
    ("scan", ("_wide_chain_cuda", "_wide_chain_bwd_cuda")),
])
def test_card_route_calls_only_its_variants_launchers(variant, monkeypatch,
                                                      name, launchers):
    """With every tensor taken for a card tensor (the route patched, the
    forward operators on the card's launchers), the Function calls the
    chosen variant's two launchers once each, and never the other
    variant's or the plain versions; the backward keeps the forward's route
    when the variant changes in between."""
    w, k = 11, 2
    pr, pi, mats = _args(w, 3, 4, seed=2)
    want = _grads(pr, pi, mats, k, w)
    real_fwd = wide_kernel._chain_plain
    real_bwd = wide_kernel.wide_chain_bwd_plain
    real_route = wide_kernel._route
    calls = []

    def fwd(pr, pi, gplanes, k, wires):
        calls.append("fwd")
        signs = gate_kernel._sign_planes_on(k, wires, pr.device)
        return real_fwd(pr, pi, gplanes, signs, k, wires)

    def bwd(*args):
        calls.append("bwd")
        return real_bwd(*args)

    def never(*args, **kwargs):
        raise AssertionError("another variant's launcher or a plain version "
                             "ran on a card tensor")

    monkeypatch.setattr(wide_kernel, "_route",
                        lambda device: real_route(torch.device("cuda")))
    for attr in ("_wide_mono_cuda", "_wide_mono_bwd_cuda",
                 "_wide_chain_cuda", "_wide_chain_bwd_cuda", "_chain_plain",
                 "wide_chain_bwd_plain"):
        monkeypatch.setattr(wide_kernel, attr, never)
    monkeypatch.setattr(wide_kernel, launchers[0], fwd)
    monkeypatch.setattr(wide_kernel, launchers[1], bwd)
    variant(name)
    leaves = [t.detach().clone().requires_grad_(True) for t in (pr, pi, mats)]
    with _card_ops():
        sr, si = wide_kernel.wide_chain_planes(*leaves, k, w)
        variant("scan" if name == "monolith" else "monolith")
        ((sr * sr + si * si).T[:, :50].square()).sum().backward()
    assert calls == ["fwd", "bwd"]
    assert torch.equal(sr.detach(), want[0])
    for leaf, q in zip(leaves, want[2]):
        torch.testing.assert_close(leaf.grad, q, rtol=0, atol=1e-6)


def test_monolith_wrappers_take_only_card_tensors():
    pr, pi, mats = _args(4, 6, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        wide_kernel._wide_mono_cuda(pr, pi, _gplanes(mats, 4), 2, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        wide_kernel._wide_mono_bwd_cuda(*_bwd_args(4, 6, 4, 2), 2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("w,B,n_layers,k", CASES)
def test_mono_matches_plain_and_scan_on_card(cuda, w, B, n_layers, k):
    args = _bwd_args(w, B, n_layers, k, cuda)
    pr, pi, gplanes, fr, fi = args[:5]
    before = _counts()
    mr, mi = wide_kernel._wide_mono_cuda(pr, pi, gplanes, k, w)
    got = wide_kernel._wide_mono_bwd_cuda(*args, k, w)
    # one launch a chain call each, and no group-kernel launch
    assert _counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    sr, si = wide_kernel._wide_chain_cuda(pr, pi, gplanes, k, w)
    scan = wide_kernel._wide_chain_bwd_cuda(*args, k, w)
    want = wide_kernel.wide_chain_bwd_plain(*args, k, w)
    torch.cuda.synchronize()
    assert mr.device == cuda and mr.dtype == torch.float32
    for m, ref in ((mr, fr), (mi, fi)):
        assert (m - ref).abs().max().item() <= TOL
    assert torch.equal(mr, sr) and torch.equal(mi, si)
    got, scan, want = ((t[0], t[1], *t[2]) for t in (got, scan, want))
    for g, s_, w_ in zip(got, scan, want):
        assert g.device == cuda and g.dtype == torch.float32
        assert g.shape == w_.shape
        scale = max(1.0, w_.abs().max().item())
        assert (g - w_).abs().max().item() <= BWD_TOL * scale
        assert torch.equal(g, s_)
    # no atomics, and partials mapped to work units, not blocks: two runs
    # of #10 give the same bits
    again = wide_kernel._wide_mono_bwd_cuda(*args, k, w)
    again = (again[0], again[1], *again[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_monolith_variant_runs_the_function_on_card(cuda, variant):
    """Under the "monolith" variant the engine's entry launches #9 once
    forward and #10 once backward, no group kernel, and its gradients
    match autograd on the CPU."""
    w, k = 13, 2
    pr, pi, mats = _args(w, 10, 4, cuda, seed=3)
    variant("monolith")
    before = _counts()
    got = _grads(pr, pi, mats, k, w)
    assert _counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    want = _grads(pr.cpu(), pi.cpu(), mats.cpu(), k, w)
    for g, q in zip(got[2], want[2]):
        torch.testing.assert_close(g.cpu(), q, rtol=0,
                                   atol=BWD_TOL * max(1.0, q.abs().max()))


@pytest.mark.cuda
def test_mono_indexes_planes_past_2_31_elements(cuda):
    """At w=20, B=2048 a plane holds 2^31 floats: the first and the last 8
    columns of the full call equal a call on those columns alone (forward
    only, as for #11)."""
    w, B, n_layers = 20, 2048, 2
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((2**w, B), generator=gen, device=cuda)
    pr, pi = torch.cos(x), torch.sin(x)
    del x
    gplanes = _gplanes(_args(w, 1, n_layers, cuda)[2], w)
    sr, si = wide_kernel._wide_mono_cuda(pr, pi, gplanes, 2, w)
    for cols in (slice(0, 8), slice(B - 8, B)):
        qr, qi = wide_kernel._wide_mono_cuda(pr[:, cols].contiguous(),
                                             pi[:, cols].contiguous(),
                                             gplanes, 2, w)
        assert torch.equal(sr[:, cols], qr) and torch.equal(si[:, cols], qi)


@pytest.mark.cuda
@pytest.mark.parametrize("w,B", [(4, 16), (11, 1), (16, 10), (20, 8)])
def test_mono_grid_fits_on_the_card_at_once(cuda, w, B):
    """A cooperative launch needs every block resident: the grid the launch
    plans is at most the co-resident blocks an SM times the SMs, and at
    least one."""
    lib = gate_kernel._library()
    _, sizes = wide_kernel._group_args((), wide.group_sizes(w))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for bwd in (False, True):
        out = (ctypes.c_int * 2)()
        assert lib.wide_mono_plan(int(bwd), *sizes, w, B, cuda.index or 0,
                                  out) == 0
        grid, blocks_per_sm = out
        assert blocks_per_sm >= 1 and 1 <= grid <= blocks_per_sm * sms


@pytest.mark.cuda
def test_monolith_never_falls_back(cuda, variant, monkeypatch):
    """A broken build raises in the forward and in ``backward()``; neither
    the scan kernels nor the plain versions run instead."""
    pr, pi, mats = _args(11, 3, 2, cuda)
    mats.requires_grad_(True)
    variant("monolith")
    sr, si = wide_kernel.wide_chain_planes(pr, pi, mats, 2, 11)

    def never(*a, **kw):
        raise AssertionError("another path ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    for attr in ("_wide_chain_cuda", "_wide_chain_bwd_cuda", "_chain_plain",
                 "wide_chain_bwd_plain"):
        monkeypatch.setattr(wide_kernel, attr, never)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        (sr.sum() + si.sum()).backward()
    with pytest.raises(RuntimeError, match="build failed"):
        wide_kernel.wide_chain_planes(pr, pi, mats, 2, 11)


@pytest.mark.cuda
def test_mono_kernels_reject_unsupported_inputs(cuda):
    pr, pi, mats = _args(4, 6, 4, cuda)
    gplanes = _gplanes(mats, 4)
    with pytest.raises(ValueError, match="float32"):
        wide_kernel._wide_mono_cuda(pr.double(), pi, gplanes, 2, 4)
    with pytest.raises(ValueError, match="float32"):
        wide_kernel._wide_mono_cuda(pr.T.contiguous().T, pi, gplanes, 2, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        wide_kernel._wide_mono_cuda(pr, pi, gplanes, 3, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        wide_kernel._wide_mono_cuda(pr, pi, gplanes * 2, 2, 4)
    args = _bwd_args(4, 6, 4, 2, cuda)
    with pytest.raises(ValueError, match="same CUDA device"):
        wide_kernel._wide_mono_bwd_cuda(*args[:6], args[6].cpu(), 2, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        wide_kernel._wide_mono_bwd_cuda(*args[:5],
                                        args[5][:, :3].contiguous(),
                                        args[6][:, :3].contiguous(), 2, 4)
    p21 = torch.zeros((1, 1), device=cuda)
    with pytest.raises(ValueError, match="1..20 wires"):
        wide_kernel._wide_mono_cuda(p21, p21, gplanes, 2, 21)
