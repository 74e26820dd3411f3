"""The RY-chain entry of qiddm_tpu_torch: its plain PyTorch versions
(forward and adjoint backward) against the JAX Pallas kernels (interpret
mode, as tests/test_gate_kernel.py runs them on the CPU), the device
dispatch and the autograd Function, and the CUDA kernels against the plain
versions on the card.

Tolerances: <= 1e-5 absolute on the forward's (d, B) float32 planes —
unit-norm states through up to 28 layers of 2x2 gates and 14 RY encodes,
each adding a few ulp. The backward's outputs are held to <= 1e-5 relative
to max(1, max|reference|): with N(0, 1) cotangents the cotangent planes
have norm ~sqrt(d B), dg sums products over all d rows and the batch, and
dcs over the d rows and the L re-uploads.

The CUDA tests carry the ``cuda`` marker and skip without a card. This file
imports JAX only inside the tests that compare with it, so that on a machine
without JAX the card tests run with
``python -m pytest tests/test_torch_ry_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import gate_kernel, ry_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

TOL = 1e-5

# (wires, batch, L, k); L*k layers
CASES = [(1, 1, 2, 2), (1, 5, 4, 3), (3, 5, 2, 2), (3, 1, 4, 3), (6, 5, 6, 2),
         (6, 1, 2, 2)]
# the model's shapes (QIDDM_PL_noise1 784 8 6 2: training batch 10,
# sampling batch 16), the widest, and the JAX package's A/B shape
CARD_CASES = CASES + [(8, 10, 6, 2), (8, 16, 6, 2), (10, 80, 14, 2),
                      (6, 11, 14, 2)]
# the backward's launch plan at its edges (gate_kernel.chain_bwd_plan), as
# in tests/test_torch_gate_kernel.py
PLAN_EDGES = [(1, 1, 2, 2), (3, 8, 2, 2), (3, 9, 2, 2), (5, 32, 2, 2),
              (5, 33, 2, 2), (7, 31, 2, 2), (8, 32, 2, 2), (9, 33, 2, 2),
              (10, 1, 2, 2), (10, 15, 2, 2), (10, 16, 2, 2), (10, 17, 2, 2)]
# the forward's launch plan at its edges (gate_kernel.chain_fwd_plan), as in
# tests/test_torch_gate_kernel.py
FWD_PLAN_EDGES = [(1, 1, 2, 2), (2, 3, 2, 2), (3, 5, 2, 2), (5, 31, 2, 2),
                  (6, 133, 2, 2), (7, 127, 2, 2), (8, 1, 2, 2),
                  (8, 9, 2, 2), (8, 255, 2, 2), (9, 511, 2, 2),
                  (10, 1023, 2, 2)]


def _inputs(w, B, L, k, seed=0):
    """Numpy rotation angles (L*k, w, 3) and encode angles (B, w)."""
    rng = np.random.default_rng(seed)
    ang = rng.normal(size=(L * k, w, 3)).astype(np.float32)
    x = (2 * rng.normal(size=(B, w))).astype(np.float32)
    return ang, x


def _torch_args(ang, x, device="cpu"):
    a = torch.as_tensor(ang, device=device)
    return (torch.as_tensor(x, device=device),
            rot_matrix(a[..., 0], a[..., 1], a[..., 2]))


def _bwd_args(w, B, L, k, device="cpu", seed=0):
    """Inputs of one backward call, (cs, g8, signs, fr, fi, gr, gi), with
    N(0, 1) cotangents; also the numpy cotangents."""
    ang, x = _inputs(w, B, L, k, seed)
    cot = np.random.default_rng(seed + 1).normal(
        size=(2, 2**w, B)).astype(np.float32)
    xt, mats = _torch_args(ang, x, device)
    cs = ry_kernel.ry_cs(xt)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(k, w, cs.device)
    fr, fi = ry_kernel._ry_plain(cs, g8, signs, k, w)
    gr, gi = (torch.as_tensor(c, device=device) for c in cot)
    return (cs, g8, signs, fr, fi, gr, gi), cot


def _assert_rel(got, want, tol=TOL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("w,B,L,k", CASES)
def test_plain_matches_pallas_interpret(w, B, L, k):
    import jax.numpy as jnp

    from qiddm_tpu.sim.gates import rot_matrix as jrot
    from qiddm_tpu.sim.pallas_gate_kernel import ry_chain_planes as jchain

    ang, x = _inputs(w, B, L, k)
    jr, ji = jchain(jnp.asarray(x),
                    jrot(ang[..., 0], ang[..., 1], ang[..., 2]), k, w,
                    interpret=True)
    tr, ti = ry_kernel.ry_chain_planes_plain(*_torch_args(ang, x), k, w)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=TOL)


@pytest.mark.parametrize("w,B,L,k", CASES)
def test_bwd_plain_matches_pallas_vjp(w, B, L, k):
    """(dcs, dg) of the plain walk against ``jax.vjp`` of the JAX custom
    VJP, whose backward is ``_ry_bwd_kernel`` in interpret mode."""
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    args, cot = _bwd_args(w, B, L, k)
    cs, g8, signs = (jnp.asarray(t.numpy()) for t in args[:3])
    _, vjp = jax.vjp(lambda a, b: jpgk._ry_chain(a, b, signs, k, w, True),
                     cs, g8)
    want = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    got = ry_kernel.ry_chain_bwd_plain(*args, k, w)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        _assert_rel(g.numpy(), w_)


@pytest.mark.parametrize("w,B,L,k", CASES)
def test_bwd_plain_matches_autograd_of_plain_forward(w, B, L, k):
    args, _ = _bwd_args(w, B, L, k)
    cs, g8, signs, _, _, gr, gi = args
    leaves = [t.clone().requires_grad_(True) for t in (cs, g8)]
    sr, si = ry_kernel._ry_plain(*leaves, signs, k, w)
    (sr * gr + si * gi).sum().backward()
    got = ry_kernel.ry_chain_bwd_plain(*args, k, w)
    for g, leaf in zip(got, leaves):
        _assert_rel(g.numpy(), leaf.grad.numpy())


def test_ry_cs_and_complex_entry_match_jax():
    import jax.numpy as jnp

    from qiddm_tpu.sim.gates import rot_matrix as jrot
    from qiddm_tpu.sim.pallas_gate_kernel import ry_chain_pallas

    ang, x = _inputs(3, 4, 2, 2)
    xt, mats = _torch_args(ang, x)
    half = 0.5 * x.T
    np.testing.assert_allclose(ry_kernel.ry_cs(xt).numpy(),
                               np.concatenate([np.cos(half), np.sin(half)]),
                               atol=1e-7)
    want = ry_chain_pallas(jnp.asarray(x),
                           jrot(ang[..., 0], ang[..., 1], ang[..., 2]), 2, 3,
                           interpret=True)
    got = ry_kernel.ry_chain(xt, mats, 2, 3)
    assert got.dtype == torch.complex64 and got.shape == (4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_cpu_dispatch_runs_plain_without_launching():
    ang, x = _inputs(4, 6, 3, 2)
    args = _torch_args(ang, x)
    before = (ry_kernel.RY_LAUNCHES, ry_kernel.RY_BWD_LAUNCHES)
    got = ry_kernel.ry_chain_planes(*args, 2, 4)
    want = ry_kernel.ry_chain_planes_plain(*args, 2, 4)
    assert (ry_kernel.RY_LAUNCHES, ry_kernel.RY_BWD_LAUNCHES) == before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_gradients_through_the_angles_match_jax():
    """Under grad mode on CPU tensors the Function runs the plain forward
    and backward, and autograd carries dcs through cos/sin to the encode
    angles: the gradients of ``jax.grad`` through the custom VJP."""
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim.gates import rot_matrix as jrot
    from qiddm_tpu.sim.pallas_gate_kernel import ry_chain_planes as jchain

    ang, x = _inputs(4, 6, 3, 2)
    a = torch.as_tensor(ang).requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    sr, si = ry_kernel.ry_chain_planes(
        xt, rot_matrix(a[..., 0], a[..., 1], a[..., 2]), 2, 4)
    ((sr[:3] ** 2).sum() - (si ** 3).sum()).backward()

    def loss(ang, x):
        r, i = jchain(x, jrot(ang[..., 0], ang[..., 1], ang[..., 2]), 2, 4,
                      interpret=True)
        return (r[:3] ** 2).sum() - (i ** 3).sum()

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(ang), jnp.asarray(x))
    _assert_rel(a.grad.numpy(), want[0])
    _assert_rel(xt.grad.numpy(), want[1])


def test_function_backward_takes_transposed_and_missing_cotangents():
    ang, x = _inputs(4, 6, 3, 2)
    xt, mats = _torch_args(ang, x)
    xt.requires_grad_(True)
    sr, _ = ry_kernel.ry_chain_planes(xt, mats, 2, 4)
    # the probs readout hands back a transposed view; si gets no cotangent
    (sr * sr).T.sum().backward()
    args, _ = _bwd_args(4, 6, 3, 2)
    cs, g8, signs, fr, fi = args[:5]
    dcs, _ = ry_kernel.ry_chain_bwd_plain(cs, g8, signs, fr, fi, 2 * fr,
                                          torch.zeros_like(fi), 2, 4)
    want = torch.autograd.grad(ry_kernel.ry_cs(xt), xt, grad_outputs=dcs)[0]
    torch.testing.assert_close(xt.grad, want)


def test_other_devices_and_wrong_shapes_raise():
    ang, x = _inputs(4, 6, 3, 2)
    xt, mats = _torch_args(ang, x)
    with pytest.raises(ValueError, match="do not fit"):
        ry_kernel.ry_chain_planes(xt, mats, 2, 5)
    with pytest.raises(ValueError, match="no RY-chain path"):
        ry_kernel.ry_chain_planes(xt.to("meta"), mats.to("meta"), 2, 4)
    args, _ = _bwd_args(4, 6, 3, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        ry_kernel._ry_chain_cuda(*args[:3], 2, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        ry_kernel._ry_chain_bwd_cuda(*args, 2, 4)


def test_library_build_covers_the_ry_source():
    """The library's hash and its nvcc jobs include csrc/ry_chain.cu, so an
    edit of it rebuilds the library."""
    assert gate_kernel._CSRC / "ry_chain.cu" in gate_kernel._SOURCES
    assert (gate_kernel._CSRC / "ry_chain.cu").is_file()


@pytest.mark.cuda
@pytest.mark.parametrize("w,B,L,k", CARD_CASES + FWD_PLAN_EDGES)
def test_kernel_matches_plain_on_card(cuda, w, B, L, k):
    ang, x = _inputs(w, B, L, k)
    args = _torch_args(ang, x, cuda)
    before = ry_kernel.RY_LAUNCHES
    kr, ki = ry_kernel.ry_chain_planes(*args, k, w)
    assert ry_kernel.RY_LAUNCHES == before + 1
    qr, qi = ry_kernel.ry_chain_planes_plain(*args, k, w)
    torch.cuda.synchronize()
    assert kr.device == cuda and kr.dtype == torch.float32
    assert (kr - qr).abs().max().item() <= TOL
    assert (ki - qi).abs().max().item() <= TOL
    # no atomics: a second call gives the same bits
    again = ry_kernel.ry_chain_planes(*args, k, w)
    assert torch.equal(kr, again[0]) and torch.equal(ki, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("w,B,L,k", CARD_CASES + PLAN_EDGES)
def test_bwd_kernel_matches_plain_on_card(cuda, w, B, L, k):
    args, _ = _bwd_args(w, B, L, k, cuda)
    before = (ry_kernel.RY_BWD_LAUNCHES, ry_kernel.RY_BWD_BATCH_SUMS)
    got = ry_kernel._ry_chain_bwd_cuda(*args, k, w)
    in_launch = gate_kernel.chain_bwd_plan(w, B).in_launch
    assert (ry_kernel.RY_BWD_LAUNCHES, ry_kernel.RY_BWD_BATCH_SUMS) == (
        before[0] + 1, before[1] + (not in_launch))
    want = ry_kernel.ry_chain_bwd_plain(*args, k, w)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g.device == cuda and g.dtype == torch.float32
        assert g.shape == w_.shape
        assert ((g - w_).abs().max().item()
                <= TOL * max(1.0, w_.abs().max().item()))
    # no atomics: the same bits every time
    again = ry_kernel._ry_chain_bwd_cuda(*args, k, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_backward_on_card_launches_the_bwd_kernel(cuda):
    ang, x = _inputs(8, 10, 6, 2)
    xt, mats = _torch_args(ang, x, cuda)
    xt.requires_grad_(True)
    mats.requires_grad_(True)
    before = (ry_kernel.RY_LAUNCHES, ry_kernel.RY_BWD_LAUNCHES)
    sr, si = ry_kernel.ry_chain_planes(xt, mats, 2, 8)
    (sr * sr + si * si).T.sum(dim=0).square().sum().backward()
    assert ry_kernel.RY_LAUNCHES == before[0] + 1
    assert ry_kernel.RY_BWD_LAUNCHES == before[1] + 1
    xc = xt.detach().cpu().requires_grad_(True)
    mc = mats.detach().cpu().requires_grad_(True)
    r, i = ry_kernel.ry_chain_planes(xc, mc, 2, 8)
    (r * r + i * i).T.sum(dim=0).square().sum().backward()
    for got, want in ((xt.grad, xc.grad), (mats.grad, mc.grad)):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=TOL * max(1.0, want.abs().max()))


@pytest.mark.cuda
def test_second_block_gradient_reaches_the_first_on_card(cuda):
    """QIDDM_PL_noise1 with N=2: the first block's weights get their
    gradient only through kernel #4's dcs of the second block. Each block's
    gradient is held separately against the CPU plain path. Image j is
    scaled by 0.7^j: independent random images have nearly equal singular
    values, and the PCA's 8 components would then be left to rounding."""
    from qiddm_tpu_torch.nn import QIDDM_PL_noise1

    scale = 0.7 ** np.arange(10)[:, None, None, None]
    img = torch.as_tensor(np.random.default_rng(2).uniform(
        size=(10, 1, 28, 28)) * scale, dtype=torch.float32)
    grads = {}
    for dev in ("cpu", cuda):
        net = QIDDM_PL_noise1(784, 8, 6, 2, seed=4, device=dev)
        (net(img.to(dev)) ** 2).mean().backward()
        grads[str(dev)] = net.module.qweights.grad.cpu()
    want, got = grads["cpu"], grads[str(cuda)]
    for n in range(2):
        scale = want[n].abs().max().item()
        assert scale > 0
        assert (got[n] - want[n]).abs().max().item() <= 1e-4 * scale, n


@pytest.mark.cuda
def test_card_never_falls_back_to_plain(cuda, monkeypatch):
    ang, x = _inputs(4, 6, 3, 2)
    xt, mats = _torch_args(ang, x, cuda)
    mats.requires_grad_(True)
    sr, si = ry_kernel.ry_chain_planes(xt, mats, 2, 4)

    def no_plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    monkeypatch.setattr(ry_kernel, "_ry_plain", no_plain)
    monkeypatch.setattr(ry_kernel, "ry_chain_bwd_plain", no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        ry_kernel.ry_chain_planes(xt, mats, 2, 4)
    with pytest.raises(RuntimeError, match="build failed"):
        (sr.sum() + si.sum()).backward()


@pytest.mark.cuda
def test_kernels_reject_unsupported_inputs(cuda):
    args, _ = _bwd_args(4, 6, 3, 2, cuda)
    cs, g8, signs = args[:3]
    with pytest.raises(ValueError, match="float32"):
        ry_kernel._ry_chain_cuda(cs.double(), g8, signs, 2, 4)
    with pytest.raises(ValueError, match="float32"):
        ry_kernel._ry_chain_cuda(cs.T.contiguous().T, g8, signs, 2, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        ry_kernel._ry_chain_cuda(cs[:5].contiguous(), g8, signs, 2, 4)
    with pytest.raises(ValueError, match="same CUDA device"):
        ry_kernel._ry_chain_bwd_cuda(*args[:6], args[6].cpu(), 2, 4)
    with pytest.raises(ValueError, match="does not fit"):
        ry_kernel._ry_chain_bwd_cuda(cs[:, :3].contiguous(), *args[1:], 2, 4)
    ang11, x11 = _inputs(11, 2, 1, 2)
    with pytest.raises(ValueError, match="1..10 wires"):
        ry_kernel.ry_chain_planes(*_torch_args(ang11, x11, cuda), 2, 11)
