"""The gate-chain entry of qiddm_tpu_torch: its plain PyTorch versions
(forward and adjoint backward) against the JAX Pallas kernels (interpret
mode, as tests/test_gate_kernel.py runs them on the CPU), the device
dispatch and the autograd Function, and the CUDA kernels against the plain
versions on the card.

Tolerances: <= 1e-5 absolute on the forward's (d, B) float32 planes —
unit-norm states through up to 28 layers of 2x2 gates, where each layer
adds a few ulp. The backward's outputs are held to <= 1e-5 relative to
max(1, max|reference|): with N(0, 1) cotangents the cotangent planes have
norm ~sqrt(d B), and dg sums products over all d rows and the batch.

The CUDA tests carry the ``cuda`` marker and skip without a card. This file
imports JAX only inside the tests that compare with it, so that on a machine
without JAX the card tests run with
``python -m pytest tests/test_torch_gate_kernel.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from qiddm_tpu_torch.sim import gate_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

TOL = 1e-5

CASES = [(1, 3, 2, 2), (4, 6, 3, 2), (6, 16, 14, 2), (6, 5, 3, 3),
         (8, 11, 2, 2)]


def _inputs(w, B, L, k, seed=0):
    """Numpy angles (L*k, w, 3) and phase angles (d, B)."""
    rng = np.random.default_rng(seed)
    ang = rng.normal(size=(L * k, w, 3)).astype(np.float32)
    x = rng.normal(size=(2**w, B)).astype(np.float32)
    return ang, x


def _torch_args(ang, x, device="cpu"):
    a = torch.as_tensor(ang, device=device)
    xt = torch.as_tensor(x, device=device)
    return (torch.cos(xt), torch.sin(xt),
            rot_matrix(a[..., 0], a[..., 1], a[..., 2]))


def _bwd_args(w, B, L, k, device="cpu", seed=0):
    """Inputs of one backward call, (pr, pi, g8, signs, fr, fi, gr, gi),
    with N(0, 1) cotangents; also the numpy cotangents."""
    ang, x = _inputs(w, B, L, k, seed)
    cot = np.random.default_rng(seed + 1).normal(
        size=(2, 2**w, B)).astype(np.float32)
    pr, pi, mats = _torch_args(ang, x, device)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    fr, fi = gate_kernel._chain_plain(pr, pi, g8, signs, k, w)
    gr, gi = (torch.as_tensor(c, device=device) for c in cot)
    return (pr, pi, g8, signs, fr, fi, gr, gi), cot


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
    from qiddm_tpu.sim.pallas_gate_kernel import gate_chain_planes as jchain

    ang, x = _inputs(w, B, L, k)
    jr, ji = jchain(jnp.cos(x), jnp.sin(x),
                    jrot(ang[..., 0], ang[..., 1], ang[..., 2]), k, w,
                    interpret=True)
    tr, ti = gate_kernel.gate_chain_planes_plain(*_torch_args(ang, x), k, w)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=TOL)


@pytest.mark.parametrize("w,B,L,k", CASES)
def test_bwd_plain_matches_pallas_vjp(w, B, L, k):
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    args, cot = _bwd_args(w, B, L, k)
    pr, pi, g8, signs = (jnp.asarray(t.numpy()) for t in args[:4])
    _, vjp = jax.vjp(
        lambda a, b, c: jpgk._gate_chain(a, b, c, signs, k, w, True),
        pr, pi, g8)
    want = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    got = gate_kernel.gate_chain_bwd_plain(*args, k, w)
    for g, w_ in zip(got, want):
        _assert_rel(g.numpy(), w_)


@pytest.mark.parametrize("w,B,L,k", CASES)
def test_bwd_plain_matches_autograd_of_plain_forward(w, B, L, k):
    args, _ = _bwd_args(w, B, L, k)
    pr, pi, g8, signs, _, _, gr, gi = args
    leaves = [t.clone().requires_grad_(True) for t in (pr, pi, g8)]
    sr, si = gate_kernel._chain_plain(*leaves, signs, k, w)
    (sr * gr + si * gi).sum().backward()
    got = gate_kernel.gate_chain_bwd_plain(*args, k, w)
    for g, leaf in zip(got, leaves):
        _assert_rel(g.numpy(), leaf.grad.numpy())


def test_to_g8_and_sign_planes_match_jax():
    import jax.numpy as jnp

    from qiddm_tpu.sim import pallas_gate_kernel as jpgk

    ang, _ = _inputs(4, 1, 3, 2)
    mats = _torch_args(ang, np.zeros((16, 1), np.float32))[2]
    np.testing.assert_array_equal(
        gate_kernel._to_g8(mats).numpy(),
        np.asarray(jpgk._to_g8(jnp.asarray(mats.numpy()))))
    for k, w in ((2, 6), (3, 4), (2, 1)):
        np.testing.assert_array_equal(gate_kernel._sign_planes(k, w),
                                      jpgk._sign_planes(k, w))


def test_cpu_dispatch_runs_plain_without_launching():
    ang, x = _inputs(4, 6, 3, 2)
    args = _torch_args(ang, x)
    before = gate_kernel.LAUNCHES
    got = gate_kernel.gate_chain_planes(*args, 2, 4)
    want = gate_kernel.gate_chain_planes_plain(*args, 2, 4)
    assert gate_kernel.LAUNCHES == before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_requires_grad_under_grad_mode_raises():
    """Under grad mode, with inputs that require grad, the entry raises
    nothing: on CPU tensors the Function runs the plain forward and the
    plain backward and returns the gradients of the JAX custom VJP."""
    import jax
    import jax.numpy as jnp

    from qiddm_tpu.sim.gates import rot_matrix as jrot
    from qiddm_tpu.sim.pallas_gate_kernel import gate_chain_planes as jchain

    ang, x = _inputs(4, 6, 3, 2)
    a = torch.as_tensor(ang).requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    mats = rot_matrix(a[..., 0], a[..., 1], a[..., 2])
    before = (gate_kernel.LAUNCHES, gate_kernel.BWD_LAUNCHES)
    sr, si = gate_kernel.gate_chain_planes(torch.cos(xt), torch.sin(xt),
                                           mats, 2, 4)
    ((sr[:3] ** 2).sum() - (si ** 3).sum()).backward()
    assert (gate_kernel.LAUNCHES, gate_kernel.BWD_LAUNCHES) == before

    def loss(ang, x):
        r, i = jchain(jnp.cos(x), jnp.sin(x),
                      jrot(ang[..., 0], ang[..., 1], ang[..., 2]), 2, 4,
                      interpret=True)
        return (r[:3] ** 2).sum() - (i ** 3).sum()

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(ang), jnp.asarray(x))
    _assert_rel(a.grad.numpy(), want[0])
    _assert_rel(xt.grad.numpy(), want[1])


def test_function_backward_takes_transposed_and_missing_cotangents():
    ang, x = _inputs(4, 6, 3, 2)
    pr, pi, mats = _torch_args(ang, x)
    mats.requires_grad_(True)
    sr, _ = gate_kernel.gate_chain_planes(pr, pi, mats, 2, 4)
    # the probs readout hands back a transposed view; si gets no cotangent
    (sr * sr).T.sum().backward()
    g8 = gate_kernel._to_g8(mats.detach())
    signs = gate_kernel._sign_planes_on(2, 4, pr.device)
    fr, fi = gate_kernel._chain_plain(pr, pi, g8, signs, 2, 4)
    g8.requires_grad_(True)
    want = gate_kernel.gate_chain_bwd_plain(
        pr, pi, g8.detach(), signs, fr, fi, 2 * fr, torch.zeros_like(fi),
        2, 4)[2]
    got = torch.autograd.grad(gate_kernel._to_g8(mats), mats,
                              grad_outputs=want)[0]
    torch.testing.assert_close(mats.grad, got)


def test_other_devices_and_wrong_shapes_raise():
    ang, x = _inputs(4, 6, 3, 2)
    pr, pi, mats = _torch_args(ang, x)
    with pytest.raises(ValueError, match="do not hold"):
        gate_kernel.gate_chain_planes(pr, pi, mats, 2, 5)
    meta = [t.to("meta") for t in (pr, pi, mats)]
    with pytest.raises(ValueError, match="no gate-chain path"):
        gate_kernel.gate_chain_planes(*meta, 2, 4)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(2, 4, pr.device)
    with pytest.raises(ValueError, match="CUDA device"):
        gate_kernel._gate_chain_cuda(pr, pi, g8, signs, 2, 4)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(gate_kernel, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gate_kernel.build_library()
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.cuda
@pytest.mark.parametrize("w,B,L,k", CASES + [(10, 80, 14, 2),
                                              (6, 16, 21, 2)])
def test_kernel_matches_plain_on_card(cuda, w, B, L, k):
    ang, x = _inputs(w, B, L, k)
    args = _torch_args(ang, x, cuda)
    before = gate_kernel.LAUNCHES
    kr, ki = gate_kernel.gate_chain_planes(*args, k, w)
    assert gate_kernel.LAUNCHES == before + 1
    qr, qi = gate_kernel.gate_chain_planes_plain(*args, k, w)
    torch.cuda.synchronize()
    assert kr.device == cuda and kr.dtype == torch.float32
    assert (kr - qr).abs().max().item() <= TOL
    assert (ki - qi).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("w,B,L,k", CASES + [(10, 80, 14, 2)])
def test_bwd_kernel_matches_plain_on_card(cuda, w, B, L, k):
    args, _ = _bwd_args(w, B, L, k, cuda)
    before = gate_kernel.BWD_LAUNCHES
    got = gate_kernel._gate_chain_bwd_cuda(*args, k, w)
    assert gate_kernel.BWD_LAUNCHES == before + 1
    want = gate_kernel.gate_chain_bwd_plain(*args, k, w)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g.device == cuda and g.dtype == torch.float32
        assert ((g - w_).abs().max().item()
                <= TOL * max(1.0, w_.abs().max().item()))
    # the batch sum of dg runs in a fixed order: the same bits every time
    again = gate_kernel._gate_chain_bwd_cuda(*args, k, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_backward_on_card_launches_the_bwd_kernel(cuda):
    ang, x = _inputs(6, 10, 14, 2)
    pr, pi, mats = _torch_args(ang, x, cuda)
    mats.requires_grad_(True)
    before = (gate_kernel.LAUNCHES, gate_kernel.BWD_LAUNCHES)
    sr, si = gate_kernel.gate_chain_planes(pr, pi, mats, 2, 6)
    (sr * sr + si * si).T.sum(dim=0).square().sum().backward()
    assert gate_kernel.LAUNCHES == before[0] + 1
    assert gate_kernel.BWD_LAUNCHES == before[1] + 1
    cpu = mats.detach().cpu().requires_grad_(True)
    r, i = gate_kernel.gate_chain_planes(pr.cpu(), pi.cpu(), cpu, 2, 6)
    (r * r + i * i).T.sum(dim=0).square().sum().backward()
    torch.testing.assert_close(mats.grad.cpu(), cpu.grad, rtol=0,
                               atol=TOL * max(1.0, cpu.grad.abs().max()))


@pytest.mark.cuda
def test_card_backward_never_falls_back_to_plain(cuda, monkeypatch):
    ang, x = _inputs(4, 6, 3, 2)
    pr, pi, mats = _torch_args(ang, x, cuda)
    mats.requires_grad_(True)
    sr, si = gate_kernel.gate_chain_planes(pr, pi, mats, 2, 4)

    def no_plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    monkeypatch.setattr(gate_kernel, "gate_chain_bwd_plain", no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        (sr.sum() + si.sum()).backward()


@pytest.mark.cuda
def test_bwd_kernel_rejects_unsupported_inputs(cuda):
    args, _ = _bwd_args(4, 6, 3, 2, cuda)
    with pytest.raises(ValueError, match="float32"):
        gate_kernel._gate_chain_bwd_cuda(*args[:6], args[6].double(),
                                         args[7], 2, 4)
    with pytest.raises(ValueError, match="float32"):
        gate_kernel._gate_chain_bwd_cuda(*args[:6], args[6].T.contiguous().T,
                                         args[7], 2, 4)
    with pytest.raises(ValueError, match="same CUDA device"):
        gate_kernel._gate_chain_bwd_cuda(*args[:7], args[7].cpu(), 2, 4)
    with pytest.raises(ValueError, match="bad shapes"):
        gate_kernel._gate_chain_bwd_cuda(*args[:6],
                                         args[6][:, :3].contiguous(),
                                         args[7][:, :3].contiguous(), 2, 4)


@pytest.mark.cuda
def test_card_never_falls_back_to_plain(cuda, monkeypatch):
    ang, x = _inputs(4, 6, 3, 2)
    args = _torch_args(ang, x, cuda)

    def no_plain(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    def broken_build():
        raise RuntimeError("build failed")

    monkeypatch.setattr(gate_kernel, "gate_chain_planes_plain", no_plain)
    monkeypatch.setattr(gate_kernel, "_LIB", None)
    monkeypatch.setattr(gate_kernel, "build_library", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        gate_kernel.gate_chain_planes(*args, 2, 4)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_inputs(cuda):
    ang, x = _inputs(4, 6, 3, 2)
    pr, pi, mats = _torch_args(ang, x, cuda)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(2, 4, pr.device)
    with pytest.raises(ValueError, match="float32"):
        gate_kernel._gate_chain_cuda(pr.double(), pi, g8, signs, 2, 4)
    with pytest.raises(ValueError, match="float32"):
        gate_kernel._gate_chain_cuda(pr.T.contiguous().T, pi, g8, signs,
                                     2, 4)
    ang11, x11 = _inputs(11, 2, 1, 2)
    with pytest.raises(ValueError, match="1..10 wires"):
        gate_kernel.gate_chain_planes(*_torch_args(ang11, x11, cuda), 2, 11)
