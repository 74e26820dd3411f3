"""The arithmetic of the wide chain's tensor-core kernels (#11/#12,
``qiddm_tpu_torch/csrc/wide_chain.cu``) emulated on the CPU in plain torch
float32, and held to the plain chain and to the JAX package's wide chain.

The kernels split every operand x into TF32 hi = tf32(x) and
lo = tf32(x - hi) (round to nearest, ties away from zero) and sum a b as
a_lo b_hi + a_hi b_lo + a_hi b_hi in float32 (3xTF32). Here every group
product and every dG product of the plain chain
(``wide_kernel._group_apply``, ``wide_kernel._group_dg``) runs that way;
the RZ phase and the ring signs are the same float32 multiplies as in the
kernels. The emulated chain must stay within the card's tolerances of the
plain version (``chip_smoke.py``: 1e-5 absolute on the state, 2e-5 of
max(1, max|plain|) on dpr, dpi and each dG) and within the JAX package's
own tolerances of its XLA grouped chain (1e-5 on the states, 2e-5 on the
gradients, ``tests/test_wide_kernel.py``), at (w, B, L*k) = (13, 10, 28),
whose groups (7, 6) reach D = 128, and (16, 10, 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu import config as jconfig
from qiddm_tpu.sim import wide as jwide
from qiddm_tpu_torch.sim import gate_kernel, wide, wide_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix
from qiddm_tpu_torch.sim.statevector import rz_phase_planes

KERNEL_TOL = 1e-5
WIDE_BWD_TOL = 2e-5
STATE_TOL = 1e-5
GRAD_TOL = 2e-5
SHAPES = [(13, 10, 28), (16, 10, 4)]  # (w, B, L*k) at k = 2


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: cvt.rna.tf32.f32 on the card."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: the small terms, then the large, summed in
    float32 (each TF32 product is exact in float32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _group_apply_3xtf32(sr, si, gr, gi, off: int, size: int):
    """``wide_kernel._group_apply`` with the kernels' products."""
    d, B = sr.shape
    shape = (2**off, 2**size, -1)
    vr, vi = sr.reshape(shape), si.reshape(shape)
    out_r = _mm3(gr, vr) - _mm3(gi, vi)
    out_i = _mm3(gi, vr) + _mm3(gr, vi)
    return out_r.reshape(d, B), out_i.reshape(d, B)


def _group_dg_3xtf32(cr, ci, sr, si, off: int, size: int):
    """``wide_kernel._group_dg`` with the kernels' products."""
    shape = (2**off, 2**size, -1)
    c_r, c_i = cr.reshape(shape), ci.reshape(shape)
    t_r = sr.reshape(shape).transpose(1, 2)
    t_i = si.reshape(shape).transpose(1, 2)
    return ((_mm3(c_r, t_r) + _mm3(c_i, t_i)).sum(0),
            (_mm3(c_i, t_r) - _mm3(c_r, t_i)).sum(0))


@pytest.fixture
def tf32_products(monkeypatch):
    monkeypatch.setattr(wide_kernel, "_group_apply", _group_apply_3xtf32)
    monkeypatch.setattr(wide_kernel, "_group_dg", _group_dg_3xtf32)


def test_tf32_split_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-11  # halfway between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 2.0**-12, 3.0], dtype=torch.float32)
    want = [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 3.0]
    assert _tf32(x).tolist() == want
    y = torch.as_tensor(np.random.default_rng(0).normal(size=4096),
                        dtype=torch.float32)
    hi = _tf32(y)
    lo = _tf32(y - hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi + lo - y).abs() <= 2.0**-22 * y.abs()).all()


def _plain_inputs(w, B, n):
    rng = np.random.default_rng(w)
    ang = torch.as_tensor(rng.normal(size=(n, w, 3)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(2**w, B)), dtype=torch.float32)
    mats = rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2])
    gplanes = wide_kernel._planes_of(
        wide.group_gates(mats, wide.group_sizes(w)))
    gr, gi = (torch.as_tensor(rng.normal(size=(2**w, B)),
                              dtype=torch.float32) for _ in range(2))
    return torch.cos(x), torch.sin(x), gplanes, gr, gi


def _chain_and_bwd(pr, pi, gplanes, gr, gi, w):
    signs = gate_kernel._sign_planes_on(2, w, pr.device)
    fr, fi = wide_kernel._chain_plain(pr, pi, gplanes, signs, 2, w)
    dpr, dpi, dg = wide_kernel.wide_chain_bwd_plain(pr, pi, gplanes, fr, fi,
                                                    gr, gi, 2, w)
    return (fr, fi), (dpr, dpi, *dg)


@pytest.mark.parametrize("w,B,n", SHAPES)
def test_3xtf32_chain_holds_the_plain_chain(monkeypatch, w, B, n):
    args = _plain_inputs(w, B, n)
    with torch.no_grad():
        want_f, want_b = _chain_and_bwd(*args, w)
        monkeypatch.setattr(wide_kernel, "_group_apply", _group_apply_3xtf32)
        monkeypatch.setattr(wide_kernel, "_group_dg", _group_dg_3xtf32)
        got_f, got_b = _chain_and_bwd(*args, w)
    err = max((g - q).abs().max().item() for g, q in zip(got_f, want_f))
    assert err <= KERNEL_TOL, err
    for g, q in zip(got_b, want_b):
        rel = (g - q).abs().max().item() / max(1.0, q.abs().max().item())
        assert rel <= WIDE_BWD_TOL, rel


def _jax_run(x, wq):
    """Final states and (x, weights) gradients of a weighted probability
    sum through the JAX package's XLA grouped chain."""
    def loss(x, wq):
        st = jwide.reupload_chain_wide(x, wq, encode="rz", imprimitive="cz")
        p = jnp.real(st) ** 2 + jnp.imag(st) ** 2
        return jnp.sum(p * jnp.linspace(0.0, 1.0, 2**x.shape[1])), st

    (_, st), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                        has_aux=True)(jnp.asarray(x),
                                                      jnp.asarray(wq))
    return np.asarray(st), [np.asarray(g) for g in grads]


def _torch_run(x, wq):
    """The same through the port's plane entry on CPU tensors."""
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(wq).requires_grad_(True)
    L, k, w, _ = wq.shape
    flat = wt.reshape(L * k, w, 3)
    mats = rot_matrix(flat[..., 0], flat[..., 1], flat[..., 2])
    pr, pi = rz_phase_planes(xt, w)
    sr, si = wide_kernel.wide_chain_planes(pr, pi, mats, k, w)
    st = torch.complex(sr, si).T
    p = st.real ** 2 + st.imag ** 2
    (p * torch.linspace(0.0, 1.0, 2**w)).sum().backward()
    return st.detach().numpy(), [xt.grad.numpy(), wt.grad.numpy()]


@pytest.fixture
def xla_chain():
    """The JAX package's wide route on its XLA grouped chain (no Pallas
    kernel), restored after the test."""
    prev = (jconfig.wide_mode(), jconfig.wide_kernel_mode())
    jconfig.set_wide_mode("on")
    jconfig.set_wide_kernel_mode("off")
    yield
    jconfig.set_wide_mode(prev[0])
    jconfig.set_wide_kernel_mode(prev[1])


@pytest.mark.parametrize("w,B,n", SHAPES)
def test_3xtf32_chain_holds_the_jax_chain(xla_chain, tf32_products, w, B,
                                          n):
    rng = np.random.default_rng(w + 1)
    x = (rng.normal(size=(B, w)) * 0.7).astype(np.float32)
    wq = (rng.normal(size=(n // 2, 2, w, 3)) * 0.4).astype(np.float32)
    st_j, g_j = _jax_run(x, wq)
    st_t, g_t = _torch_run(x, wq)
    np.testing.assert_allclose(st_t, st_j, atol=STATE_TOL)
    for got, want in zip(g_t, g_j):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL)
