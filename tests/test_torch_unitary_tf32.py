"""The arithmetic of the unitary-streaming chain's tensor-core forward (#13,
``qiddm_tpu_torch/csrc/unitary_chain.cu``) emulated on the CPU in plain
torch float32, and held to the plain chain and to the JAX package's Pallas
kernel in interpret mode.

A layer of the kernel is one complex product s <- U_l s over the whole
batch. Its 8 warps split the product's depth into runs of 8-deep steps
(``unitary_kernel.unitary_plan``: ``steps_per_warp`` steps for each of
``warps`` warps). Each step splits every operand x into TF32 hi = tf32(x)
and lo = tf32(x - hi) (round to nearest, ties away from zero) and runs
``wide_common.cuh::cmma_step``: the small terms (a_lo b_hi + a_hi b_lo of
the four real products) accumulate over the warp's steps, each large term
(a_hi b_hi) is summed from zero and added to the warp's float32 sum; the
warp adds its small terms at the end, and the warps' partials are summed
in warp order. The phase of a block start multiplies the layer's output in
float32. The emulation must stay within 1e-5 of the plain chain and of
``fused_reupload_chain(..., interpret=True)`` (the card's ``KERNEL_TOL``)
at the route's two timed shapes, (w, B, L*k) = (8, 80, 28) and
(6, 16, 28), with both rings.

The adjoint walk #14 runs on the same units: each layer one product of
U_l^H (real part ur^T, imaginary part -ui^T, split as the forward splits
U) with the state and the cotangent side by side, [s | c], its depth
split among ``unitary_bwd_plan``'s warps and their partials summed in
warp order; the phase undone and its gradient accumulated in float32.
dU_l = C_l T_l^H is one product over the batch (padded with zero samples
to the plan's ``ws_samples``) in 8-deep steps in increasing order, each
large term summed from zero and added in float32. The emulation must stay
within 1e-5 of max(1, max|reference|) (the card's ``BWD_TOL``) of
``unitary_chain_bwd_plain`` and of the JAX package's ``_fused_bwd`` in
interpret mode, on the same output and cotangent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiddm_tpu.sim.pallas_kernels import fused_reupload_chain
from qiddm_tpu_torch.sim import sel as tsel
from qiddm_tpu_torch.sim import unitary_kernel
from qiddm_tpu_torch.sim.statevector import rz_phase_planes

TOL = 1e-5
SHAPES = [(8, 80, 14, 2), (6, 16, 14, 2)]  # (w, B, L, k): L*k = 28
RINGS = ("cz", "cnot")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: cvt.rna.tf32.f32 on the card."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _layer_3xtf32(ur, ui, sr, si, warps: int, per_warp: int):
    """(ur + i ui)(sr + i si) as the kernel's warps form it."""
    depth = ur.shape[1]
    out_r = torch.zeros(ur.shape[0], sr.shape[1])
    out_i = torch.zeros_like(out_r)
    for w in range(warps):
        cr, ci = torch.zeros_like(out_r), torch.zeros_like(out_r)
        small_r, small_i = torch.zeros_like(out_r), torch.zeros_like(out_r)
        for s in range(per_warp):
            k0 = (w * per_warp + s) * 8
            if k0 >= depth:
                break
            cols = slice(k0, k0 + 8)
            ah, al = _split(ur[:, cols])
            qh, ql = _split(ui[:, cols])          # ai; nai = -ai
            bh, bl = _split(sr[cols])
            ch, cl = _split(si[cols])
            small_r += al @ bh + ah @ bl - ql @ ch - qh @ cl
            small_i += ql @ bh + qh @ bl + al @ ch + ah @ cl
            cr = cr + ah @ bh + (-qh) @ ch
            ci = ci + qh @ bh + ah @ ch
        out_r = out_r + (cr + small_r)
        out_i = out_i + (ci + small_i)
    return out_r, out_i


def chain_3xtf32(pr, pi, ur, ui, k: int):
    """The forward of kernel #13 with its 3xTF32 products, on the CPU."""
    d, B = pr.shape
    plan = unitary_kernel.unitary_plan(d.bit_length() - 1, B)
    sr = torch.zeros_like(pr)
    si = torch.zeros_like(pi)
    sr[0], si[0] = pr[0], pi[0]  # |0...0> times the layer-0 phase
    for l in range(ur.shape[0]):
        if l and l % k == 0:
            sr, si = sr * pr - si * pi, sr * pi + si * pr
        sr, si = _layer_3xtf32(ur[l], ui[l], sr, si, plan.warps,
                               plan.steps_per_warp)
    return sr, si


def bwd_3xtf32(pr, pi, ur, ui, fr, fi, gr, gi, k: int):
    """The backward of kernel #14 with its 3xTF32 products, on the CPU:
    (dpr, dpi, dur, dui) as ``unitary_chain_bwd_plain`` returns them."""
    d, B = pr.shape
    plan = unitary_kernel.unitary_bwd_plan(d.bit_length() - 1, B)
    pad = plan.ws_samples - B
    sr, si, cr, ci = fr, fi, gr, gi
    dpr = torch.zeros_like(pr)
    dpi = torch.zeros_like(pi)
    dur = torch.empty_like(ur)
    dui = torch.empty_like(ui)
    for l in range(ur.shape[0] - 1, -1, -1):
        # one product of U_l^H with [s | c]: one split of each A operand
        out_r, out_i = _layer_3xtf32(
            ur[l].T, -ui[l].T, torch.cat([sr, cr], 1), torch.cat([si, ci], 1),
            plan.warps, plan.steps_per_warp)
        tr, ti, nr, ni = out_r[:, :B], out_i[:, :B], out_r[:, B:], out_i[:, B:]
        # dU_l = C_l T_l^H over the zero-padded batch, one run of steps
        zeros = torch.zeros(d, pad)
        c_r, c_i, t_r, t_i = (torch.cat([x, zeros], 1)
                              for x in (cr, ci, tr, ti))
        dur[l], dui[l] = _layer_3xtf32(c_r, c_i, t_r.T, -t_i.T, 1,
                                       plan.ws_samples // 8)
        if l % k == 0:
            sr, si = tr * pr + ti * pi, ti * pr - tr * pi
            dpr = dpr + nr * sr + ni * si
            dpi = dpi + ni * sr - nr * si
            cr, ci = nr * pr + ni * pi, ni * pr - nr * pi
        else:
            sr, si, cr, ci = tr, ti, nr, ni
    return dpr, dpi, dur, dui


def _bwd_inputs(w, B, L, k, ring, seed=0):
    """(pr, pi, ur, ui, fr, fi, gr, gi): the plain chain's output and
    N(0, 1) cotangents from numpy."""
    pr, pi, ur, ui = _inputs(w, B, L, k, ring, seed)
    fr, fi = unitary_kernel.unitary_chain_planes_plain(pr, pi, ur, ui, k)
    cot = np.random.default_rng(seed + 1).normal(size=(2, 2**w, B))
    gr, gi = (torch.as_tensor(c, dtype=torch.float32) for c in cot)
    return pr, pi, ur, ui, fr, fi, gr, gi


def _rel(got, want) -> float:
    want = np.asarray(want)
    return (np.abs(np.asarray(got) - want).max()
            / max(1.0, np.abs(want).max()))


def _inputs(w, B, L, k, ring, seed=0):
    rng = np.random.default_rng(seed)
    weights = (rng.normal(size=(L, k, w, 3)) * 0.4).astype(np.float32)
    x = rng.normal(size=(B, w)).astype(np.float32)
    pr, pi = rz_phase_planes(torch.as_tensor(x), w)
    lus = tsel.sel_layer_unitaries(torch.as_tensor(weights),
                                   ring).reshape(L * k, 2**w, 2**w)
    return pr, pi, lus.real.contiguous(), lus.imag.contiguous()


def test_tf32_split_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-11  # halfway between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 2.0**-12, 3.0], dtype=torch.float32)
    hi, lo = _split(x)
    assert hi.tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 3.0]
    assert (hi + lo).tolist() == x.tolist()


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("w,B,L,k", SHAPES)
def test_emulated_kernel_matches_plain_and_pallas(w, B, L, k, ring):
    pr, pi, ur, ui = _inputs(w, B, L, k, ring)
    er, ei = chain_3xtf32(pr, pi, ur, ui, k)
    qr, qi = unitary_kernel.unitary_chain_planes_plain(pr, pi, ur, ui, k)
    assert (er - qr).abs().max().item() <= TOL
    assert (ei - qi).abs().max().item() <= TOL
    jr, ji = fused_reupload_chain(
        *(jnp.asarray(t.numpy().T) for t in (pr, pi)),
        jnp.asarray(ur.numpy()), jnp.asarray(ui.numpy()), k, True)
    np.testing.assert_allclose(er.numpy(), np.asarray(jr).T, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(ei.numpy(), np.asarray(ji).T, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("w,B,L,k", SHAPES)
def test_emulation_is_not_the_float32_chain(w, B, L, k):
    """The split matters: one TF32 product (hi terms only) drifts well past
    the tolerance, so the 1e-5 agreement above is the 3xTF32 sum's."""
    pr, pi, ur, ui = _inputs(w, B, L, k, "cnot")
    sr = torch.zeros_like(pr)
    si = torch.zeros_like(pi)
    sr[0], si[0] = pr[0], pi[0]
    for l in range(ur.shape[0]):
        if l and l % k == 0:
            sr, si = sr * pr - si * pi, sr * pi + si * pr
        a, q, b, c = (_tf32(t) for t in (ur[l], ui[l], sr, si))
        sr, si = a @ b - q @ c, q @ b + a @ c
    qr, qi = unitary_kernel.unitary_chain_planes_plain(pr, pi, ur, ui, k)
    assert max((sr - qr).abs().max().item(),
               (si - qi).abs().max().item()) > 10 * TOL


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("w,B,L,k", SHAPES)
def test_emulated_bwd_matches_plain_and_pallas(w, B, L, k, ring):
    from qiddm_tpu.sim.pallas_kernels import _fused_bwd

    args = _bwd_inputs(w, B, L, k, ring)
    got = bwd_3xtf32(*args, k)
    want = unitary_kernel.unitary_chain_bwd_plain(*args, k)
    for g, q in zip(got, want):
        assert _rel(g.numpy(), q.numpy()) <= TOL
    pr, pi, ur, ui, fr, fi, gr, gi = (jnp.asarray(t.numpy()) for t in args)
    jdpr, jdpi, jdur, jdui = _fused_bwd(
        k, True, (pr.T, pi.T, ur, ui, fr.T, fi.T), (gr.T, gi.T))
    for g, q in zip(got, (jdpr.T, jdpi.T, jdur, jdui)):
        assert _rel(g.numpy(), q) <= TOL


@pytest.mark.parametrize("w,B,L,k", SHAPES)
def test_emulated_bwd_is_not_the_float32_walk(w, B, L, k):
    """One TF32 product a layer (hi terms only) drifts well past the
    tolerance, so the agreement above is the 3xTF32 sums'."""
    pr, pi, ur, ui, fr, fi, gr, gi = _bwd_inputs(w, B, L, k, "cnot")
    sr, si, cr, ci = fr, fi, gr, gi
    dur = torch.empty_like(ur)
    for l in range(ur.shape[0] - 1, -1, -1):
        a, q = _tf32(ur[l].T), _tf32(ui[l].T)
        b, c, e, f = (_tf32(t) for t in (sr, si, cr, ci))
        tr, ti = a @ b + q @ c, a @ c - q @ b
        dur[l] = _tf32(cr) @ _tf32(tr).T + _tf32(ci) @ _tf32(ti).T
        nr, ni = a @ e + q @ f, a @ f - q @ e
        if l % k == 0:
            sr, si = tr * pr + ti * pi, ti * pr - tr * pi
            cr, ci = nr * pr + ni * pi, ni * pr - nr * pi
        else:
            sr, si, cr, ci = tr, ti, nr, ni
    want = unitary_kernel.unitary_chain_bwd_plain(pr, pi, ur, ui, fr, fi, gr,
                                                  gi, k)[2]
    assert _rel(dur.numpy(), want.numpy()) > 10 * TOL
