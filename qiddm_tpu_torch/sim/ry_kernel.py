"""The RY-encoded re-uploading chain and its adjoint backward: hand-written
CUDA kernels and their plain PyTorch versions (counterpart of
``qiddm_tpu/sim/pallas_gate_kernel.py``: ``ry_chain_planes``,
``_ry_fwd_kernel``, ``_ry_bwd_kernel``).

The chain of ``gate_kernel.py`` with another encode: at every k-th layer a
per-sample RY(x_j) on each wire j instead of an RZ phase plane (the
``QIDDM_PL_noise1`` family). The encode enters as ``cs``, the (2w, B)
float32 cosines (rows 0..w-1) and sines (rows w..2w-1) of x/2.

``ry_chain_planes`` is the entry the engine calls. It runs the ``_RyChain``
autograd Function, which picks the path by the device of its input, in the
forward and in the backward pass alike: a CPU tensor runs the plain versions
(:func:`ry_chain_planes_plain`, :func:`ry_chain_bwd_plain`); a CUDA tensor
launches the kernels of ``csrc/ry_chain.cu`` or raises. Nothing falls back
from a kernel to its plain version. The forward goes through the operator
``qiddm::ry_chain`` (``sim/ops.py``). The kernels are built into the one
library of ``gate_kernel.py``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import gate_kernel as _gk
from .gate_kernel import (_ADJ_ORDER, _ADJ_SIGNS, _gate_apply, _plane_dg,
                          _sign_planes_on, _to_g8, chain_bwd_plan)

# Kernel launches since the last reset, forward and backward; chip_smoke.py
# reads them to show that the QIDDM_PL_noise1 paths went through the kernels.
# RY_BWD_BATCH_SUMS counts the backward calls whose batch did not fit one
# cluster (gate_kernel.chain_bwd_plan), so that a second launch summed dg.
RY_LAUNCHES = 0
RY_BWD_LAUNCHES = 0
RY_BWD_BATCH_SUMS = 0


def ry_cs(angles: torch.Tensor) -> torch.Tensor:
    """(B, wires) angles -> the (2w, B) float32 ``cat(cos(x/2), sin(x/2))``
    the kernels take."""
    half = (0.5 * angles).to(torch.float32).T
    return torch.cat([torch.cos(half), torch.sin(half)]).contiguous()


# --- plain PyTorch version ---------------------------------------------------

def _split(planes, j: int):
    """(d, B) -> (2^j, 2, d / 2^(j+1), B): halves [:, 0] and [:, 1] hold the
    rows whose wire-j bit is 0 and 1."""
    d, B = planes.shape
    return planes.reshape(2**j, 2, d // 2 ** (j + 1), B)


def _ry_apply(sr, si, c, s, j: int):
    """RY with per-sample real coefficients ``c``, ``s`` (each (B,)) on wire
    j of (d, B) planes: ``[[c, -s], [s, c]]``; passing ``-s`` applies its
    adjoint."""
    out = []
    for p in (sr, si):
        v = _split(p, j)
        v0, v1 = v[:, 0], v[:, 1]
        out.append(torch.stack([c * v0 - s * v1, s * v0 + c * v1],
                               dim=1).reshape(p.shape))
    return out[0], out[1]


def _ry_dcs(cr, ci, sr, si, j: int):
    """Per-sample gradient of the encode gate on wire j, from the
    output-side cotangent and the gate's input state: ``(dc, ds)``, each
    (B,), with ``dc`` the sum over rows of ``ct . v_own`` and ``ds`` that of
    ``+-ct . v_partner`` (+ where the wire bit is 1)."""
    c_r, c_i = _split(cr, j), _split(ci, j)
    s_r, s_i = _split(sr, j), _split(si, j)
    dc = (cr * sr + ci * si).sum(dim=0)
    ds = ((c_r[:, 1] * s_r[:, 0] + c_i[:, 1] * s_i[:, 0])
          - (c_r[:, 0] * s_r[:, 1] + c_i[:, 0] * s_i[:, 1])).sum(dim=(0, 1))
    return dc, ds


def _ry_plain(cs, g8, signs, k: int, wires: int):
    """The forward chain on packed gates, in plain PyTorch."""
    d, B = 2**wires, cs.shape[1]
    sr = cs.new_zeros((d, B))
    sr[0] = 1.0
    si = cs.new_zeros((d, B))
    for l in range(g8.shape[0]):
        if l % k == 0:
            for j in range(wires):
                sr, si = _ry_apply(sr, si, cs[j], cs[wires + j], j)
        for j in range(wires):
            sr, si = _gate_apply(sr, si, g8[l, j], j)
        sg = signs[l % k]
        sr, si = sr * sg, si * sg
    return sr, si


def ry_chain_planes_plain(angles, rot_mats, k: int, wires: int):
    """The chain in plain PyTorch, on any device: same arguments and
    results as :func:`ry_chain_planes`."""
    return _ry_plain(ry_cs(angles), _to_g8(rot_mats),
                     _sign_planes_on(k, wires, angles.device), k, wires)


def ry_chain_bwd_plain(cs, g8, signs, fr, fi, gr, gi, k: int, wires: int):
    """The adjoint reverse walk in plain PyTorch, on any device.

    From the forward output ``(fr, fi)`` and its cotangent ``(gr, gi)``
    (all (d, B) float32), rebuild each layer's state through the inverse
    gates and return ``(dcs, dg)``: the (2w, B) gradient of ``cs``, summed
    over the L re-uploads, and the (L*k, wires, 8) packed gate gradient."""
    n_layers = g8.shape[0]
    adj = g8[..., _ADJ_ORDER] * g8.new_tensor(_ADJ_SIGNS)
    sr, si, cr, ci = fr, fi, gr, gi
    dcs = torch.zeros_like(cs)
    dg = [[None] * wires for _ in range(n_layers)]
    for l in range(n_layers - 1, -1, -1):
        sg = signs[l % k]  # CZ is self-inverse
        sr, si, cr, ci = sr * sg, si * sg, cr * sg, ci * sg
        for j in range(wires - 1, -1, -1):
            sr, si = _gate_apply(sr, si, adj[l, j], j)  # the gate's input
            dg[l][j] = _plane_dg(cr, ci, sr, si, j)
            cr, ci = _gate_apply(cr, ci, adj[l, j], j)
        if l % k == 0:
            rows = [None] * (2 * wires)
            for j in range(wires - 1, -1, -1):
                c, s = cs[j], cs[wires + j]
                sr, si = _ry_apply(sr, si, c, -s, j)  # the encode's input
                rows[j], rows[wires + j] = _ry_dcs(cr, ci, sr, si, j)
                cr, ci = _ry_apply(cr, ci, c, -s, j)
            dcs = dcs + torch.stack(rows)
    return dcs, torch.stack([torch.stack(row) for row in dg])


# --- CUDA kernel -------------------------------------------------------------

def _ry_chain_cuda(cs, g8, signs, k: int, wires: int):
    """Launch the forward kernel on PyTorch's current stream, laid out by
    ``gate_kernel.chain_fwd_plan``; (sr, si) are new (d, B) float32
    tensors."""
    global RY_LAUNCHES
    _, B, n_layers = _gk._check_cuda_inputs(
        "RY-chain kernel", (cs,), g8, signs, (k, 2**wires, 1), wires,
        rows=2 * wires)
    lib = _gk._library()
    plan = _gk.chain_fwd_plan(wires, B)
    _gk._check_smem(lib.ry_chain_fwd_smem_bytes(wires, n_layers, k,
                                                plan.samples),
                    n_layers, wires)
    sr = torch.empty((2**wires, B), dtype=torch.float32, device=cs.device)
    si = torch.empty_like(sr)
    stream = torch.cuda.current_stream(cs.device).cuda_stream
    err = lib.ry_chain_fwd(cs.data_ptr(), g8.data_ptr(), signs.data_ptr(),
                           sr.data_ptr(), si.data_ptr(), wires, B, n_layers,
                           k, plan.samples, plan.grid, cs.device.index,
                           stream)
    _gk._raise_on(err, lib, "RY-chain kernel")
    RY_LAUNCHES += 1
    return sr, si


def _ry_chain_bwd_cuda(cs, g8, signs, fr, fi, gr, gi, k: int, wires: int):
    """Launch the backward kernel on PyTorch's current stream, laid out by
    ``gate_kernel.chain_bwd_plan`` (and, for a batch larger than one
    cluster, the fixed-order sum of the clusters' dg); returns new (dcs, dg)
    as :func:`ry_chain_bwd_plain` does."""
    global RY_BWD_LAUNCHES, RY_BWD_BATCH_SUMS
    what = "RY-chain backward kernel"
    _, B, n_layers = _gk._check_cuda_inputs(
        what, (fr, fi, gr, gi), g8, signs, (k, 2**wires, 1), wires)
    _gk._check_cuda_inputs(what, (cs,), g8, signs, (k, 2**wires, 1), wires,
                           rows=2 * wires)
    if cs.shape[1] != B or cs.device != fr.device:
        raise ValueError(f"{what}: cs {tuple(cs.shape)} on {cs.device} does "
                         f"not fit planes of batch {B} on {fr.device}")
    lib = _gk._library()
    plan = chain_bwd_plan(wires, B)
    _gk._check_smem(lib.ry_chain_bwd_smem_bytes(wires, n_layers, k,
                                                plan.samples),
                    n_layers, wires)
    dg = torch.empty_like(g8)
    dg_part = dg if plan.in_launch else torch.empty(
        (plan.clusters, n_layers, wires, 8), dtype=torch.float32,
        device=cs.device)
    dcs = torch.empty_like(cs)
    stream = torch.cuda.current_stream(cs.device).cuda_stream
    err = lib.ry_chain_bwd(cs.data_ptr(), g8.data_ptr(), signs.data_ptr(),
                           fr.data_ptr(), fi.data_ptr(), gr.data_ptr(),
                           gi.data_ptr(), dg_part.data_ptr(), dg.data_ptr(),
                           dcs.data_ptr(), wires, B, n_layers, k,
                           plan.samples, plan.cluster, plan.clusters,
                           cs.device.index, stream)
    _gk._raise_on(err, lib, what)
    RY_BWD_LAUNCHES += 1
    if not plan.in_launch:
        RY_BWD_BATCH_SUMS += 1
    return dcs, dg


class _RyChain(torch.autograd.Function):
    """``(cs, g8) -> (sr, si)`` on real float32 tensors, so autograd carries
    ``dcs`` back through the cosines and sines to the angles (the first
    block's output, in a model of N blocks) and ``dg`` to the complex
    rotations. Saves ``(cs, g8, sr, si)``, as ``_ry_chain_fwd`` does on the
    TPU; the backward rebuilds the states from the output."""

    @staticmethod
    def forward(ctx, cs, g8, k: int, wires: int):
        sr, si = torch.ops.qiddm.ry_chain.default(cs, g8, k, wires)
        ctx.save_for_backward(cs, g8, sr, si)
        ctx.k, ctx.wires = k, wires
        return sr, si

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        cs, g8, fr, fi = ctx.saved_tensors
        k, wires = ctx.k, ctx.wires
        # readouts hand back transposed views; an unused output gives None
        gr = torch.zeros_like(fr) if gr is None else gr.contiguous()
        gi = torch.zeros_like(fi) if gi is None else gi.contiguous()
        signs = _sign_planes_on(k, wires, cs.device)
        if cs.device.type == "cuda":
            dcs, dg = _ry_chain_bwd_cuda(cs, g8, signs, fr, fi, gr, gi, k,
                                         wires)
        else:
            dcs, dg = ry_chain_bwd_plain(cs, g8, signs, fr, fi, gr, gi, k,
                                         wires)
        return dcs, dg, None, None


def ry_chain_planes(angles, rot_mats, k: int, wires: int):
    """Plane-level RY-encoded re-uploading chain from |0...0>.

    angles: (B, wires) real, RY-encoded before layers 0, k, 2k, ...;
    rot_mats: (L*k, wires, 2, 2) complex per-wire rotations; the CZ ring
    after each layer uses range ``sel_ranges(k, wires)[l % k]``. Returns the
    state planes ``(sr, si)``, each (d, B) float32.

    Differentiable in ``angles`` and ``rot_mats``: the backward runs the
    adjoint kernel on a CUDA tensor, its plain version on a CPU one.
    """
    if angles.shape[-1] != wires:
        raise ValueError(f"angles of {angles.shape[-1]} columns do not fit "
                         f"{wires} wires")
    if angles.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no RY-chain path for device {angles.device}")
    return _RyChain.apply(ry_cs(angles), _to_g8(rot_mats), k, wires)


def ry_chain(angles, rot_mats, k: int, wires: int):
    """:func:`ry_chain_planes` returning (B, d) complex64 states, as
    ``ry_chain_pallas`` does."""
    sr, si = ry_chain_planes(angles, rot_mats, k, wires)
    return torch.complex(sr, si).T
