"""The SEL chain and its adjoint backward: hand-written CUDA kernels and
their plain PyTorch versions (counterpart of
``qiddm_tpu/sim/pallas_gate_kernel.py``: ``sel_chain_pallas``,
``_sel_fwd_kernel``, ``_sel_bwd_kernel``).

StronglyEntanglingLayers of ``depth`` layers on an arbitrary batch of start
states (amplitude embeddings for Qdense, RZ-phased |0...0> for QNN): per
layer a 2x2 gate on every wire, then a CZ or CNOT ring whose range cycles
over the full depth, ``r_l = l % (wires-1) + 1``.

Two entries, one per layout of the states:

* ``sel_chain_planes``, the engine's (QNN/Qdense chains, the two-sided dm
  route), on (d, B) float32 planes: the ``_SelChain`` autograd Function,
  kernels ``sel_chain_fwd_regs_kernel<w>`` and ``sel_chain_bwd_regs_kernel<w>``
  (``csrc/chain_regs.cuh``'s register layout, launched as
  :func:`sel_fwd_plan` and :func:`sel_bwd_plan` lay them out);
* ``sel_chain_rows``, the trajectory backend's, on (N, d) complex64 rows as
  ``sel_chain_pallas`` takes them: the ``_SelRows`` Function, whose forward
  is ``sel_rows_fwd_kernel`` on the rows in place of any transpose, and
  whose backward transposes to planes and runs the planes' adjoint kernel
  (the trajectory samplers run under ``no_grad``). The JAX package serves
  this route at 11-12 wires with ``sel_chain_pallas_tiled`` (one
  ``sel_chain_pallas`` call per 128-lane chunk of the batch); on the card
  the whole batch is one launch.

Each Function picks the path by the device of its input, in the forward and
in the backward pass alike: a CPU tensor runs the plain versions
(:func:`sel_chain_planes_plain`, :func:`sel_chain_rows_plain`,
:func:`sel_chain_bwd_plain`); a CUDA tensor launches the kernels of
``csrc/sel_chain.cu`` or raises. Nothing falls back from a kernel to its
plain version; the planes' forward goes through the operator
``qiddm::sel_chain`` (``sim/ops.py``). The kernels are built into the one
library of ``gate_kernel.py`` and take up to ``config.SEL_KERNEL_MAX_WIRES`` (12)
wires.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import config as _config
from . import gate_kernel as _gk
from .gate_kernel import (_ADJ_ORDER, _ADJ_SIGNS, _gate_apply, _pair_update,
                          _plane_dg, _to_g8)
from .sel import cnot_ring_perm, cz_ring_signs

# Kernel launches since the last reset: the planes' forward and backward
# and the rows' forward; chip_smoke.py reads them to show that the
# QNN/Qdense paths and the trajectory route went through the kernels.
# SEL_BWD_BATCH_SUMS counts the backward calls whose batch did not fit one
# cluster (sel_bwd_plan), so that a second launch summed dg.
SEL_LAUNCHES = 0
SEL_BWD_LAUNCHES = 0
SEL_ROW_LAUNCHES = 0
SEL_BWD_BATCH_SUMS = 0

_IMPRIMITIVES = ("cz", "cnot")


def ring_tables(wires: int, imprimitive: str, inverse: bool = False):
    """The ``max(wires-1, 1)`` rings of the chain, one per range ``q + 1``,
    as a (p, d) numpy table: CZ sign planes (float32; self-inverse), or
    CNOT row-gather indices (int32) — ``cnot_ring_perm`` for the forward,
    ``new[i] = old[inv[i]]``, and with ``inverse`` the forward map ``f``
    (``f[inv] = arange``), which undoes it."""
    if imprimitive not in _IMPRIMITIVES:
        raise ValueError(f"unknown imprimitive {imprimitive!r}")
    ranges = [q + 1 for q in range(wires - 1)] if wires > 1 else [0]
    if imprimitive == "cz":
        return np.stack([cz_ring_signs(wires, r) for r in ranges]).astype(
            np.float32)
    tables = []
    for r in ranges:
        inv = cnot_ring_perm(wires, r)
        if inverse:
            f = np.empty_like(inv)
            f[inv] = np.arange(len(inv))
            inv = f
        tables.append(inv)
    return np.stack(tables).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ring_on(wires: int, imprimitive: str, inverse: bool,
             device: torch.device) -> torch.Tensor:
    """:func:`ring_tables` as a tensor on ``device``, copied once."""
    return torch.as_tensor(ring_tables(wires, imprimitive, inverse),
                           device=device)


def ring_columns(wires: int, inverse: bool = False) -> np.ndarray:
    """The CNOT rings' gather maps ``inv`` (:func:`ring_tables`) as linear
    maps over GF(2): a (p, w) int32 table whose column b is ``inv[1 << b]``,
    so that ``inv[i]`` is the XOR of the columns of i's set bits (every
    CNOT is linear, and so is their product). With ``inverse`` the columns
    of the forward map ``f``, which undoes the ring (linear too, as the
    inverse of a linear map): the backward's gather."""
    return np.ascontiguousarray(
        ring_tables(wires, "cnot", inverse)[:, 1 << np.arange(wires)])


@functools.lru_cache(maxsize=None)
def _columns_on(wires: int, device: torch.device,
                inverse: bool = False) -> torch.Tensor:
    return torch.as_tensor(ring_columns(wires, inverse), device=device)


def _ring_plain(sr, si, table, l: int, wires: int, imprimitive: str):
    """Layer l's ring (range ``l % (wires-1) + 1``) on (d, B) planes."""
    if wires == 1:
        return sr, si
    t = table[l % (wires - 1)]
    if imprimitive == "cz":
        return sr * t[:, None], si * t[:, None]
    rows = t.long()
    return sr[rows], si[rows]


# --- plain PyTorch version ---------------------------------------------------

def _sel_plain(sr, si, g8, wires: int, imprimitive: str):
    """The forward chain on packed gates, in plain PyTorch."""
    table = _ring_on(wires, imprimitive, False, sr.device)
    for l in range(g8.shape[0]):
        for j in range(wires):
            sr, si = _gate_apply(sr, si, g8[l, j], j)
        sr, si = _ring_plain(sr, si, table, l, wires, imprimitive)
    return sr, si


def _gate_apply_rows(sr, si, g, j: int):
    """One 2x2 gate on wire j of (N, d) rows: the view
    (N, 2^j, 2, d / 2^(j+1)), its two halves mixed."""
    n, d = sr.shape
    left = 2**j
    vr = sr.reshape(n, left, 2, d // (2 * left))
    vi = si.reshape(n, left, 2, d // (2 * left))
    n0r, n0i, n1r, n1i = _pair_update(g, vr[:, :, 0], vi[:, :, 0],
                                      vr[:, :, 1], vi[:, :, 1])
    return (torch.stack([n0r, n1r], dim=2).reshape(n, d),
            torch.stack([n0i, n1i], dim=2).reshape(n, d))


def _sel_rows_plain(x, g8, wires: int, imprimitive: str):
    """The forward chain on (N, d, 2) float32 rows (complex64 viewed as
    real), in plain PyTorch; returns new (N, d, 2) rows."""
    table = _ring_on(wires, imprimitive, False, x.device)
    sr, si = x[..., 0], x[..., 1]
    for l in range(g8.shape[0]):
        for j in range(wires):
            sr, si = _gate_apply_rows(sr, si, g8[l, j], j)
        if wires > 1:
            t = table[l % (wires - 1)]
            if imprimitive == "cz":
                sr, si = sr * t, si * t
            else:
                rows = t.long()
                sr, si = sr[:, rows], si[:, rows]
    return torch.stack([sr, si], dim=-1)


def sel_chain_planes_plain(sr, si, rot_mats, wires: int,
                           imprimitive: str = "cnot"):
    """The chain in plain PyTorch, on any device: same arguments and
    results as :func:`sel_chain_planes`."""
    return _sel_plain(sr, si, _to_g8(rot_mats), wires, imprimitive)


def sel_chain_bwd_plain(g8, fr, fi, gr, gi, wires: int,
                        imprimitive: str = "cnot"):
    """The adjoint reverse walk in plain PyTorch, on any device.

    From the forward output ``(fr, fi)`` and its cotangent ``(gr, gi)``
    (all (d, B) float32), rebuild each layer's state through the inverse
    ring and the adjoint gates, and return ``(dsr, dsi, dg)``: the (d, B)
    start-state gradients and the (depth, wires, 8) packed gate gradient."""
    depth = g8.shape[0]
    adj = g8[..., _ADJ_ORDER] * g8.new_tensor(_ADJ_SIGNS)
    table = _ring_on(wires, imprimitive, True, fr.device)
    sr, si, cr, ci = fr, fi, gr, gi
    dg = [[None] * wires for _ in range(depth)]
    for l in range(depth - 1, -1, -1):
        sr, si = _ring_plain(sr, si, table, l, wires, imprimitive)
        cr, ci = _ring_plain(cr, ci, table, l, wires, imprimitive)
        for j in range(wires - 1, -1, -1):
            sr, si = _gate_apply(sr, si, adj[l, j], j)  # the gate's input
            dg[l][j] = _plane_dg(cr, ci, sr, si, j)
            cr, ci = _gate_apply(cr, ci, adj[l, j], j)
    return cr, ci, torch.stack([torch.stack(row) for row in dg])


# --- the kernels' launch plans -----------------------------------------------

def sel_fwd_plan(wires: int, batch: int) -> _gk.ChainFwdPlan:
    """The planes' forward's layout for ``batch`` samples at ``wires``
    wires, from the shape alone: the register layout of the gate chains'
    forwards (``gate_kernel.chain_fwd_plan``: a CTA of four warps, 4
    samples up to 7 wires, 2 at 8, 1 from 9), widened to 12 wires, where a
    sample takes 8 (11 wires) or 16 (12) warps, a CTA of its own."""
    if not 1 <= wires <= _config.SEL_KERNEL_MAX_WIRES or batch < 1:
        raise ValueError(f"no SEL forward plan for {wires} wires, batch "
                         f"{batch}")
    return _gk._fwd_layout(wires, batch)


def sel_bwd_plan(wires: int, batch: int) -> _gk.ChainBwdPlan:
    """The planes' adjoint walk's layout for ``batch`` samples at ``wires``
    wires, from the shape alone, as ``gate_kernel.chain_bwd_plan`` lays out
    the gate chains' walks, widened to 12 wires (a sample a CTA from 11): a
    cluster of up to 8 CTAs holds the batch when it can (32 samples up to 7
    wires, 16 at 8-10, 8 from 11) and dg's batch sum ends in the launch;
    past that each cluster writes its sum and a second launch adds them."""
    if not 1 <= wires <= _config.SEL_KERNEL_MAX_WIRES or batch < 1:
        raise ValueError(f"no SEL backward plan for {wires} wires, batch "
                         f"{batch}")
    return _gk._bwd_layout(wires, batch)


# --- CUDA kernel -------------------------------------------------------------

def _cols_shape(wires: int) -> tuple:
    return (max(wires - 1, 1), wires)


def _sel_chain_cuda(sr, si, g8, wires: int, imprimitive: str):
    """Launch the forward kernel on PyTorch's current stream, laid out by
    :func:`sel_fwd_plan`; (or, oi) are new (d, B) float32 tensors."""
    global SEL_LAUNCHES
    cols = _columns_on(wires, sr.device)
    d, B, depth = _gk._check_cuda_inputs(
        "SEL-chain kernel", (sr, si), g8, cols, _cols_shape(wires), wires,
        max_wires=_config.SEL_KERNEL_MAX_WIRES)
    lib = _gk._library()
    plan = sel_fwd_plan(wires, B)
    cz = int(imprimitive == "cz")
    _gk._check_smem(lib.sel_chain_fwd_smem_bytes(wires, depth, plan.samples,
                                                 cz), depth, wires)
    out_r = torch.empty_like(sr)
    out_i = torch.empty_like(si)
    stream = torch.cuda.current_stream(sr.device).cuda_stream
    err = lib.sel_chain_fwd(sr.data_ptr(), si.data_ptr(), g8.data_ptr(),
                            cols.data_ptr(), out_r.data_ptr(),
                            out_i.data_ptr(), wires, B, depth, cz,
                            plan.samples, plan.grid, sr.device.index, stream)
    _gk._raise_on(err, lib, "SEL-chain kernel")
    SEL_LAUNCHES += 1
    return out_r, out_i


def _sel_chain_bwd_cuda(g8, fr, fi, gr, gi, wires: int, imprimitive: str):
    """Launch the backward kernel on PyTorch's current stream, laid out by
    :func:`sel_bwd_plan` (and, for a batch larger than one cluster, the
    fixed-order sum of the clusters' dg); returns new (dsr, dsi, dg) as
    :func:`sel_chain_bwd_plain` does."""
    global SEL_BWD_LAUNCHES, SEL_BWD_BATCH_SUMS
    cols = _columns_on(wires, fr.device, inverse=True)
    d, B, depth = _gk._check_cuda_inputs(
        "SEL-chain backward kernel", (fr, fi, gr, gi), g8, cols,
        _cols_shape(wires), wires, max_wires=_config.SEL_KERNEL_MAX_WIRES)
    lib = _gk._library()
    plan = sel_bwd_plan(wires, B)
    cz = int(imprimitive == "cz")
    _gk._check_smem(lib.sel_chain_bwd_smem_bytes(wires, depth, plan.samples,
                                                 cz), depth, wires)
    dg = torch.empty_like(g8)
    dg_part = dg if plan.in_launch else torch.empty(
        (plan.clusters, depth, wires, 8), dtype=torch.float32,
        device=fr.device)
    dsr = torch.empty_like(fr)
    dsi = torch.empty_like(fi)
    stream = torch.cuda.current_stream(fr.device).cuda_stream
    err = lib.sel_chain_bwd(g8.data_ptr(), cols.data_ptr(), fr.data_ptr(),
                            fi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                            dg_part.data_ptr(), dg.data_ptr(), dsr.data_ptr(),
                            dsi.data_ptr(), wires, B, depth, cz,
                            plan.samples, plan.cluster, plan.clusters,
                            fr.device.index, stream)
    _gk._raise_on(err, lib, "SEL-chain backward kernel")
    SEL_BWD_LAUNCHES += 1
    if not plan.in_launch:
        SEL_BWD_BATCH_SUMS += 1
    return dsr, dsi, dg


def _sel_rows_cuda(x, g8, wires: int, imprimitive: str):
    """Launch the rows kernel on PyTorch's current stream; x is (N, d, 2)
    float32 (complex64 rows viewed as real); returns new rows alike."""
    global SEL_ROW_LAUNCHES
    what = "SEL-rows kernel"
    cols = _columns_on(wires, x.device)
    tensors = (x, g8, cols)
    if any(t.device != x.device or t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: every input must be on the same CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if (x.dtype != torch.float32 or g8.dtype != torch.float32
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError(f"{what}: inputs must be contiguous float32, got "
                         f"{[(t.dtype, t.is_contiguous()) for t in tensors]}")
    max_wires = _config.SEL_KERNEL_MAX_WIRES
    if not 1 <= wires <= max_wires:
        raise ValueError(f"{what} takes 1..{max_wires} wires, got {wires}")
    n, depth = x.shape[0], g8.shape[0]
    if (x.shape != (n, 2**wires, 2) or n < 1 or depth < 1
            or g8.shape != (depth, wires, 8)):
        raise ValueError(f"{what}: bad shapes: rows {tuple(x.shape)}, g8 "
                         f"{tuple(g8.shape)} for wires={wires}")
    lib = _gk._library()
    _gk._check_smem(lib.sel_rows_fwd_smem_bytes(wires, n, depth), depth,
                    wires)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.sel_rows_fwd(x.data_ptr(), g8.data_ptr(), cols.data_ptr(),
                           out.data_ptr(), wires, n, depth,
                           int(imprimitive == "cz"), x.device.index, stream)
    _gk._raise_on(err, lib, what)
    SEL_ROW_LAUNCHES += 1
    return out


class _SelChain(torch.autograd.Function):
    """``(sr, si, g8) -> (or, oi)`` on real float32 planes, so autograd
    carries ``dg`` back to the complex rotations through :func:`_to_g8`'s
    ``.real``/``.imag``. Saves ``(g8, or, oi)``, as ``_sel_chain_fwd`` does
    on the TPU; the backward rebuilds the states from the output. In the
    ``setup_context`` form with a generated vmap rule, as ``_GateChain``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(sr, si, g8, wires: int, imprimitive: str):
        return torch.ops.qiddm.sel_chain.default(sr, si, g8, wires,
                                                 imprimitive)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, g8, wires, imprimitive = inputs
        ctx.save_for_backward(g8, *output)
        ctx.wires, ctx.imprimitive = wires, imprimitive

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        g8, fr, fi = ctx.saved_tensors
        # readouts hand back transposed views; an unused output gives None
        gr = torch.zeros_like(fr) if gr is None else gr.contiguous()
        gi = torch.zeros_like(fi) if gi is None else gi.contiguous()
        if fr.device.type == "cuda":
            dsr, dsi, dg = _sel_chain_bwd_cuda(g8, fr, fi, gr, gi, ctx.wires,
                                               ctx.imprimitive)
        else:
            dsr, dsi, dg = sel_chain_bwd_plain(g8, fr, fi, gr, gi, ctx.wires,
                                               ctx.imprimitive)
        return dsr, dsi, dg, None, None


def sel_chain_planes(sr, si, rot_mats, wires: int,
                     imprimitive: str = "cnot"):
    """SEL chain on (d, B) float32 start-state planes.

    rot_mats: (depth, wires, 2, 2) complex per-wire rotations; after layer
    l the ring of range ``l % (wires-1) + 1`` (CZ or CNOT). Returns the
    output planes ``(or, oi)``, each (d, B) float32.

    Differentiable in ``sr``, ``si`` and ``rot_mats``: the backward runs
    the adjoint kernel on a CUDA tensor, its plain version on a CPU one.
    """
    if imprimitive not in _IMPRIMITIVES:
        raise ValueError(f"unknown imprimitive {imprimitive!r}")
    if sr.shape[0] != 2**wires:
        raise ValueError(f"planes of {sr.shape[0]} rows do not hold "
                         f"{wires} wires")
    if sr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SEL-chain path for device {sr.device}")
    return _SelChain.apply(sr.contiguous(), si.contiguous(),
                           _to_g8(rot_mats), wires, imprimitive)


class _SelRows(torch.autograd.Function):
    """``(x, g8) -> out`` on (N, d, 2) float32 rows (complex64 viewed as
    real). Saves ``(g8, out)``; the backward transposes the output and its
    cotangent to (d, N) planes and runs the planes' adjoint walk (kernel
    #6 on a CUDA tensor, :func:`sel_chain_bwd_plain` on a CPU one)."""

    @staticmethod
    def forward(ctx, x, g8, wires: int, imprimitive: str):
        if x.device.type == "cuda":
            out = _sel_rows_cuda(x, g8, wires, imprimitive)
        else:
            out = _sel_rows_plain(x, g8, wires, imprimitive)
        ctx.save_for_backward(g8, out)
        ctx.wires, ctx.imprimitive = wires, imprimitive
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        g8, out = ctx.saved_tensors
        fr, fi, gr, gi = (t[..., c].T.contiguous()
                          for t in (out, grad) for c in (0, 1))
        if out.device.type == "cuda":
            dsr, dsi, dg = _sel_chain_bwd_cuda(g8, fr, fi, gr, gi, ctx.wires,
                                               ctx.imprimitive)
        else:
            dsr, dsi, dg = sel_chain_bwd_plain(g8, fr, fi, gr, gi, ctx.wires,
                                               ctx.imprimitive)
        return torch.stack([dsr.T, dsi.T], dim=-1), dg, None, None


def _check_rows(states, wires: int, imprimitive: str) -> None:
    if imprimitive not in _IMPRIMITIVES:
        raise ValueError(f"unknown imprimitive {imprimitive!r}")
    if states.ndim != 2 or states.shape[1] != 2**wires:
        raise ValueError(f"rows of shape {tuple(states.shape)} do not hold "
                         f"{wires} wires")
    if states.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SEL-chain path for device {states.device}")


def sel_chain_rows_plain(states, rot_mats, wires: int,
                         imprimitive: str = "cnot"):
    """The chain in plain PyTorch, on any device: same arguments and
    result as :func:`sel_chain_rows`."""
    _check_rows(states, wires, imprimitive)
    x = torch.view_as_real(states.to(torch.complex64).contiguous())
    return torch.view_as_complex(
        _sel_rows_plain(x, _to_g8(rot_mats), wires, imprimitive))


def sel_chain_rows(states, rot_mats, wires: int, imprimitive: str = "cnot"):
    """SEL chain on (N, d) complex states, as ``sel_chain_pallas`` takes
    them; returns (N, d) complex64.

    rot_mats: (depth, wires, 2, 2) complex per-wire rotations; after layer
    l the ring of range ``l % (wires-1) + 1`` (CZ or CNOT). Differentiable
    in ``states`` and ``rot_mats``.
    """
    _check_rows(states, wires, imprimitive)
    x = torch.view_as_real(states.to(torch.complex64).contiguous())
    return torch.view_as_complex(
        _SelRows.apply(x, _to_g8(rot_mats), wires, imprimitive))
