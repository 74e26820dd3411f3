"""The SEL chain and its adjoint backward: hand-written CUDA kernels and
their plain PyTorch versions (counterpart of
``qiddm_tpu/sim/pallas_gate_kernel.py``: ``sel_chain_pallas``,
``_sel_fwd_kernel``, ``_sel_bwd_kernel``).

StronglyEntanglingLayers of ``depth`` layers on an arbitrary batch of start
states (amplitude embeddings for Qdense, RZ-phased |0...0> for QNN): per
layer a 2x2 gate on every wire, then a CZ or CNOT ring whose range cycles
over the full depth, ``r_l = l % (wires-1) + 1``.

``sel_chain_planes`` is the entry the engine calls. It runs the
``_SelChain`` autograd Function, which picks the path by the device of its
input, in the forward and in the backward pass alike: a CPU tensor runs the
plain versions (:func:`sel_chain_planes_plain`, :func:`sel_chain_bwd_plain`);
a CUDA tensor launches the kernels of ``csrc/sel_chain.cu`` or raises.
Nothing falls back from a kernel to its plain version. The kernels are
built into the one library of ``gate_kernel.py`` and take up to
``config.SEL_KERNEL_MAX_WIRES`` (12) wires: the QNN/Qdense chains and the
trajectory backend's SEL route, which the JAX package serves at 11-12 wires
with ``sel_chain_pallas_tiled`` (one ``sel_chain_pallas`` call per 128-lane
chunk of the batch; on the card the whole batch is one launch).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import config as _config
from . import gate_kernel as _gk
from .gate_kernel import _ADJ_ORDER, _ADJ_SIGNS, _gate_apply, _plane_dg, _to_g8
from .sel import cnot_ring_perm, cz_ring_signs

# Kernel launches since the last reset, forward and backward; chip_smoke.py
# reads them to show that the QNN/Qdense paths went through the kernels.
SEL_LAUNCHES = 0
SEL_BWD_LAUNCHES = 0

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


# --- CUDA kernel -------------------------------------------------------------

def _ring_shape(wires: int) -> tuple:
    return (max(wires - 1, 1), 2**wires)


def _sel_chain_cuda(sr, si, g8, wires: int, imprimitive: str):
    """Launch the forward kernel on PyTorch's current stream; (or, oi) are
    new (d, B) float32 tensors."""
    global SEL_LAUNCHES
    ring = _ring_on(wires, imprimitive, False, sr.device)
    d, B, depth = _gk._check_cuda_inputs(
        "SEL-chain kernel", (sr, si), g8, ring, _ring_shape(wires), wires,
        max_wires=_config.SEL_KERNEL_MAX_WIRES)
    lib = _gk._library()
    _gk._check_smem(lib.sel_chain_fwd_smem_bytes(wires, depth), depth, wires)
    out_r = torch.empty_like(sr)
    out_i = torch.empty_like(si)
    stream = torch.cuda.current_stream(sr.device).cuda_stream
    err = lib.sel_chain_fwd(sr.data_ptr(), si.data_ptr(), g8.data_ptr(),
                            ring.data_ptr(), out_r.data_ptr(),
                            out_i.data_ptr(), wires, B, depth,
                            int(imprimitive == "cz"), sr.device.index, stream)
    _gk._raise_on(err, lib, "SEL-chain kernel")
    SEL_LAUNCHES += 1
    return out_r, out_i


def _sel_chain_bwd_cuda(g8, fr, fi, gr, gi, wires: int, imprimitive: str):
    """Launch the backward kernel (and its fixed-order batch sum of dg) on
    PyTorch's current stream; returns new (dsr, dsi, dg) as
    :func:`sel_chain_bwd_plain` does."""
    global SEL_BWD_LAUNCHES
    ring = _ring_on(wires, imprimitive, True, fr.device)
    d, B, depth = _gk._check_cuda_inputs(
        "SEL-chain backward kernel", (fr, fi, gr, gi), g8, ring,
        _ring_shape(wires), wires, max_wires=_config.SEL_KERNEL_MAX_WIRES)
    lib = _gk._library()
    _gk._check_smem(lib.sel_chain_bwd_smem_bytes(wires, depth), depth, wires)
    dg_part = torch.empty((B, depth, wires, 8), dtype=torch.float32,
                          device=fr.device)
    dg = torch.empty_like(g8)
    dsr = torch.empty_like(fr)
    dsi = torch.empty_like(fi)
    stream = torch.cuda.current_stream(fr.device).cuda_stream
    err = lib.sel_chain_bwd(g8.data_ptr(), ring.data_ptr(), fr.data_ptr(),
                            fi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                            dg_part.data_ptr(), dg.data_ptr(), dsr.data_ptr(),
                            dsi.data_ptr(), wires, B, depth,
                            int(imprimitive == "cz"), fr.device.index, stream)
    _gk._raise_on(err, lib, "SEL-chain backward kernel")
    SEL_BWD_LAUNCHES += 1
    return dsr, dsi, dg


class _SelChain(torch.autograd.Function):
    """``(sr, si, g8) -> (or, oi)`` on real float32 planes, so autograd
    carries ``dg`` back to the complex rotations through :func:`_to_g8`'s
    ``.real``/``.imag``. Saves ``(g8, or, oi)``, as ``_sel_chain_fwd`` does
    on the TPU; the backward rebuilds the states from the output."""

    @staticmethod
    def forward(ctx, sr, si, g8, wires: int, imprimitive: str):
        if sr.device.type == "cuda":
            out_r, out_i = _sel_chain_cuda(sr, si, g8, wires, imprimitive)
        else:
            out_r, out_i = _sel_plain(sr, si, g8, wires, imprimitive)
        ctx.save_for_backward(g8, out_r, out_i)
        ctx.wires, ctx.imprimitive = wires, imprimitive
        return out_r, out_i

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


def sel_chain(states, rot_mats, wires: int, imprimitive: str = "cnot"):
    """:func:`sel_chain_planes` on (B, d) complex states, as
    ``sel_chain_pallas`` takes them; returns (B, d) complex64."""
    sr = states.real.to(torch.float32).T
    si = states.imag.to(torch.float32).T
    out_r, out_i = sel_chain_planes(sr, si, rot_mats, wires, imprimitive)
    return torch.complex(out_r, out_i).T
