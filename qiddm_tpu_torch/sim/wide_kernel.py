"""The wide re-uploading chain on the card: the grouped sublayer and its
adjoint backward, the whole chain and its adjoint in one launch each, and
their plain PyTorch versions (counterpart of
``qiddm_tpu/sim/pallas_wide_kernel.py``: ``_sub_fwd_kernel`` (#11) and
``_sub_bwd_kernel`` (#12), reached from ``wide_fwd_scan`` and
``wide_bwd_scan``; ``_fwd_kernel`` (#9) and ``_bwd_kernel`` (#10), reached
from ``wide_fwd_planes`` and ``wide_bwd_planes``).

A sublayer applies, for each wire group of ``wide.group_sizes(w)`` in
order, the group's (2^s x 2^s) matrix on the group's bit axis of the
(d, B) float32 state planes, then the CZ ring's sign diagonal; a spectrum
layer is the RZ phase followed by k sublayers, from |0...0>.

``wide_chain_planes`` is the entry the engine calls. It runs the
``_WideChain`` autograd Function, which picks the path by the device of its
input (:func:`_route`), in the forward and in the backward pass alike: a CPU
tensor runs the plain versions (:func:`wide_chain_planes_plain`,
:func:`wide_chain_bwd_plain`), grouped matrix products on planes as
``_make_wide_chain`` does with einsums in the JAX package; a CUDA tensor
launches the kernels that ``config.wide_kernel_variant()`` names, or
raises: ``"scan"`` (the default) the per-group kernels #11/#12 of
``csrc/wide_chain.cu``, ``"monolith"`` the cooperative kernels #9/#10 of
``csrc/wide_mono.cu``, all built into the one library of ``gate_kernel.py``.
Both variants compute the same function, whose plain version is the one
above. The forward goes through the variant's operator, ``qiddm::wide_chain``
or ``qiddm::wide_mono`` (``sim/ops.py``), whose CPU implementations are both
that plain version. Nothing falls back from a kernel to another or to its plain
version.

The Function takes and returns real planes. JAX transposes a complex-linear
map without conjugating it (cotangents go through ``G^T``); PyTorch hands
back the conjugate (``G^H``). On real planes both are the same real-linear
transpose, so the backward here is written once, in PyTorch's convention,
and held against torch autograd through the plain forward.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .. import config as _config
from . import gate_kernel as _gk
from .wide import _offsets, group_gates, group_sizes

# Launches of the group kernel (``wide_group_mma_kernel``) since the last
# reset, forward (#11) and backward (#12): one per wire group of each
# sublayer, so a chain call of L*k sublayers over G groups adds L*k*G.
# The backward's helpers (each group's dG product and its fixed-order sum,
# the un-encode between spectrum layers) are not counted, as the gate
# chain's dg batch sum is not. chip_smoke.py reads them to show that the
# 11-20-wire paths went through the kernels.
WIDE_LAUNCHES = 0
WIDE_BWD_LAUNCHES = 0
# Launches of the monolithic chain since the last reset, forward (#9) and
# backward (#10): one a chain call.
WIDE_MONO_LAUNCHES = 0
WIDE_MONO_BWD_LAUNCHES = 0


def _planes_of(gs) -> tuple[torch.Tensor, ...]:
    """Complex group matrices -> the flat plane tuple (g0r, g0i, g1r, ...)
    of contiguous float32 tensors."""
    out = []
    for g in gs:
        out += [g.real.to(torch.float32).contiguous(),
                g.imag.to(torch.float32).contiguous()]
    return tuple(out)


# --- plain PyTorch version ---------------------------------------------------

def _group_apply(sr, si, gr, gi, off: int, size: int):
    """``G`` (gr + i gi, (D, D)) on the group bit axis [off, off + size) of
    (d, B) planes: a (2^off, D, d B / 2^(off + size)) view, batched over
    its leading axis."""
    d, B = sr.shape
    shape = (2**off, 2**size, -1)
    vr, vi = sr.reshape(shape), si.reshape(shape)
    out_r = gr @ vr - gi @ vi
    out_i = gr @ vi + gi @ vr
    return out_r.reshape(d, B), out_i.reshape(d, B)


def _group_dg(cr, ci, sr, si, off: int, size: int):
    """The group gradient ``dG[x, y] = sum c[x] conj(s[y])`` over every
    column of the group view, as (re, im) planes (D, D)."""
    shape = (2**off, 2**size, -1)
    c_r, c_i = cr.reshape(shape), ci.reshape(shape)
    s_r, s_i = sr.reshape(shape), si.reshape(shape)
    t_r, t_i = s_r.transpose(1, 2), s_i.transpose(1, 2)
    return ((c_r @ t_r + c_i @ t_i).sum(0), (c_i @ t_r - c_r @ t_i).sum(0))


def wide_sub_plain(sr, si, gplanes, sign, wires: int):
    """One sublayer (kernel #11's function) in plain PyTorch: each group's
    matrix in order, then the (d, 1) ring ``sign`` plane. ``gplanes`` is
    this sublayer's (g0r, g0i, g1r, ...) of (D, D) planes."""
    sizes = group_sizes(wires)
    for g, (off, s) in enumerate(zip(_offsets(sizes), sizes)):
        sr, si = _group_apply(sr, si, gplanes[2 * g], gplanes[2 * g + 1],
                              off, s)
    return sr * sign, si * sign


def wide_sub_bwd_plain(sr, si, cr, ci, gplanes, sign, wires: int):
    """One sublayer's adjoint (kernel #12's function) in plain PyTorch:
    undo the signs on the state ``s`` (the sublayer's output) and the
    cotangent ``c``; then, for each group in reverse, rebuild the group's
    input ``G^H s``, form ``dG`` and carry the cotangent back through
    ``G^H``. Returns the sublayer's input state and cotangent planes and
    the (dg0r, dg0i, dg1r, ...) tuple."""
    sizes = group_sizes(wires)
    offs = _offsets(sizes)
    sr, si, cr, ci = sr * sign, si * sign, cr * sign, ci * sign
    dg = [None] * len(gplanes)
    for g in range(len(sizes) - 1, -1, -1):
        ar = gplanes[2 * g].T
        ai = -gplanes[2 * g + 1].T  # G^H
        sr, si = _group_apply(sr, si, ar, ai, offs[g], sizes[g])
        dg[2 * g], dg[2 * g + 1] = _group_dg(cr, ci, sr, si, offs[g],
                                             sizes[g])
        cr, ci = _group_apply(cr, ci, ar, ai, offs[g], sizes[g])
    return sr, si, cr, ci, tuple(dg)


def _chain_plain(pr, pi, gplanes, signs, k: int, wires: int):
    """The forward chain on group planes ((n_layers, D, D) each), in plain
    PyTorch."""
    sr = torch.zeros_like(pr)
    sr[0] = 1.0
    si = torch.zeros_like(pi)
    for l in range(gplanes[0].shape[0]):
        if l % k == 0:
            sr, si = sr * pr - si * pi, sr * pi + si * pr
        sr, si = wide_sub_plain(sr, si, [g[l] for g in gplanes],
                                signs[l % k], wires)
    return sr, si


def wide_chain_planes_plain(pr, pi, rot_mats, k: int, wires: int):
    """The chain in plain PyTorch, on any device: same arguments and
    results as :func:`wide_chain_planes`."""
    gplanes = _planes_of(group_gates(rot_mats, group_sizes(wires)))
    return _chain_plain(pr, pi, gplanes,
                        _gk._sign_planes_on(k, wires, pr.device), k, wires)


def wide_chain_bwd_plain(pr, pi, gplanes, fr, fi, gr, gi, k: int,
                         wires: int):
    """The adjoint reverse walk in plain PyTorch, on any device.

    From the forward output ``(fr, fi)`` and its cotangent ``(gr, gi)``
    (all (d, B) float32), rebuild each sublayer's state through ``G^H``
    and return ``(dpr, dpi, dgplanes)``: the phase-plane gradients and the
    group-plane gradients shaped as ``gplanes``."""
    signs = _gk._sign_planes_on(k, wires, pr.device)
    n_layers = gplanes[0].shape[0]
    sr, si, cr, ci = fr, fi, gr, gi
    dpr = torch.zeros_like(pr)
    dpi = torch.zeros_like(pi)
    dg = [[None] * n_layers for _ in gplanes]
    for l in range(n_layers - 1, -1, -1):
        sr, si, cr, ci, dg_l = wide_sub_bwd_plain(
            sr, si, cr, ci, [g[l] for g in gplanes], signs[l % k], wires)
        for j, d in enumerate(dg_l):
            dg[j][l] = d
        if l % k == 0:
            spr = sr * pr + si * pi  # state before the phase
            spi = si * pr - sr * pi
            dpr = dpr + cr * spr + ci * spi
            dpi = dpi + ci * spr - cr * spi
            cr, ci = cr * pr + ci * pi, ci * pr - cr * pi
            sr, si = spr, spi
    return dpr, dpi, tuple(torch.stack(d) for d in dg)


# --- CUDA kernels ------------------------------------------------------------

def _check_wide_inputs(what: str, planes, gplanes, k: int, wires: int):
    """Raise unless every tensor is contiguous float32 on one CUDA device,
    1 <= wires <= ``WIDE_KERNEL_MAX_WIRES``, the planes are (2**wires, B)
    and the group planes (n_layers, 2**s, 2**s) for ``group_sizes(wires)``
    with k dividing n_layers. Returns (B, n_layers, sizes)."""
    tensors = (*planes, *gplanes)
    dev = planes[0].device
    if any(t.device != dev or t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: every input must be on the same CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous float32, got "
                         f"{[(t.dtype, t.is_contiguous()) for t in tensors]}")
    top = _config.WIDE_KERNEL_MAX_WIRES
    if not 1 <= wires <= top:
        raise ValueError(f"{what} takes 1..{top} wires, got {wires}")
    sizes = group_sizes(wires)
    d, B = planes[0].shape
    n_layers = gplanes[0].shape[0]
    want = [(n_layers, 2**s, 2**s) for s in sizes for _ in range(2)]
    if (any(t.shape != (d, B) for t in planes) or d != 2**wires or B < 1
            or n_layers < 1 or k < 1 or n_layers % k
            or [tuple(t.shape) for t in gplanes] != want):
        raise ValueError(
            f"{what}: bad shapes {[tuple(t.shape) for t in planes]}, groups "
            f"{[tuple(t.shape) for t in gplanes]} for wires={wires}, k={k}")
    return B, n_layers, sizes


def _group_args(tensors, sizes):
    """The kernels' three (re, im) pointer pairs and three group sizes;
    absent groups give null pointers and size 0."""
    return ([t.data_ptr() for t in tensors] + [None] * (6 - len(tensors)),
            list(sizes) + [0] * (3 - len(sizes)))


def _launch_fwd(entry, what: str, pr, pi, gplanes, k: int, wires: int):
    """Check the inputs and launch a forward ``entry`` (``wide_chain_fwd``
    or ``wide_mono_fwd``) on PyTorch's current stream; returns the new
    (d, B) float32 state planes and the sublayer and group counts."""
    B, n_layers, sizes = _check_wide_inputs(what, (pr, pi), gplanes, k,
                                            wires)
    lib = _gk._library()
    sr = torch.empty_like(pr)
    si = torch.empty_like(pi)
    gptrs, s = _group_args(gplanes, sizes)
    stream = torch.cuda.current_stream(pr.device).cuda_stream
    err = getattr(lib, entry)(pr.data_ptr(), pi.data_ptr(), *gptrs,
                              sr.data_ptr(), si.data_ptr(), *s, wires, B,
                              n_layers, k, pr.device.index, stream)
    _gk._raise_on(err, lib, what)
    return sr, si, n_layers, len(sizes)


def _launch_bwd(entry, what: str, pr, pi, gplanes, fr, fi, gr, gi, k: int,
                wires: int):
    """Check the inputs, allocate the work planes and the dG partials, and
    launch a backward ``entry`` (``wide_chain_bwd`` or ``wide_mono_bwd``)
    on PyTorch's current stream; returns ``(dpr, dpi, dgplanes)`` as
    :func:`wide_chain_bwd_plain` does, and the sublayer and group counts."""
    B, n_layers, sizes = _check_wide_inputs(
        what, (pr, pi, fr, fi, gr, gi), gplanes, k, wires)
    lib = _gk._library()
    gptrs, s = _group_args(gplanes, sizes)
    part = torch.empty(lib.wide_chain_bwd_part_floats(*s, wires, B),
                       dtype=torch.float32, device=pr.device)
    # the walk overwrites the state and cotangent planes it is given
    work = [fr.clone(), fi.clone(), gr.clone(), gi.clone(),
            torch.empty_like(fr), torch.empty_like(fi)]
    dg = tuple(torch.empty_like(g) for g in gplanes)
    dpr = torch.empty_like(pr)
    dpi = torch.empty_like(pi)
    dptrs, _ = _group_args(dg, sizes)
    stream = torch.cuda.current_stream(pr.device).cuda_stream
    err = getattr(lib, entry)(pr.data_ptr(), pi.data_ptr(), *gptrs,
                              *(t.data_ptr() for t in work), part.data_ptr(),
                              *dptrs, dpr.data_ptr(), dpi.data_ptr(), *s,
                              wires, B, n_layers, k, pr.device.index, stream)
    _gk._raise_on(err, lib, what)
    return (dpr, dpi, dg), n_layers, len(sizes)


def _wide_chain_cuda(pr, pi, gplanes, k: int, wires: int):
    """Launch the forward chain (kernel #11 for each group of each
    sublayer) on PyTorch's current stream; (sr, si) are new (d, B) float32
    tensors."""
    global WIDE_LAUNCHES
    sr, si, n_layers, n_groups = _launch_fwd(
        "wide_chain_fwd", "wide-chain kernel", pr, pi, gplanes, k, wires)
    WIDE_LAUNCHES += n_layers * n_groups
    return sr, si


def _wide_chain_bwd_cuda(pr, pi, gplanes, fr, fi, gr, gi, k: int,
                         wires: int):
    """Launch the backward chain (kernel #12 for each group of each
    sublayer, with its fixed-order sums of dG) on PyTorch's current stream;
    returns new ``(dpr, dpi, dgplanes)`` as :func:`wide_chain_bwd_plain`
    does."""
    global WIDE_BWD_LAUNCHES
    out, n_layers, n_groups = _launch_bwd(
        "wide_chain_bwd", "wide-chain backward kernel", pr, pi, gplanes, fr,
        fi, gr, gi, k, wires)
    WIDE_BWD_LAUNCHES += n_layers * n_groups
    return out


def _wide_mono_cuda(pr, pi, gplanes, k: int, wires: int):
    """Launch the whole forward chain in one cooperative launch (kernel #9)
    on PyTorch's current stream; (sr, si) are new (d, B) float32 tensors."""
    global WIDE_MONO_LAUNCHES
    sr, si, _, _ = _launch_fwd("wide_mono_fwd", "wide-chain monolith kernel",
                               pr, pi, gplanes, k, wires)
    WIDE_MONO_LAUNCHES += 1
    return sr, si


def _wide_mono_bwd_cuda(pr, pi, gplanes, fr, fi, gr, gi, k: int,
                        wires: int):
    """Launch the whole adjoint walk in one cooperative launch (kernel #10)
    on PyTorch's current stream; returns new ``(dpr, dpi, dgplanes)`` as
    :func:`wide_chain_bwd_plain` does."""
    global WIDE_MONO_BWD_LAUNCHES
    out, _, _ = _launch_bwd("wide_mono_bwd",
                            "wide-chain monolith backward kernel", pr, pi,
                            gplanes, fr, fi, gr, gi, k, wires)
    WIDE_MONO_BWD_LAUNCHES += 1
    return out


def _route(device: torch.device) -> str:
    """The wide chain's path for tensors on ``device``: ``"plain"`` off
    the card; on it the kernels of ``config.wide_kernel_variant()``,
    ``"scan"`` (#11/#12) or ``"monolith"`` (#9/#10)."""
    if device.type != "cuda":
        return "plain"
    return _config.wide_kernel_variant()


class _WideChain(torch.autograd.Function):
    """``(pr, pi, group planes...) -> (sr, si)`` on real float32 planes, so
    autograd carries ``dG`` back to the rotations through the group
    matrices' ``.real``/``.imag`` and no conjugation is written by hand.
    Saves the phases, the group planes and the final state, O(1) in the
    depth, as ``wide_bwd_scan`` does on the TPU; the backward rebuilds the
    per-sublayer states through ``G^H``. The backward takes the route the
    forward took (:func:`_route`)."""

    @staticmethod
    def forward(ctx, k: int, wires: int, pr, pi, *gplanes):
        route = _route(pr.device)
        # both operators run the plain chain on the CPU: a trace on the CPU
        # records the variant's operator, as one on the card does
        op = (torch.ops.qiddm.wide_mono.default
              if _config.wide_kernel_variant() == "monolith"
              else torch.ops.qiddm.wide_chain.default)
        sr, si = op(pr, pi, list(gplanes), k, wires)
        ctx.save_for_backward(pr, pi, sr, si, *gplanes)
        ctx.k, ctx.wires, ctx.route = k, wires, route
        return sr, si

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        pr, pi, fr, fi, *gplanes = ctx.saved_tensors
        k, wires = ctx.k, ctx.wires
        # readouts hand back transposed views; an unused output gives None
        gr = torch.zeros_like(fr) if gr is None else gr.contiguous()
        gi = torch.zeros_like(fi) if gi is None else gi.contiguous()
        if ctx.route == "monolith":
            bwd = _wide_mono_bwd_cuda
        elif ctx.route == "scan":
            bwd = _wide_chain_bwd_cuda
        else:
            bwd = wide_chain_bwd_plain
        dpr, dpi, dg = bwd(pr, pi, gplanes, fr, fi, gr, gi, k, wires)
        return (None, None, dpr, dpi, *dg)


def wide_chain_planes(pr, pi, rot_mats, k: int, wires: int):
    """Plane-level wide re-uploading chain from |0...0>.

    pr, pi: (d, B) float32 RZ phase planes, applied before sublayers 0, k,
    2k, ...; rot_mats: (L*k, wires, 2, 2) complex per-wire rotations,
    composed here into the group matrices of ``group_sizes(wires)``; the
    CZ ring after each sublayer uses range ``sel_ranges(k, wires)[l % k]``.
    Returns the state planes ``(sr, si)``, each (d, B) float32.

    Differentiable in ``pr``, ``pi`` and ``rot_mats``: on a CUDA tensor
    the forward and backward run kernels #11/#12 or, with
    ``config.set_wide_kernel_variant("monolith")``, #9/#10; on a CPU tensor
    their plain versions.
    """
    if pr.shape[0] != 2**wires:
        raise ValueError(f"planes of {pr.shape[0]} rows do not hold "
                         f"{wires} wires")
    if pr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no wide-chain path for device {pr.device}")
    gplanes = _planes_of(group_gates(rot_mats, group_sizes(wires)))
    return _WideChain.apply(k, wires, pr, pi, *gplanes)
