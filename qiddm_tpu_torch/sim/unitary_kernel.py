"""The re-uploading chain that streams dense layer unitaries, and its
adjoint backward: hand-written CUDA kernels and their plain PyTorch
versions (counterpart of ``qiddm_tpu/sim/pallas_kernels.py``:
``fused_reupload_chain``, ``_fwd_kernel``, ``_bwd_kernel``).

From |0...0>, for every layer l of ``L*k``: the RZ phase diagonal at
``l % k == 0``, then ``s <- U_l s`` with the dense (d, d) layer unitary of
``sel.sel_layer_unitaries`` (rotations and the CZ or CNOT ring in one
matrix). The engine takes this route for the re-uploading blocks that the
gate chains do not serve at a batch below ``2**wires``: a CNOT ring, up to
``MAX_FUSED_DIM`` = 256 amplitudes (8 wires).

``unitary_chain_planes`` is the entry the engine calls. It runs the
``_UnitaryChain`` autograd Function, which picks the path by the device of
its input, in the forward and in the backward pass alike: a CPU tensor runs
the plain versions (:func:`unitary_chain_planes_plain`,
:func:`unitary_chain_bwd_plain`); a CUDA tensor launches the kernels of
``csrc/unitary_chain.cu`` (#13 forward, #14 backward) or raises. Nothing
falls back from a kernel to its plain version. The forward goes through the
operator ``qiddm::unitary_chain`` (``sim/ops.py``). The kernels are built
into the one library of ``gate_kernel.py``.

Layout: the phases and the states are (d, B) float32 planes, as for the
port's other chains (``statevector.rz_phase_planes`` builds the phases,
``probs_from_planes`` and ``expval_z_from_planes`` read the output); the
unitaries are (L*k, d, d) float32 planes, row-major. Every input of the
Function is a real tensor, so its backward is written once, in PyTorch's
convention, and autograd carries dU to the complex unitaries through
``.real`` and ``.imag``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import gate_kernel as _gk

# Kernel launches since the last reset, one a chain call each (#14's dU
# product is a helper and not counted, as #2's dg sum is not);
# chip_smoke.py reads them to show that the route went through the kernels.
UNITARY_LAUNCHES = 0
UNITARY_BWD_LAUNCHES = 0

# Widest state the kernels take: the TPU kernel's MAX_FUSED_DIM
# (qiddm_tpu/sim/pallas_kernels.py:33), 8 wires.
MAX_FUSED_DIM = 256
MAX_WIRES = MAX_FUSED_DIM.bit_length() - 1


# --- plain PyTorch version ---------------------------------------------------

def unitary_chain_planes_plain(pr, pi, ur, ui, k: int):
    """The chain in plain PyTorch, on any device: same arguments and
    results as :func:`unitary_chain_planes`."""
    sr = torch.zeros_like(pr)
    sr[0] = 1.0
    si = torch.zeros_like(pi)
    for l in range(ur.shape[0]):
        if l % k == 0:
            sr, si = sr * pr - si * pi, sr * pi + si * pr
        sr, si = ur[l] @ sr - ui[l] @ si, ur[l] @ si + ui[l] @ sr
    return sr, si


def unitary_chain_bwd_plain(pr, pi, ur, ui, fr, fi, gr, gi, k: int):
    """The adjoint reverse walk in plain PyTorch, on any device.

    From the forward output ``(fr, fi)`` and its cotangent ``(gr, gi)``
    (all (d, B) float32), rebuild each layer's input as ``U_l^H s``, push
    the cotangent through ``U_l^H``, and return ``(dpr, dpi, dur, dui)``:
    the (d, B) phase-plane gradients and the (L*k, d, d) unitary-plane
    gradients, ``dU_l = c_l t_l^H`` summed over the batch."""
    sr, si, cr, ci = fr, fi, gr, gi
    dpr = torch.zeros_like(pr)
    dpi = torch.zeros_like(pi)
    dur = torch.empty_like(ur)
    dui = torch.empty_like(ui)
    for l in range(ur.shape[0] - 1, -1, -1):
        a, q = ur[l].T, ui[l].T
        tr, ti = a @ sr + q @ si, a @ si - q @ sr  # the input of U_l
        dur[l] = cr @ tr.T + ci @ ti.T
        dui[l] = ci @ tr.T - cr @ ti.T
        cr, ci = a @ cr + q @ ci, a @ ci - q @ cr
        if l % k == 0:
            sr, si = tr * pr + ti * pi, ti * pr - tr * pi  # before the phase
            dpr = dpr + cr * sr + ci * si
            dpi = dpi + ci * sr - cr * si
            cr, ci = cr * pr + ci * pi, ci * pr - cr * pi
        else:
            sr, si = tr, ti
    return dpr, dpi, dur, dui


# --- CUDA kernels ------------------------------------------------------------

# Streaming multiprocessors of the H100, which the tiles of a batch fill,
# and the shared memory (each resident CTA also takes 1 KB of it) and the
# threads of one.
_SMS = 132
_SM_SMEM_BYTES = 233472
_CTA_RESERVED_BYTES = 1024
_SM_THREADS = 2048


# The forward kernel #13: rows of U_l a CTA (one 16-row tensor-core tile),
# its threads, its tiles of samples, and its warps' share of the product.
FWD_ROWS = 16
FWD_THREADS = 256
FWD_COLS = (8, 16)


class UnitaryPlan(NamedTuple):
    """How kernel #13 lays out one call: ``tiles`` tiles of ``cols``
    samples, each a thread-block cluster of ``cluster`` CTAs that own
    ``FWD_ROWS`` rows of every U_l each, ``FWD_THREADS`` threads and
    ``smem_bytes`` of shared memory a CTA; ``steps_per_warp`` 8-deep steps
    of a layer's product for each of the ``warps`` warps with work."""
    cluster: int
    cols: int
    tiles: int
    threads: int
    smem_bytes: int
    warps: int
    steps_per_warp: int


def fwd_smem_bytes(wires: int, cols: int) -> int:
    """Shared memory of a forward CTA, as ``csrc/unitary_chain.cu::
    fwd_smem`` counts it: the state [2][re, im][depth][cols | 8], U's rows
    [2][re, im][16][depth + 4] and the warps' partials [8][re, im][16][cols]
    floats, depth = max(8, 2**wires)."""
    depth = max(8, 2**wires)
    return 4 * (4 * depth * (cols | 8) + 4 * FWD_ROWS * (depth + 4)
                + 2 * (FWD_THREADS // 32) * FWD_ROWS * cols)


def unitary_plan(wires: int, batch: int, cols: int = 0) -> UnitaryPlan:
    """Kernel #13's layout for one call, from the shape alone.

    A cluster of max(1, d / 16) CTAs works a tile of samples; the tile is
    the smaller of ``FWD_COLS`` whose CTAs all find an SM at once
    (``tiles * cluster <= 132``), else the larger (a second wave of
    clusters). ``cols`` forces a tile of 8 or 16 (``chip_smoke.py`` times
    both)."""
    d = 2**wires
    cluster = max(1, d // FWD_ROWS)
    if cols == 0:
        cols = next((c for c in FWD_COLS
                     if -(-batch // c) * cluster <= _SMS), FWD_COLS[-1])
    if cols not in FWD_COLS:
        raise ValueError(f"cols must be one of {FWD_COLS} samples, got "
                         f"{cols}")
    steps = max(8, d) // 8
    warps = min(steps, FWD_THREADS // 32)
    return UnitaryPlan(cluster, cols, -(-batch // cols), FWD_THREADS,
                       fwd_smem_bytes(wires, cols), warps, steps // warps)


# The backward kernel #14: the forward's clusters and tiles of samples, its
# threads, and the tile of its dU product (a block a 64 x 64 tile of dU_l).
BWD_THREADS = 256
DU_TILE = 64


class UnitaryBwdPlan(NamedTuple):
    """How kernel #14 lays out one call: ``tiles`` tiles of ``cols``
    samples, each a thread-block cluster of ``cluster`` CTAs (``FWD_ROWS``
    rows of t and n each) of ``threads`` threads and ``smem_bytes`` of
    shared memory; ``steps_per_warp`` 8-deep steps of a layer's product
    for each of ``warps`` warps; ``resident`` clusters on the card at once
    by shared memory and threads, so ``waves`` waves of clusters (the
    card's own count, ``unitary_chain_bwd_active_clusters``, can be lower:
    a cluster's CTAs must share a GPC); the workspace's ``ws_samples``
    (tiles x cols) and the dU product's ``du_blocks`` blocks a layer."""
    cluster: int
    cols: int
    tiles: int
    threads: int
    smem_bytes: int
    warps: int
    steps_per_warp: int
    resident: int
    waves: int
    ws_samples: int
    du_blocks: int


def bwd_smem_bytes(wires: int, cols: int) -> int:
    """Shared memory of a backward CTA, as ``csrc/unitary_chain.cu::
    bwd_smem`` counts it: state and cotangent [2][4][depth][cols], U's
    strip [2][re, im][depth][16] and the warps' partials [8][re, im] of 16
    x 2 cols floats and a pad (8 at 16 samples, 16 at 8), depth = max(8,
    2**wires)."""
    depth = max(8, 2**wires)
    red = FWD_ROWS * 2 * cols + (8 if cols == 16 else 16)
    return 4 * (8 * depth * cols + 4 * depth * FWD_ROWS
                + 2 * (BWD_THREADS // 32) * red)


def _resident(cluster: int, smem: int) -> int:
    """Clusters of ``cluster`` CTAs of ``smem`` bytes that the 132 SMs hold
    at once, by shared memory and threads alone."""
    per_sm = min(_SM_THREADS // BWD_THREADS,
                 _SM_SMEM_BYTES // (smem + _CTA_RESERVED_BYTES))
    return _SMS * per_sm // cluster


def unitary_bwd_plan(wires: int, batch: int, cols: int = 0) -> UnitaryBwdPlan:
    """Kernel #14's layout for one call, from the shape alone.

    A cluster of max(1, d / 16) CTAs walks a tile of samples, as #13's
    forward does; the tile is 8 samples when their clusters all fit the
    card at once (``resident``), else 16 (fewer clusters, each holding
    twice the samples). ``cols`` forces a tile of 8 or 16 (``chip_smoke.py``
    times both). Raises for a width past ``MAX_WIRES``, an empty batch, or
    a tile whose shared memory the card does not hold."""
    if not 1 <= wires <= MAX_WIRES or batch < 1:
        raise ValueError(f"no backward plan for {wires} wires, batch "
                         f"{batch} (1-{MAX_WIRES} wires)")
    d = 2**wires
    cluster = max(1, d // FWD_ROWS)
    if cols == 0:
        cols = next((c for c in FWD_COLS
                     if -(-batch // c) <= _resident(
                         cluster, bwd_smem_bytes(wires, c))), FWD_COLS[-1])
    if cols not in FWD_COLS:
        raise ValueError(f"cols must be one of {FWD_COLS} samples, got "
                         f"{cols}")
    smem = bwd_smem_bytes(wires, cols)
    if smem > _gk._MAX_SMEM_BYTES:
        raise ValueError(f"unitary-chain backward kernel needs {smem} B of "
                         f"shared memory a CTA (limit {_gk._MAX_SMEM_BYTES})"
                         f" at {wires} wires and {cols} samples a tile")
    tiles = -(-batch // cols)
    resident = _resident(cluster, smem)
    steps = max(8, d) // 8
    warps = min(steps, BWD_THREADS // 32)
    return UnitaryBwdPlan(cluster, cols, tiles, BWD_THREADS, smem, warps,
                          steps // warps, resident, -(-tiles // resident),
                          tiles * cols, (-(-d // DU_TILE))**2)


def _check_inputs(what: str, planes, ur, ui, k: int):
    """Raise unless every tensor is a contiguous float32 tensor on one CUDA
    device, the planes (d, B) with d = 2**wires <= MAX_FUSED_DIM, the
    unitary planes (n_layers, d, d), and k >= 1. Returns (wires, B,
    n_layers)."""
    tensors = (*planes, ur, ui)
    dev = planes[0].device
    if any(t.device != dev or t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: every input must be on the same CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if (any(t.dtype != torch.float32 for t in tensors)
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError(f"{what}: inputs must be contiguous float32, got "
                         f"{[(t.dtype, t.is_contiguous()) for t in tensors]}")
    return _check_shapes(what, planes, ur, ui, k)


def _check_shapes(what: str, planes, ur, ui, k: int):
    d, B = planes[0].shape
    n_layers = ur.shape[0] if ur.ndim == 3 else 0
    if (any(t.shape != (d, B) for t in planes) or B < 1 or n_layers < 1
            or k < 1 or d < 2 or d & (d - 1)
            or ur.shape != (n_layers, d, d) or ui.shape != ur.shape):
        raise ValueError(
            f"{what}: bad shapes {[tuple(t.shape) for t in planes]}, "
            f"unitaries {tuple(ur.shape)}, {tuple(ui.shape)}, k={k}")
    if d > MAX_FUSED_DIM:
        raise ValueError(f"{what} takes at most {MAX_FUSED_DIM} amplitudes "
                         f"({MAX_WIRES} wires), got {d}")
    return d.bit_length() - 1, B, n_layers


def _unitary_chain_cuda(pr, pi, ur, ui, k: int, cols: int = 0):
    """Launch kernel #13 on PyTorch's current stream under
    :func:`unitary_plan` (``cols`` samples a tile, the plan's choice by
    default); (sr, si) are new (d, B) float32 tensors."""
    global UNITARY_LAUNCHES
    wires, B, n_layers = _check_inputs("unitary-chain kernel", (pr, pi), ur,
                                       ui, k)
    plan = unitary_plan(wires, B, cols)
    lib = _gk._library()
    smem = lib.unitary_chain_fwd_smem_bytes(wires, plan.cols)
    if smem != plan.smem_bytes or smem > _gk._MAX_SMEM_BYTES:
        raise ValueError(f"unitary-chain kernel needs {smem} B of shared "
                         f"memory a CTA (plan {plan.smem_bytes}, limit "
                         f"{_gk._MAX_SMEM_BYTES}) at {wires} wires and "
                         f"{plan.cols} samples a tile")
    sr = torch.empty_like(pr)
    si = torch.empty_like(pi)
    stream = torch.cuda.current_stream(pr.device).cuda_stream
    err = lib.unitary_chain_fwd(pr.data_ptr(), pi.data_ptr(), ur.data_ptr(),
                                ui.data_ptr(), sr.data_ptr(), si.data_ptr(),
                                wires, B, n_layers, k, plan.cols,
                                pr.device.index, stream)
    _gk._raise_on(err, lib, "unitary-chain kernel")
    UNITARY_LAUNCHES += 1
    return sr, si


def _unitary_chain_bwd_cuda(pr, pi, ur, ui, fr, fi, gr, gi, k: int,
                            cols: int = 0):
    """Launch kernel #14 (the adjoint walk over :func:`unitary_bwd_plan`'s
    clusters, ``cols`` samples a tile, the plan's choice by default; then
    its fixed-order dU product) on PyTorch's current stream; returns new
    (dpr, dpi, dur, dui) as :func:`unitary_chain_bwd_plain` does."""
    global UNITARY_BWD_LAUNCHES
    wires, B, n_layers = _check_inputs(
        "unitary-chain backward kernel", (pr, pi, fr, fi, gr, gi), ur, ui, k)
    plan = unitary_bwd_plan(wires, B, cols)
    lib = _gk._library()
    smem = lib.unitary_chain_bwd_smem_bytes(wires, plan.cols)
    if smem != plan.smem_bytes:
        raise ValueError(f"unitary-chain backward kernel needs {smem} B of "
                         f"shared memory a CTA, its plan {plan.smem_bytes}, "
                         f"at {wires} wires and {plan.cols} samples a tile")
    ws = torch.empty((4, n_layers, 2**wires, plan.ws_samples),
                     dtype=torch.float32, device=pr.device)
    dur = torch.empty_like(ur)
    dui = torch.empty_like(ui)
    dpr = torch.empty_like(pr)
    dpi = torch.empty_like(pi)
    stream = torch.cuda.current_stream(pr.device).cuda_stream
    err = lib.unitary_chain_bwd(pr.data_ptr(), pi.data_ptr(), ur.data_ptr(),
                                ui.data_ptr(), fr.data_ptr(), fi.data_ptr(),
                                gr.data_ptr(), gi.data_ptr(), ws.data_ptr(),
                                dur.data_ptr(), dui.data_ptr(),
                                dpr.data_ptr(), dpi.data_ptr(), wires, B,
                                n_layers, k, plan.cols, pr.device.index,
                                stream)
    _gk._raise_on(err, lib, "unitary-chain backward kernel")
    UNITARY_BWD_LAUNCHES += 1
    return dpr, dpi, dur, dui


def _on_card(device: torch.device) -> bool:
    """Whether tensors on ``device`` take the kernels (a CUDA device) or the
    plain versions (the CPU)."""
    return device.type == "cuda"


class _UnitaryChain(torch.autograd.Function):
    """``(pr, pi, ur, ui) -> (sr, si)`` on real float32 planes. Saves the
    inputs and the output, as ``_fused_fwd`` does on the TPU; the backward
    rebuilds the states from the output."""

    @staticmethod
    def forward(ctx, pr, pi, ur, ui, k: int):
        sr, si = torch.ops.qiddm.unitary_chain.default(pr, pi, ur, ui, k)
        ctx.save_for_backward(pr, pi, ur, ui, sr, si)
        ctx.k = k
        return sr, si

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        pr, pi, ur, ui, fr, fi = ctx.saved_tensors
        # readouts hand back transposed views; an unused output gives None
        gr = torch.zeros_like(fr) if gr is None else gr.contiguous()
        gi = torch.zeros_like(fi) if gi is None else gi.contiguous()
        if _on_card(pr.device):
            grads = _unitary_chain_bwd_cuda(pr, pi, ur, ui, fr, fi, gr, gi,
                                            ctx.k)
        else:
            grads = unitary_chain_bwd_plain(pr, pi, ur, ui, fr, fi, gr, gi,
                                            ctx.k)
        return (*grads, None)


def unitary_chain_planes(pr, pi, ur, ui, k: int):
    """Plane-level re-uploading chain from |0...0> through dense layer
    unitaries.

    pr, pi: (d, B) float32 phase planes, applied before layers 0, k, 2k,
    ...; ur, ui: (L*k, d, d) float32 planes of the layer unitaries
    (``sel_layer_unitaries`` flattened), d = 2**wires <= 256. Returns the
    state planes ``(sr, si)``, each (d, B) float32.

    Differentiable in all four inputs: the backward runs the adjoint
    kernel on a CUDA tensor, its plain version on a CPU one.
    """
    if any(t.dtype != torch.float32 for t in (pr, pi, ur, ui)):
        raise ValueError("the unitary chain takes float32 planes, got "
                         f"{[t.dtype for t in (pr, pi, ur, ui)]}")
    _check_shapes("unitary chain", (pr, pi), ur, ui, k)
    if pr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no unitary-chain path for device {pr.device}")
    return _UnitaryChain.apply(pr, pi, ur, ui, k)
