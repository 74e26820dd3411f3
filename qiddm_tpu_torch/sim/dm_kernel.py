"""The density-matrix re-uploading block: a hand-written CUDA kernel and its
plain PyTorch version (counterpart of ``qiddm_tpu/sim/pallas_dm_kernel.py``:
``dm_reupload_chain_pallas``, ``_dm_fwd_kernel``).

From rho = |0...0><0...0|, L spectrum layers of [RZ or RY encode ->
closed-form channel on every wire -> SEL(k, CZ ring) on both sides of rho].
Forward only: the dm backend is a test-time path (the noise drivers train
clean), and the engine takes the two-sided SEL-chain route, whose kernels
have an adjoint backward, whenever autograd records.

``dm_chain`` is the entry the engine calls. It picks the path by the device
of its input: a CPU tensor runs :func:`dm_chain_plain`; a CUDA tensor
launches the kernel of ``csrc/dm_chain.cu`` or raises. Nothing falls back
from the kernel to its plain version, and the choice is the operator
``qiddm::dm_chain``'s (``sim/ops.py``). The kernel is built into the one
library of ``gate_kernel.py``.

The kernel spreads each sample's rho over a thread-block cluster of CTAs,
each holding a block of rows: :func:`cluster_plan` picks the cluster and
whether rho lives in the CTAs' shared memory (w <= 9) or in the output
buffer (w = 10) from the shape alone, before the launch.

Memory: rho is (b, 2**w, 2**w) complex64, ``b * 4**w * 8`` bytes of device
memory (5.2 MB for 10 samples at 8 wires, 84 MB at 10 wires, the kernel's
widest).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config as _config
from . import gate_kernel as _gk
from .density import _amp_damp_wire, _depol_wire, _split, zero_density
from .gate_kernel import _to_g8
from .sel import cz_ring_signs, sel_ranges

# Kernel launches since the last reset; chip_smoke.py reads it to show that
# the noisy sampling path went through the kernel.
DM_LAUNCHES = 0

KIND_IDS = {"amplitude_damping": 0, "depolarizing": 1, "phase_damping": 2}

# The card the plan is made for (H100 SXM): its SMs, the largest cluster
# it launches (16, non-portable), and the shared memory a CTA may take.
SM_COUNT = 132
MAX_CLUSTER = 16
# A CTA keeps at least this many elements of rho (a quarter as many
# quadruples, one a thread, a pass): below it a pass is all barrier.
MIN_CTA_ELEMENTS = 1024


class DmPlan(NamedTuple):
    """How kernel #8 lays out one call: ``cluster`` CTAs a sample, each
    owning ``rows_per_cta`` rows of rho, ``smem_bytes`` of shared memory a
    CTA, and rho in that shared memory or in the output buffer."""
    cluster: int
    rows_per_cta: int
    smem_bytes: int
    rho_in_smem: bool


def cluster_plan(wires: int, batch: int, n_layers: int,
                 ry: bool = False) -> DmPlan:
    """The kernel's layout for one call, from the shape alone.

    The cluster doubles while every sample's cluster still finds an SM
    (``batch * cluster <= SM_COUNT``) and each CTA keeps at least
    ``MIN_CTA_ELEMENTS`` of rho; then, if the CTAs' rows do not fit in
    shared memory beside the encode and the gates, it doubles on (up to
    ``MAX_CLUSTER``) until they do. Where even ``MAX_CLUSTER`` CTAs cannot
    hold rho (w = 10: 8 MB), rho stays in the output buffer and the
    cluster only spreads the work."""
    d = 2**wires
    side = (wires if ry else d) * 8 + n_layers * wires * 8 * 4
    spread = 1
    while (spread < MAX_CLUSTER and batch * spread * 2 <= SM_COUNT
           and d * d // (spread * 2) >= MIN_CTA_ELEMENTS):
        spread *= 2
    cluster = spread
    while cluster < MAX_CLUSTER and d * d * 8 // cluster + side > (
            _gk._MAX_SMEM_BYTES):
        cluster *= 2
    in_smem = d * d * 8 // cluster + side <= _gk._MAX_SMEM_BYTES
    if not in_smem:
        cluster = spread
    return DmPlan(cluster, d // cluster,
                  side + (d * d * 8 // cluster if in_smem else 0), in_smem)


# --- plain PyTorch version ---------------------------------------------------

def _mix(rho, m, j: int, side: int):
    """A 2x2 operator on wire j of (b, d, d) rho, on the row side
    (``side=0``: rho -> m rho) or the column side (``side=1``: rho ->
    rho m^T; pass conj(m) for rho m^dagger). ``m`` is a nested 2x2 of
    scalars or of per-sample (b,) tensors."""
    r = _split(rho, j)
    axis = 2 if side == 0 else 5
    v0, v1 = r.select(axis, 0), r.select(axis, 1)
    out = torch.stack([m[0][0] * v0 + m[0][1] * v1,
                       m[1][0] * v0 + m[1][1] * v1], dim=axis)
    return out.reshape(rho.shape)


def _phase_damp_wire(rho, s, j: int):
    """Phase damping on wire j: the wire's off-diagonal blocks times s."""
    r = _split(rho, j)
    one = torch.ones_like(s)
    m = torch.stack([torch.stack([one, s]), torch.stack([s, one])])
    return (r * m.reshape(1, 1, 2, 1, 1, 2, 1).to(rho.dtype)).reshape(
        rho.shape)


def _channel_plain(rho, kind_id: int, g, wires: int):
    """The closed form on every wire, as ``_apply_channel`` computes it."""
    if kind_id == 0:
        for j in range(wires):
            rho = _amp_damp_wire(rho, g, j, wires)
    elif kind_id == 1:
        for j in range(wires):
            rho = _depol_wire(rho, g, j, wires)
    else:
        s = torch.sqrt(1.0 - g)
        for j in range(wires):
            rho = _phase_damp_wire(rho, s, j)
    return rho


def dm_chain_plain(enc, rot_mats, k: int, wires: int, kind: str, strength,
                   ry: bool = False):
    """The block in plain PyTorch, on any device: same arguments and result
    as :func:`dm_chain`."""
    kind_id = KIND_IDS[kind]
    device = rot_mats.device
    g = torch.as_tensor(strength, dtype=torch.float32, device=device)
    b = enc.shape[0]
    rho = zero_density(b, wires, dtype=torch.complex64, device=device)
    if ry:
        half = (0.5 * enc).to(torch.float32)
        c, s = torch.cos(half), torch.sin(half)
        c = c.to(torch.complex64).reshape(b, wires, 1, 1, 1, 1, 1)
        s = s.to(torch.complex64).reshape(b, wires, 1, 1, 1, 1, 1)
    else:
        ph = enc.to(torch.complex64)
        # conj_physical: the CPU implementation of qiddm::dm_chain may run
        # below the dispatcher's Conjugate key (under AOTAutograd), where
        # a lazy conj() would be read as unconjugated
        E = ph[:, :, None] * ph.conj_physical()[:, None, :]
    signs = []
    for r in sel_ranges(k, wires):
        sg = torch.as_tensor(cz_ring_signs(wires, r), dtype=torch.float32,
                             device=device)
        signs.append(sg[:, None] * sg[None, :])
    mats = rot_mats.to(torch.complex64)
    for l in range(mats.shape[0] // k):
        if ry:
            for j in range(wires):
                m = ((c[:, j], -s[:, j]), (s[:, j], c[:, j]))
                rho = _mix(_mix(rho, m, j, 0), m, j, 1)
        else:
            rho = rho * E
        rho = _channel_plain(rho, kind_id, g, wires)
        for li in range(k):
            for j in range(wires):
                u = mats[l * k + li, j]
                uc = u.conj_physical()
                rho = _mix(rho, ((u[0, 0], u[0, 1]), (u[1, 0], u[1, 1])), j, 0)
                rho = _mix(rho, ((uc[0, 0], uc[0, 1]), (uc[1, 0], uc[1, 1])),
                           j, 1)
            rho = rho * signs[li]
    return rho


# --- CUDA kernel -------------------------------------------------------------

def _kernel_enc(enc, wires: int, ry: bool) -> torch.Tensor:
    """The kernel's per-sample encode as float32 pairs: the (b, d) phases
    (view of complex64), or (cos, sin) of x/2 as (b, w, 2)."""
    if ry:
        half = (0.5 * enc).to(torch.float32)
        return torch.stack([torch.cos(half), torch.sin(half)],
                           dim=-1).contiguous()
    return torch.view_as_real(enc.to(torch.complex64).contiguous())


def _dm_chain_cuda(enc, g8, strength, k: int, wires: int, kind_id: int,
                   ry: bool, plan: DmPlan | None = None):
    """Launch the kernel on PyTorch's current stream; rho is a new
    (b, d, d) complex64 tensor. ``plan`` defaults to :func:`cluster_plan`'s
    (chip_smoke.py times others beside it)."""
    global DM_LAUNCHES
    what = "dm-chain kernel"
    dev = g8.device
    pairs = _kernel_enc(enc, wires, ry)
    b = pairs.shape[0]
    n_layers = g8.shape[0]
    tensors = [pairs, g8] + ([strength] if torch.is_tensor(strength) else [])
    if any(t.device != dev or dev.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: every input must be on the same CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous float32, got "
                         f"{[(t.dtype, t.is_contiguous()) for t in tensors]}")
    if not 1 <= wires <= _config.KERNEL_MAX_WIRES:
        raise ValueError(f"{what} takes 1..{_config.KERNEL_MAX_WIRES} "
                         f"wires, got {wires}")
    want = (b, wires, 2) if ry else (b, 2**wires, 2)
    if (tuple(pairs.shape) != want or b < 1 or n_layers < 1
            or n_layers % k or g8.shape != (n_layers, wires, 8)
            or (torch.is_tensor(strength) and strength.numel() != 1)):
        raise ValueError(f"{what}: bad shapes: encode {tuple(pairs.shape)}, "
                         f"g8 {tuple(g8.shape)}, k={k} for wires={wires}")
    if kind_id not in KIND_IDS.values():
        raise ValueError(f"{what}: unknown channel id {kind_id}")
    if plan is None:
        plan = cluster_plan(wires, b, n_layers, ry)
    lib = _gk._library()
    smem = lib.dm_chain_smem_bytes(wires, n_layers, int(ry), plan.cluster,
                                   int(plan.rho_in_smem))
    if smem != plan.smem_bytes:
        raise RuntimeError(f"{what}: the kernel needs {smem} B of shared "
                           f"memory a CTA, its plan {plan}")
    rho = torch.empty((b, 2**wires, 2**wires), dtype=torch.complex64,
                      device=dev)
    ptr = strength.data_ptr() if torch.is_tensor(strength) else None
    value = 0.0 if torch.is_tensor(strength) else float(strength)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dm_chain_fwd(pairs.data_ptr(), g8.data_ptr(), ptr, value,
                           rho.data_ptr(), wires, b, n_layers, k, kind_id,
                           int(ry), plan.cluster, int(plan.rho_in_smem),
                           dev.index, stream)
    _gk._raise_on(err, lib, what)
    DM_LAUNCHES += 1
    return rho


class _DmChain(torch.autograd.Function):
    """Forward only. Under autograd the engine routes around this Function
    (the two-sided SEL chain has an adjoint backward); a backward that
    reaches it raises instead of returning zeros or running the plain
    version."""

    @staticmethod
    def forward(ctx, enc, rot_mats, strength, k: int, wires: int, kind: str,
                ry: bool):
        tensor = torch.is_tensor(strength)
        return torch.ops.qiddm.dm_chain.default(
            enc, _to_g8(rot_mats), strength if tensor else None,
            0.0 if tensor else float(strength), k, wires, KIND_IDS[kind], ry)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the density-matrix block kernel is forward-only: differentiate "
            "the dm path through its two-sided SEL-chain route (the engine "
            "takes it whenever autograd records)")


def dm_chain(enc, rot_mats, k: int, wires: int, kind: str, strength,
             ry: bool = False):
    """The density-matrix re-uploading block from |0...0><0...0|.

    enc: (b, 2**w) complex per-sample RZ phases (``rz_phases``), applied at
    the start of every spectrum layer; with ``ry`` the (b, w) real RY
    angles instead, RY(x_j) on both sides of every wire j. rot_mats:
    (L*k, w, 2, 2) complex per-wire rotations; the CZ ring after SEL layer
    li has range ``sel_ranges(k, w)[li]``, restarting every spectrum layer.
    kind: a key of :data:`KIND_IDS`; strength: a float, or a 0-d float32
    tensor on the input's device (read on the device: no host sync).
    Returns rho, (b, 2**w, 2**w) complex64. Forward only.
    """
    if kind not in KIND_IDS:
        raise ValueError(f"no closed-form kernel channel {kind!r} (known: "
                         f"{sorted(KIND_IDS)})")
    if ry and enc.shape[-1] != wires:
        raise ValueError(f"angles of {enc.shape[-1]} columns do not fit "
                         f"{wires} wires")
    if not ry and enc.shape[-1] != 2**wires:
        raise ValueError(f"phases of {enc.shape[-1]} entries do not hold "
                         f"{wires} wires")
    if rot_mats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no dm-chain path for device {rot_mats.device}")
    return _DmChain.apply(enc, rot_mats, strength, k, wires, kind, ry)
