"""Circuit engine (counterpart of the clean-statevector branches of
``qiddm_tpu/sim/engine.py``: ``reupload_block``, ``qdense_circuit``,
``qnn_circuit``).

* ``reupload_block`` (QIDDM family): L x [RZ or RY encode -> SEL(k, CZ
  ring)] followed by a readout.
* ``qdense_circuit`` (Qdense family): amplitude embedding -> SEL(depth),
  CNOT ring by default -> probabilities.
* ``qnn_circuit`` (QNN family): one RZ encode of |0...0>, or the RY product
  state (QNN_A) -> SEL(depth), CZ ring by default -> PauliZ expectations or
  probabilities.

Each takes one of two routes, chosen from the batch size:

* batch < 2**wires: a gate chain on (d, B) float32 planes —
  ``gate_kernel.gate_chain_planes`` (RZ) and ``ry_kernel.ry_chain_planes``
  (RY) for the re-uploading blocks, ``sel_kernel.sel_chain_planes`` for
  the SEL chains (both rings); the CUDA kernels on the card (forward, and
  the adjoint backward under autograd), their plain versions on the CPU;
* batch >= 2**wires: the layers composed into one unitary per block and
  applied with complex matmuls, which pays once the batch exceeds the
  state dimension; autograd differentiates it, as XLA does in JAX.

Noise channels, trajectories, the mesh-sharded statevector, the
re-uploading blocks' CNOT ring and the wide routes beyond the kernels'
width raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import math

import torch

from .. import config as _config
from .gate_kernel import gate_chain_planes
from .gates import WEIGHT_MAPS, rot_matrix
from .ry_kernel import ry_chain_planes
from .sel import sel_unitaries, sel_unitary
from .sel_kernel import sel_chain_planes
from .statevector import (
    amplitude_embed,
    amplitude_rows,
    apply_ry_all,
    apply_unitary,
    expval_z,
    expval_z_from_planes,
    probs,
    probs_from_planes,
    ry_product_state,
    rz_phase_planes,
    rz_phases,
    zero_state,
)

_NOISE = "noise channels and trajectories: ROADMAP Queue 1 item 8"
_ENCODES = ("rz", "rz_halfpi", "ry")


def _check_encode(encode: str) -> None:
    if encode not in _ENCODES:
        raise ValueError(f"unknown encode {encode!r} (known: {_ENCODES})")


def _check_chain_route(wires: int, batch: int, cdtype) -> None:
    """The plane kernels' limits: at most ``KERNEL_MAX_WIRES`` wires, and
    float32 planes (complex64)."""
    if wires > _config.KERNEL_MAX_WIRES:
        raise NotImplementedError(
            f"{wires} wires at batch {batch}: the wide gate-level "
            f"routes are ROADMAP Queue 1 item 5")
    if cdtype != torch.complex64:
        raise NotImplementedError(
            "the gate chains run float32 planes; the complex128 "
            "per-layer-unitary route is ROADMAP Queue 1 item 5")


def reupload_block(x_enc: torch.Tensor, block_weights: torch.Tensor, *,
                   encode: str = "rz", imprimitive: str = "cz",
                   noise=None, readout: str = "probs", cdtype=None,
                   mesh=None, n_traj: int = 0) -> torch.Tensor:
    """One N-block: L x (encode -> SEL(k)) -> readout.

    x_enc: (batch, wires) encoding angles, re-uploaded in every spectrum
    layer; block_weights: (L, k, wires, 3). readout "probs" gives
    (batch, 2**w), "expvalz" gives (batch, wires).
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded statevector: ROADMAP Queue 1 item 11")
    if noise is not None or n_traj:
        raise NotImplementedError(_NOISE)
    _check_encode(encode)
    if imprimitive != "cz":
        raise NotImplementedError(
            f"imprimitive={imprimitive!r}: ROADMAP Queue 1 item 7")
    if readout not in ("probs", "expvalz"):
        raise ValueError(f"unknown readout {readout!r}")
    if cdtype is None:
        cdtype = _config.complex_dtype()
    L, k, wires, _ = block_weights.shape
    batch = x_enc.shape[0]
    if encode == "rz_halfpi":
        x_enc = (math.pi * 0.5) * x_enc

    if batch < 2**wires:
        _check_chain_route(wires, batch, cdtype)
        flat = block_weights.reshape(L * k, wires, 3)
        mats = rot_matrix(flat[..., 0], flat[..., 1], flat[..., 2])
        if encode == "ry":
            sr, si = ry_chain_planes(x_enc, mats, k, wires)
        else:
            pr, pi = rz_phase_planes(x_enc, wires)
            sr, si = gate_chain_planes(pr, pi, mats, k, wires)
        if readout == "probs":
            return probs_from_planes(sr, si)
        return expval_z_from_planes(sr, si)

    rdtype = cdtype.to_real()
    us = sel_unitaries(block_weights.to(rdtype), imprimitive)
    x_enc = x_enc.to(rdtype)
    phases = None if encode == "ry" else rz_phases(x_enc, wires)
    states = zero_state(batch, wires, dtype=cdtype, device=x_enc.device)
    for u in us:
        states = (apply_ry_all(states, x_enc) if phases is None
                  else states * phases)
        states = apply_unitary(states, u)
    if readout == "probs":
        return probs(states)
    return expval_z(states)


def _sel_small_batch(sr, si, w, imprimitive: str, cdtype):
    """Small-batch SEL application (batch < 2**wires) on (d, B) float32
    start-state planes: the SEL-chain kernel (its plain version on the
    CPU), complex64 only, up to ``KERNEL_MAX_WIRES`` wires. Returns the
    output planes.

    The JAX package picks among the Pallas kernel, the grouped-Kronecker
    and per-gate adjoint chains and a gate-by-gate ``lax.scan`` by backend
    and width; the port has the kernel route only, and the others raise."""
    _check_chain_route(w.shape[1], sr.shape[1], cdtype)
    mats = rot_matrix(w[..., 0], w[..., 1], w[..., 2])
    return sel_chain_planes(sr, si, mats, w.shape[1], imprimitive)


# ---------------------------------------------------------------------------
# qdense family
# ---------------------------------------------------------------------------

def qdense_circuit(x: torch.Tensor, weights: torch.Tensor, *, wires: int,
                   pad_with: float = 0.1, weight_map: str = "qw_tanh",
                   imprimitive: str = "cnot", noise=None, cdtype=None,
                   n_traj: int = 0) -> torch.Tensor:
    """AmplitudeEmbedding -> SEL -> probs.

    x: (batch, n_features); weights: (depth, wires, 3). Returns (batch,
    2**w) probabilities. Reference: nn/qdense.py:40-47 / :95-105.
    """
    if noise is not None or n_traj:
        raise NotImplementedError(_NOISE)
    if cdtype is None:
        cdtype = _config.complex_dtype()
    w = WEIGHT_MAPS[weight_map](weights)
    if x.shape[0] >= 2**wires:
        states = amplitude_embed(x, wires, pad_with, dtype=cdtype)
        u = sel_unitary(w.to(cdtype.to_real()), imprimitive)
        return probs(apply_unitary(states, u))
    # batch < state dim: the gate-level chain, O(depth w B d) against the
    # composed route's O(depth d^3); the ranges cycle over the full depth
    sr = amplitude_rows(x.to(torch.float32), wires, pad_with).T.contiguous()
    sr, si = _sel_small_batch(sr, torch.zeros_like(sr), w, imprimitive,
                              cdtype)
    return probs_from_planes(sr, si)


# ---------------------------------------------------------------------------
# qnn family
# ---------------------------------------------------------------------------

def qnn_circuit(x: torch.Tensor, weights: torch.Tensor, *,
                encode: str = "rz", imprimitive: str = "cz",
                weight_map: str = "none", noise=None,
                readout: str = "expvalz", cdtype=None,
                n_traj: int = 0) -> torch.Tensor:
    """Single encode -> SEL(depth) -> readout.

    x: (batch, wires); weights: (depth, wires, 3). readout "expvalz" gives
    (batch, wires), "probs" (batch, 2**wires).

    Faithfulness note: with RZ encoding on the fresh |0..0> state the input
    contributes only a global phase (reference nn/qdense.py:338-344 — the
    QNN circuit output is therefore input-independent; the surrounding
    linear layers do the learning). This reproduces that, so the gradient
    reaching ``x`` is zero up to float rounding.
    """
    if noise is not None or n_traj:
        raise NotImplementedError(_NOISE)
    _check_encode(encode)
    if readout not in ("probs", "expvalz"):
        raise ValueError(f"unknown readout {readout!r}")
    if cdtype is None:
        cdtype = _config.complex_dtype()
    batch, wires = x.shape
    w = WEIGHT_MAPS[weight_map](weights)
    if encode == "rz_halfpi":
        x = (math.pi * 0.5) * x
    if batch >= 2**wires:
        rdtype = cdtype.to_real()
        if encode == "ry":
            states = ry_product_state(x.to(rdtype), wires, dtype=cdtype)
        else:
            states = zero_state(batch, wires, dtype=cdtype, device=x.device)
            states = states * rz_phases(x.to(rdtype), wires)
        states = apply_unitary(states, sel_unitary(w.to(rdtype), imprimitive))
        return probs(states) if readout == "probs" else expval_z(states)
    if encode == "ry":
        # the RY product state is real
        sr = ry_product_state(x.to(torch.float32), wires,
                              dtype=torch.float32).T.contiguous()
        si = torch.zeros_like(sr)
    else:
        # |0...0> times the RZ phases keeps only row 0, whose phase angle
        # is -sum_j x_j / 2: the start planes are built directly
        angle = -0.5 * x.to(torch.float32).sum(dim=1)
        rest = angle.new_zeros((2**wires - 1, batch))
        sr = torch.cat([torch.cos(angle)[None], rest])
        si = torch.cat([torch.sin(angle)[None], rest])
    sr, si = _sel_small_batch(sr, si, w, imprimitive, cdtype)
    if readout == "probs":
        return probs_from_planes(sr, si)
    return expval_z_from_planes(sr, si)
