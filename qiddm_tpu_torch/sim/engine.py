"""Circuit engine for the re-uploading family (counterpart of the
clean-statevector branch of ``qiddm_tpu/sim/engine.py::reupload_block``).

A block is L x [RZ encode -> SEL(k, CZ ring)] followed by a readout. Two
routes, chosen from the batch size:

* batch < 2**wires: the gate chain (``gate_kernel.gate_chain_planes``) on
  (d, B) float32 planes — the CUDA kernels on the card (forward, and the
  adjoint backward under autograd), their plain versions on the CPU;
* batch >= 2**wires: each block of k layers composed into one unitary and
  applied with complex matmuls, which pays once the batch exceeds the
  state dimension; autograd differentiates it, as XLA does in JAX.

Noise channels, trajectories, the mesh-sharded statevector, the RY encode,
the CNOT ring and the wide routes beyond the kernel's width raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import math

import torch

from .. import config as _config
from .gate_kernel import gate_chain_planes
from .gates import rot_matrix
from .sel import sel_unitaries
from .statevector import (
    apply_unitary,
    expval_z,
    expval_z_from_planes,
    probs,
    probs_from_planes,
    rz_phase_planes,
    rz_phases,
    zero_state,
)


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
        raise NotImplementedError(
            "noise channels and trajectories: ROADMAP Queue 1 item 8")
    if encode not in ("rz", "rz_halfpi"):
        raise NotImplementedError(
            f"encode={encode!r}: ROADMAP Queue 1 item 7")
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
        if wires > _config.KERNEL_MAX_WIRES:
            raise NotImplementedError(
                f"{wires} wires at batch {batch}: the wide gate-level "
                f"routes are ROADMAP Queue 1 item 5")
        if cdtype != torch.complex64:
            raise NotImplementedError(
                "the gate chain runs float32 planes; the complex128 "
                "per-layer-unitary route is ROADMAP Queue 1 item 5")
        flat = block_weights.reshape(L * k, wires, 3)
        mats = rot_matrix(flat[..., 0], flat[..., 1], flat[..., 2])
        pr, pi = rz_phase_planes(x_enc, wires)
        sr, si = gate_chain_planes(pr, pi, mats, k, wires)
        if readout == "probs":
            return probs_from_planes(sr, si)
        return expval_z_from_planes(sr, si)

    rdtype = cdtype.to_real()
    us = sel_unitaries(block_weights.to(rdtype), imprimitive)
    phases = rz_phases(x_enc.to(rdtype), wires)
    states = zero_state(batch, wires, dtype=cdtype, device=x_enc.device)
    for u in us:
        states = apply_unitary(states * phases, u)
    if readout == "probs":
        return probs(states)
    return expval_z(states)
