"""Kraus operators of the hardware-noise channels the reference sweeps
(counterpart of ``qiddm_tpu/sim/channels.py``).

The reference injects them per wire inside or after its circuits through an
``add_noise`` integer (reference nn/qdense.py:98-104, :174-180, :1410-1416)
and simulates them on a density matrix at test time (reference
src/mnist_noise.py:214-230). Strengths differ per model family; callers pass
them explicitly.

``add_noise`` codes:
  1 -> PhaseShift (Qdense family) or PhaseDamping (QIDDM family)
  2 -> AmplitudeDamping
  3 -> DepolarizingChannel
  4 -> the rotation-angle error: a deterministic over-rotation of the
       encoding angles by the intensity (``engine.noise_from_code``).

Each builder takes the strength as a Python float or as a 0-d tensor and
returns a list of (2, 2) complex128 tensors on the strength's device (the
CPU for a float). The operators are combinations of fixed basis matrices
with coefficients that are smooth functions of the strength, so a tensor
strength carries autograd and needs no host round trip.
"""

from __future__ import annotations

import math

import torch


def _basis(strength):
    """The matrices the builders combine, on the strength's device."""
    device = strength.device if torch.is_tensor(strength) else None
    t = lambda rows: torch.tensor(rows, dtype=torch.complex128,
                                  device=device)
    return {
        "E00": t([[1, 0], [0, 0]]), "E01": t([[0, 1], [0, 0]]),
        "E11": t([[0, 0], [0, 1]]), "I": t([[1, 0], [0, 1]]),
        "X": t([[0, 1], [1, 0]]), "Y": t([[0, -1j], [1j, 0]]),
        "Z": t([[1, 0], [0, -1]]),
    }


def _sqrt(v):
    if torch.is_tensor(v):
        return torch.sqrt(v)
    return math.sqrt(v)


def phase_shift(phi) -> list:
    """Unitary phase shift diag(1, e^{i phi}) as a single-element Kraus set."""
    e = _basis(phi)
    if torch.is_tensor(phi):
        return [e["E00"] + torch.exp(1j * phi) * e["E11"]]
    return [e["E00"] + complex(math.cos(phi), math.sin(phi)) * e["E11"]]


def phase_damping(gamma) -> list:
    e = _basis(gamma)
    return [e["E00"] + _sqrt(1.0 - gamma) * e["E11"],
            _sqrt(gamma) * e["E11"]]


def amplitude_damping(gamma) -> list:
    e = _basis(gamma)
    return [e["E00"] + _sqrt(1.0 - gamma) * e["E11"],
            _sqrt(gamma) * e["E01"]]


def depolarizing(p) -> list:
    e = _basis(p)
    s = _sqrt(p / 3.0)
    return [_sqrt(1.0 - p) * e["I"], s * e["X"], s * e["Y"], s * e["Z"]]


def kraus_for(kind: str, strength) -> list:
    if kind == "phase_shift":
        return phase_shift(strength)
    if kind == "phase_damping":
        return phase_damping(strength)
    if kind == "amplitude_damping":
        return amplitude_damping(strength)
    if kind == "depolarizing":
        return depolarizing(strength)
    raise ValueError(f"unknown channel kind {kind!r}")
