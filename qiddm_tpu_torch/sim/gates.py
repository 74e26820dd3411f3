"""Parameterized gate matrices (counterpart of ``qiddm_tpu/sim/gates.py``).

Conventions are the JAX package's: wire 0 is the most significant bit of the
basis index, and ``Rot(phi, theta, omega) = RZ(omega) @ RY(theta) @ RZ(phi)``
(the ZYZ decomposition of the entangling-layer template).
"""

from __future__ import annotations

import torch


def _unit(angle):
    """``exp(1j * angle)`` for a real tensor."""
    return torch.complex(torch.cos(angle), torch.sin(angle))


def ry_matrix(theta):
    """``RY(t) = [[cos t/2, -sin t/2], [sin t/2, cos t/2]]``: a real tensor
    of any shape -> (..., 2, 2) complex."""
    c = torch.cos(theta / 2)
    s = torch.sin(theta / 2)
    m = torch.stack([torch.stack([c, -s], dim=-1),
                     torch.stack([s, c], dim=-1)], dim=-2)
    return m.to(torch.complex128 if m.dtype == torch.float64
                else torch.complex64)


def rot_matrix(phi, theta, omega):
    """General single-qubit rotation ``Rot(phi, theta, omega)``.

    Real tensors of any common leading shape -> (..., 2, 2) complex::

        [[e^{-i(phi+omega)/2} cos(t/2), -e^{i(phi-omega)/2} sin(t/2)],
         [e^{-i(phi-omega)/2} sin(t/2),  e^{i(phi+omega)/2} cos(t/2)]]
    """
    c = torch.cos(theta / 2)
    s = torch.sin(theta / 2)
    a = _unit(-0.5 * (phi + omega)) * c
    b = -_unit(0.5 * (phi - omega)) * s
    cc = _unit(-0.5 * (phi - omega)) * s
    d = _unit(0.5 * (phi + omega)) * c
    return torch.stack(
        [torch.stack([a, b], dim=-1), torch.stack([cc, d], dim=-1)], dim=-2)


# --- weight re-mappings -----------------------------------------------------

def qw_tanh(w):
    """``qw_map.tanh``: unbounded weights mapped into ``[-pi, pi]`` (the
    Qdense circuit's re-mapping, reference nn/qdense.py:45)."""
    return torch.pi * torch.tanh(w)


def plain_tanh(w):
    """Plain tanh mapping (reference nn/qdense.py:97 uses ``torch.tanh``)."""
    return torch.tanh(w)


WEIGHT_MAPS = {
    "none": lambda w: w,
    "qw_tanh": qw_tanh,
    "tanh": plain_tanh,
}
