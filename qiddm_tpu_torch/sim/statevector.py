"""Batched statevector primitives (counterpart of
``qiddm_tpu/sim/statevector.py``).

A batch of states is a ``(batch, 2**wires)`` complex tensor; the gate-chain
kernel's native layout is a pair of ``(2**wires, batch)`` float32 planes
(real, imaginary), and the ``*_planes`` functions stay in that layout.
Wire 0 is the most significant bit of the basis index.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .gates import ry_matrix


@functools.lru_cache(maxsize=None)
def bit_table(wires: int) -> np.ndarray:
    """(2**wires, wires) int8 table; column j = bit of wire j (wire 0 = MSB).

    wires == 0 yields the (1, 0) empty table."""
    if wires == 0:
        return np.zeros((1, 0), dtype=np.int8)
    idx = np.arange(2**wires, dtype=np.int64)
    cols = [(idx >> (wires - 1 - j)) & 1 for j in range(wires)]
    return np.stack(cols, axis=1).astype(np.int8)


@functools.lru_cache(maxsize=None)
def z_sign_table(wires: int) -> np.ndarray:
    """(2**wires, wires) float64: +1 where the wire bit is 0, -1 where it
    is 1. Used for diagonal RZ phases and for PauliZ expectations."""
    return (1.0 - 2.0 * bit_table(wires)).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _z_signs_on(wires: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """:func:`z_sign_table` as a tensor, copied to ``device`` once."""
    return torch.as_tensor(z_sign_table(wires), dtype=dtype, device=device)


def zero_state(batch: int, wires: int, *, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """|0...0> computational-basis states: (batch, 2**wires) complex."""
    state = torch.zeros((batch, 2**wires), dtype=dtype, device=device)
    state[:, 0] = 1.0
    return state


def amplitude_rows(x: torch.Tensor, wires: int,
                   pad_with: float = 0.0) -> torch.Tensor:
    """The real amplitudes of :func:`amplitude_embed`: ``x`` padded with
    the constant ``pad_with`` to ``2**wires`` features, then each row
    L2-normalized (norm floored at 1e-12). (batch, n) -> (batch, 2**wires)."""
    b, n = x.shape
    dim = 2**wires
    if n > dim:
        raise ValueError(f"{n} features do not fit in {wires} wires")
    if n < dim:
        x = torch.cat([x, x.new_full((b, dim - n), pad_with)], dim=-1)
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-12)


def amplitude_embed(x: torch.Tensor, wires: int, pad_with: float = 0.0, *,
                    dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """AmplitudeEmbedding with constant padding and L2 normalization:
    (batch, n_features <= 2**wires) real -> (batch, 2**wires) complex
    states (reference nn/qdense.py:41-43 pads with 0.1)."""
    return amplitude_rows(x, wires, pad_with).to(dtype)


def rz_phases(x: torch.Tensor, wires: int) -> torch.Tensor:
    """Diagonal of ``prod_j RZ_j(x[:, j])`` over the full space.

    x: (batch, wires) angles -> (batch, 2**wires) complex unit phases; the
    phase angle of basis state i is ``-0.5 * sum_j sign_j(i) * x_j``.
    """
    signs = _z_signs_on(wires, x.dtype, x.device)  # (d, w)
    angles = -0.5 * (x @ signs.T)
    return torch.complex(torch.cos(angles), torch.sin(angles))


def rz_phase_planes(x: torch.Tensor, wires: int):
    """:func:`rz_phases` in the kernel's (d, B) float32 plane layout:
    ``(cos, sin)`` of the phase angles, built transposed from the start."""
    signs = _z_signs_on(wires, torch.float32, x.device)  # (d, w)
    angles = -0.5 * (signs @ x.to(torch.float32).T)
    return torch.cos(angles), torch.sin(angles)


def ry_product_state(x: torch.Tensor, wires: int, *,
                     dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """``prod_j RY_j(x_j) |0...0>`` (AngleEmbedding with rotation 'Y'): the
    product state whose wire j has amplitudes ``(cos x_j/2, sin x_j/2)``.
    (batch, wires) -> (batch, 2**wires) of ``dtype``; a real ``dtype``
    gives the real amplitudes."""
    bits = _z_signs_on(wires, x.dtype, x.device) < 0  # (d, w): bit is 1
    c = torch.cos(x / 2)[:, None, :]  # (b, 1, w)
    s = torch.sin(x / 2)[:, None, :]
    return torch.prod(torch.where(bits[None], s, c), dim=-1).to(dtype)


def apply_1q(states: torch.Tensor, gate: torch.Tensor, wire: int,
             wires: int) -> torch.Tensor:
    """A single-qubit gate on ``wire`` of (batch, 2**wires) states; ``gate``
    is (2, 2) or one per sample, (batch, 2, 2)."""
    b = states.shape[0]
    st = states.reshape(b, 2**wire, 2, 2 ** (wires - wire - 1))
    if gate.ndim == 2:
        out = torch.einsum("xy,blyr->blxr", gate, st)
    else:
        out = torch.einsum("bxy,blyr->blxr", gate, st)
    return out.reshape(b, -1)


def ry_gates(x: torch.Tensor, dtype: torch.dtype = torch.complex64):
    """Per-sample RY matrices: (B, wires) angles -> (B, wires, 2, 2)."""
    return ry_matrix(x).to(dtype)


def apply_ry_all(states: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """RY(x[:, j]) on every wire j of (batch, 2**w) states (the mid-circuit
    Y re-upload, reference nn/qdense.py:602)."""
    wires = int(math.log2(states.shape[-1]))
    gates = ry_gates(x, dtype=states.dtype)
    for j in range(wires):
        states = apply_1q(states, gates[:, j], j, wires)
    return states


def probs_from_planes(sr: torch.Tensor, si: torch.Tensor) -> torch.Tensor:
    """|psi|^2 readout from (d, B) state planes -> (B, d)."""
    return (sr * sr + si * si).T


def expval_z_from_planes(sr: torch.Tensor, si: torch.Tensor) -> torch.Tensor:
    """PauliZ expectations from (d, B) state planes -> (B, wires).

    ``signs.T @ p`` is (w, d) @ (d, B): the contraction absorbs the layout
    change, so no (B, d) transpose is materialized."""
    wires = int(math.log2(sr.shape[0]))
    p = sr * sr + si * si
    signs = _z_signs_on(wires, p.dtype, p.device)
    return (signs.T @ p).T


def apply_unitary(states: torch.Tensor, unitary: torch.Tensor) -> torch.Tensor:
    """``out[b] = U @ states[b]`` as one complex matmul ``states @ U.T``.

    states: (batch, 2**w); unitary: (2**w, 2**w)."""
    return states @ unitary.T


def probs(states: torch.Tensor) -> torch.Tensor:
    """|psi|^2 readout of (batch, 2**w) complex states."""
    return states.real ** 2 + states.imag ** 2


def expval_z(states: torch.Tensor) -> torch.Tensor:
    """PauliZ expectation on every wire -> (batch, wires)."""
    wires = int(math.log2(states.shape[-1]))
    p = probs(states)
    return p @ _z_signs_on(wires, p.dtype, p.device)
