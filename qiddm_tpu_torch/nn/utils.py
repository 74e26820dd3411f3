"""NN utilities (counterpart of ``qiddm_tpu/nn/utils.py``): crop and pad
alignment of feature maps and the two label embeddings.

Reference: nn/utils.py (autocrop:7, autopad:22, sinusoidal label
embedding:42-55, binary-split embedding:58-71), and the QASM bridge the
reference keeps here (nn/utils.py:77-129), through ``sim/qasm.py``.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F

def autocrop(x: torch.Tensor, y: torch.Tensor):
    """Center-crop y to x's spatial size (reference nn/utils.py:7-19)."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    if xs > ys:
        warnings.warn("x is larger than y. Cropping x to match y")
        return autocrop(y, x)
    y_cropped = y[
        :, :,
        (ys[2] - xs[2]) // 2: (ys[2] + xs[2]) // 2,
        (ys[3] - xs[3]) // 2: (ys[3] + xs[3]) // 2,
    ]
    return x, y_cropped


def autopad(x: torch.Tensor, y: torch.Tensor):
    """Zero-pad y to x's spatial size, ``ceil`` of the difference before
    and ``floor`` after, so an odd difference puts the extra row and
    column first (reference nn/utils.py:22-39)."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    if xs < ys:
        warnings.warn("x is smaller than y. Padding x to match y")
        return autopad(y, x)
    ph, pw = xs[2] - ys[2], xs[3] - ys[3]
    # F.pad lists the last axis first
    y_padded = F.pad(y, (math.ceil(pw / 2), math.floor(pw / 2),
                         math.ceil(ph / 2), math.floor(ph / 2)))
    return x, y_padded


def _labels(labels, device) -> torch.Tensor:
    if labels is None:
        raise ValueError("a directed model needs its labels y")
    return torch.as_tensor(labels, device=device).reshape(-1)


def _get_label_embedding_1(labels, width: int, height: int, *,
                           device=None) -> torch.Tensor:
    """Sinusoidal label mask ``0.1*sin(label + arange(width)/20)`` broadcast
    to (b, 1, width, height) (reference nn/utils.py:42-55)."""
    labels = _labels(labels, device).to(torch.float32)
    ramp = torch.arange(width, dtype=torch.float32,
                        device=labels.device) / 20.0
    mask = 0.1 * torch.sin(labels[:, None] + ramp[None, :])  # (b, w)
    return mask[:, None, :, None].expand(len(labels), 1, width, height)


def _get_label_embedding_2(labels, width: int, height: int, *,
                           device=None) -> torch.Tensor:
    """Binary half-split mask: 0.1 over the first ``width // 2`` rows for
    label 0, over the rest for label 1 (reference nn/utils.py:58-71)."""
    labels = _labels(labels, device)
    batch = labels.shape[0]
    is0 = (labels == 0).to(torch.float32).reshape(batch, 1, 1, 1) * 0.1
    is1 = (labels == 1).to(torch.float32).reshape(batch, 1, 1, 1) * 0.1
    top = is0.expand(batch, 1, width // 2, height)
    bottom = is1.expand(batch, 1, width - width // 2, height)
    return torch.cat([top, bottom], dim=2)


get_label_embedding = _get_label_embedding_1


# --- QASM bridge (reference nn/utils.py:77-129 keeps these here) -----------

def circuit_to_qasm(weights, wires, inp):
    from ..sim import qasm

    return qasm.circuit_to_qasm(weights, wires, inp)


def repeat_qasm(qasm_str, wires, ancilla, reps):
    from ..sim import qasm

    return qasm.repeat_qasm(qasm_str, wires, ancilla, reps)


def sample_from_qiskit(qasm_str, backend="statevector_simulator", shots=None,
                       device="cuda"):
    """Name kept for parity with reference nn/utils.py:114; runs the
    circuit on ``device`` (the card by default) and draws the shots with
    the native engine instead of qiskit-aer."""
    from ..sim import qasm

    return qasm.sample_from_qasm(qasm_str, shots=shots, device=device)
