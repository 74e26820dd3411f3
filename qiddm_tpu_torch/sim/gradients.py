"""Parameter-shift gradients, vectorized (counterpart of the JAX package's
``sim/gradients.py``).

The reference differentiates most of its circuits with PennyLane's
``diff_method="parameter-shift"`` (e.g. nn/qdense.py:1296): two extra
circuit executions per trainable parameter. On a simulator backprop is
exact and cheaper, so the framework trains with autograd; this module is
for parity and validation, and is the gradient path real hardware would
take.

All 2P shifted circuits (P = parameter count) are evaluated through
``torch.func.vmap`` over the weights, in chunks of ``chunk`` when given.
The gate-chain and SEL-chain operators have batching rules that run the
circuit once for each shifted weight set, so on the card the kernel (#1 or
#5) launches 2P times; nothing runs a plain version there.

Validity: the two-term rule ``df/dt = (f(t + pi/2) - f(t - pi/2)) / 2``
holds for expectation values of circuits whose parameters enter through
single-qubit rotations with eigenvalues +-1/2 (RZ/RY/RX and each Rot
angle), exactly the reference's ansatz. It applies to the raw circuit
output (expvals or probs, which are projector expectations), not to
nonlinear post-processing.
"""

from __future__ import annotations

import math

import torch


def parameter_shift_grad(circuit_fn, weights: torch.Tensor,
                         chunk: int = 0) -> torch.Tensor:
    """Gradient of ``circuit_fn(weights) -> scalar`` by parameter shift.

    weights: any-shaped angle tensor entering via rotations. ``chunk`` > 0
    evaluates the 2P shifted circuits ``chunk`` at a time (memory
    control). Returns a tensor shaped like ``weights``.
    """
    flat = weights.detach().reshape(-1)
    P = flat.numel()
    eye = torch.eye(P, dtype=flat.dtype, device=flat.device) * (0.5 * math.pi)
    plus = (flat[None, :] + eye).reshape((P,) + weights.shape)
    minus = (flat[None, :] - eye).reshape((P,) + weights.shape)
    both = torch.cat([plus, minus], dim=0)  # (2P, ...)
    chunk_size = chunk if chunk and chunk < 2 * P else None
    with torch.no_grad():
        outs = torch.func.vmap(circuit_fn, chunk_size=chunk_size)(both)
    outs = outs.reshape(-1)
    return ((outs[:P] - outs[P:]) / 2.0).reshape(weights.shape)
