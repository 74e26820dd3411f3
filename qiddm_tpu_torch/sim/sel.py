"""StronglyEntanglingLayers (SEL) as dense composed unitaries
(counterpart of ``qiddm_tpu/sim/sel.py``).

Per layer: a 3-parameter rotation on every wire, then a ring of CZ gates
whose range cycles ``r_l = (l mod (wires-1)) + 1``. A block does not depend
on the data, so at a batch of at least ``2**wires`` it is composed once into
a ``(2**w, 2**w)`` unitary and applied with one complex matmul. Only the CZ
ring of the re-uploading family is ported; the CNOT ring is ROADMAP Queue 1
item 7.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .gates import rot_matrix
from .statevector import bit_table


def sel_ranges(n_layers: int, n_wires: int) -> list[int]:
    """Default imprimitive ranges: ``r_l = (l % (n_wires-1)) + 1``."""
    if n_wires == 1:
        return [0] * n_layers
    return [(l % (n_wires - 1)) + 1 for l in range(n_layers)]


@functools.lru_cache(maxsize=None)
def cz_ring_signs(wires: int, rng: int) -> np.ndarray:
    """Diagonal of the CZ ring ``prod_j CZ(j, (j+rng) % wires)``.

    CZ gates commute, so the ring is the product of their +-1 diagonals.
    Returns (2**wires,) float64 of +-1.
    """
    bits = bit_table(wires).astype(np.int64)
    signs = np.ones(2**wires, dtype=np.int64)
    if wires == 1 or rng == 0:
        return signs.astype(np.float64)
    for j in range(wires):
        k = (j + rng) % wires
        signs *= 1 - 2 * (bits[:, j] & bits[:, k])
    return signs.astype(np.float64)


def _batched_kron_chain(mats: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker product over the wire axis.

    mats: (..., wires, 2, 2) -> (..., 2**wires, 2**wires), wire 0 = MSB.
    Built by 2x2 block assembly from the least significant wire up
    (``u <- kron(m_j, u)``), ``wires - 1`` steps for any leading shape.
    """
    wires = mats.shape[-3]
    u = mats[..., wires - 1, :, :]
    for j in range(wires - 2, -1, -1):
        m = mats[..., j, :, :]
        top = torch.cat([m[..., 0:1, 0:1] * u, m[..., 0:1, 1:2] * u], dim=-1)
        bot = torch.cat([m[..., 1:2, 0:1] * u, m[..., 1:2, 1:2] * u], dim=-1)
        u = torch.cat([top, bot], dim=-2)
    return u


def _entangled_layers(weights: torch.Tensor,
                      imprimitive: str = "cz") -> torch.Tensor:
    """Every layer's (rotation-kron x ring) unitary.

    weights: (..., layers, wires, 3) -> (..., layers, d, d). The range cycle
    runs over the ``layers`` axis, so a (n_blocks, k, wires, 3) input gives
    the re-uploading family's per-block cycle.
    """
    if imprimitive != "cz":
        raise NotImplementedError(
            f"imprimitive={imprimitive!r}: only the CZ ring is ported "
            f"(CNOT ring: ROADMAP Queue 1 item 7)")
    layers, wires = weights.shape[-3], weights.shape[-2]
    mats = rot_matrix(weights[..., 0], weights[..., 1], weights[..., 2])
    layer_u = _batched_kron_chain(mats)
    if wires == 1:
        return layer_u
    signs = np.stack([cz_ring_signs(wires, r)
                      for r in sel_ranges(layers, wires)])
    signs = torch.as_tensor(signs[:, :, None], dtype=layer_u.real.dtype,
                            device=layer_u.device)
    return signs * layer_u


def sel_unitaries(weights: torch.Tensor,
                  imprimitive: str = "cz") -> torch.Tensor:
    """Block composition for the re-uploading family.

    weights: (n_blocks, k, wires, 3) -> (n_blocks, d, d), each block's k
    layers multiplied out (``U = U_{k-1} ... U_1 U_0``).
    """
    layer_u = _entangled_layers(weights, imprimitive)
    u = layer_u[:, 0]
    for l in range(1, layer_u.shape[1]):
        u = layer_u[:, l] @ u
    return u
