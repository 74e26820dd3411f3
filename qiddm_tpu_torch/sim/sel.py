"""StronglyEntanglingLayers (SEL) as dense composed unitaries
(counterpart of ``qiddm_tpu/sim/sel.py``).

Per layer: a 3-parameter rotation on every wire, then a ring of CZ or
CNOT gates whose range cycles ``r_l = (l mod (wires-1)) + 1``. A CZ ring is
a diagonal of signs, a CNOT ring a basis permutation. A block does not
depend on the data, so at a batch of at least ``2**wires`` it is composed
once into a ``(2**w, 2**w)`` unitary and applied with one complex matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .gates import rot_matrix
from .statevector import apply_1q

# Calls of the routes no kernel takes (the JAX package runs them in XLA),
# since the last reset: "gates" (sel_apply_gates), "adjoint" (the per-gate
# adjoint chains), "wide" (the grouped chains), "amp_xla" (the trajectory
# backend's amplitude-damping pass in PyTorch). chip_smoke.py reads them to
# show which route ran. A dict mutated in place: engine.ROUTE_CALLS is the
# same object.
ROUTE_CALLS = {"gates": 0, "adjoint": 0, "wide": 0, "amp_xla": 0}


def reset_route_calls() -> None:
    for key in ROUTE_CALLS:
        ROUTE_CALLS[key] = 0


def sel_ranges(n_layers: int, n_wires: int) -> list[int]:
    """Default imprimitive ranges: ``r_l = (l % (n_wires-1)) + 1``."""
    if n_wires == 1:
        return [0] * n_layers
    return [(l % (n_wires - 1)) + 1 for l in range(n_layers)]


@functools.lru_cache(maxsize=None)
def cz_ring_signs(wires: int, rng: int) -> np.ndarray:
    """Diagonal of the CZ ring ``prod_j CZ(j, (j+rng) % wires)``.

    CZ gates commute, so the ring is the product of their +-1 diagonals:
    -1 where an odd number of the pairs (j, j+rng) have both bits set.
    Returns (2**wires,) float64 of +-1.
    """
    idx = np.arange(2**wires, dtype=np.int64)
    parity = np.zeros_like(idx)
    if wires > 1 and rng != 0:
        for j in range(wires):
            k = (j + rng) % wires
            parity ^= (idx >> (wires - 1 - j)) & (idx >> (wires - 1 - k)) & 1
    return (1 - 2 * parity).astype(np.float64)


@functools.lru_cache(maxsize=None)
def cnot_ring_perm(wires: int, rng: int) -> np.ndarray:
    """Row-gather indices realizing the sequential CNOT ring.

    The ring applies ``CNOT(j, (j+rng) % wires)`` for j = 0..wires-1 *in
    order* (later gates see earlier gates' flips). Each basis state maps to
    exactly one basis state: target_bit ^= control_bit sequentially, here
    on every basis index at once.

    Returns ``inv`` such that ``(U_ring @ M) == M[inv, :]`` for any matrix M.
    """
    dim = 2**wires
    if wires == 1 or rng == 0:
        return np.arange(dim)
    f = np.arange(dim, dtype=np.int64)
    for j in range(wires):
        k = (j + rng) % wires
        f ^= ((f >> (wires - 1 - j)) & 1) << (wires - 1 - k)
    inv = np.empty(dim, dtype=np.int64)
    inv[f] = np.arange(dim)
    return inv


@functools.lru_cache(maxsize=None)
def ring_row(wires: int, rng: int, imprimitive: str, device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    """One ring of range ``rng`` as a tensor on ``device``, made once: the
    CZ ring's signs in the real ``dtype`` of the states, or the CNOT ring's
    gather indices (int64). A copy from the host on every call would wait
    for the device."""
    if imprimitive == "cz":
        return torch.as_tensor(cz_ring_signs(wires, rng), dtype=dtype,
                               device=device)
    if imprimitive == "cnot":
        return torch.as_tensor(cnot_ring_perm(wires, rng), device=device)
    raise ValueError(f"unknown imprimitive {imprimitive!r}")


def apply_ring(states: torch.Tensor, row: torch.Tensor,
               imprimitive: str) -> torch.Tensor:
    """A ring row on (B, 2**w) states: the CZ signs' multiply or the CNOT
    gather. The same call undoes a ring with its inverse row (a CZ row is
    its own inverse; a CNOT row's inverse is the inverse permutation), which
    is also the ring's adjoint."""
    if imprimitive == "cz":
        return states * row
    return states.index_select(1, row)


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
    the re-uploading family's per-block cycle, and a (depth, wires, 3)
    input the SEL chain's cycle over its full depth.
    """
    if imprimitive not in ("cz", "cnot"):
        raise ValueError(f"unknown imprimitive {imprimitive!r}")
    layers, wires = weights.shape[-3], weights.shape[-2]
    mats = rot_matrix(weights[..., 0], weights[..., 1], weights[..., 2])
    layer_u = _batched_kron_chain(mats)
    if wires == 1:
        return layer_u
    ranges = sel_ranges(layers, wires)
    if imprimitive == "cz":
        signs = np.stack([cz_ring_signs(wires, r) for r in ranges])
        signs = torch.as_tensor(signs[:, :, None], dtype=layer_u.real.dtype,
                                device=layer_u.device)
        return signs * layer_u
    inv = np.stack([cnot_ring_perm(wires, r) for r in ranges])
    rows = torch.as_tensor(inv[:, :, None], device=layer_u.device)
    return torch.gather(layer_u, -2, rows.expand(layer_u.shape))


def sel_unitary(weights: torch.Tensor,
                imprimitive: str = "cnot") -> torch.Tensor:
    """Compose an SEL block into a dense unitary.

    weights: (depth, wires, 3) -> (2**wires, 2**wires), ``U = U_{depth-1}
    ... U_1 U_0``, with the range cycling over the full depth.
    """
    lus = _entangled_layers(weights, imprimitive)
    acc = lus[0]
    for u in lus[1:]:
        acc = u @ acc
    return acc


def sel_layer_unitaries(weights: torch.Tensor,
                        imprimitive: str = "cz") -> torch.Tensor:
    """Per-layer entangled unitaries without composition, for the
    re-uploading family's per-layer route.

    weights: (n_blocks, k, wires, 3) -> (n_blocks, k, d, d): each layer's
    (rotation-kron x ring) unitary, the range cycle restarting every
    spectrum layer (block of k layers).
    """
    return _entangled_layers(weights, imprimitive)


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


def sel_apply_gates(states: torch.Tensor, weights: torch.Tensor,
                    imprimitive: str = "cnot") -> torch.Tensor:
    """Apply SEL gate by gate (counterpart of ``qiddm_tpu/sim/sel.py:197``).

    states: (B, 2**w) complex; weights: (depth, wires, 3). Per layer, the
    rotation on every wire (``apply_1q``), then the ring: the CZ signs'
    multiply or the CNOT gather. The range cycles over the full depth (one
    deep template). Plain PyTorch, differentiated by autograd, which keeps
    every intermediate state: O(depth * wires) of them.
    """
    ROUTE_CALLS["gates"] += 1
    layers, wires, _ = weights.shape
    mats = rot_matrix(weights[..., 0], weights[..., 1],
                      weights[..., 2]).to(states.dtype)
    rdtype = states.real.dtype
    for l, rng in enumerate(sel_ranges(layers, wires)):
        for j in range(wires):
            states = apply_1q(states, mats[l, j], j, wires)
        if wires > 1:
            states = apply_ring(
                states, ring_row(wires, rng, imprimitive, states.device,
                                 rdtype), imprimitive)
    return states
