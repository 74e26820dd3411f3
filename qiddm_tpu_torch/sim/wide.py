"""Wide re-uploading chains (11-20 wires) by grouped Kronecker
contractions (counterpart of ``qiddm_tpu/sim/wide.py``).

Per sublayer, the ``w`` per-wire rotations are Kronecker-composed into
``ceil(w / 7)`` group matrices of at most 128 x 128 (:func:`group_sizes`,
a balanced partition) and applied to the state's group bit axes; then the
CZ ring's sign diagonal. The group matrices are assembled outside the
chain's autograd Function (``sel._batched_kron_chain`` on the (2, 2)
gates: tiny tensors), so plain autograd carries ``dG`` back to the
rotation angles, as ``_make_wide_chain`` leaves it to JAX's autodiff.

The chain itself is :func:`wide_kernel.wide_chain_planes`: on the card
kernels #11 and #12 (one launch per wire group) or, with
``config.set_wide_kernel_variant("monolith")``, #9 and #10 (the whole
chain in one launch); their plain versions on the CPU. The engine's
``reupload_block`` calls it for RZ-encoded blocks with a CZ ring; the
routes it does not take (an RY encode or a CNOT ring above 10 wires, the
SEL chain of the QNN/Qdense families above 12) raise there, naming
ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import torch

from .. import config as _config
from .sel import _batched_kron_chain


def group_sizes(wires: int) -> tuple[int, ...]:
    """Balanced wire partition with every group at most
    ``config.MAX_GROUP_BITS`` wires: 16 -> (6, 5, 5), 20 -> (7, 7, 6),
    11 -> (6, 5)."""
    if wires <= 0:
        raise ValueError(f"wires must be positive, got {wires}")
    n = -(-wires // _config.MAX_GROUP_BITS)
    base, rem = divmod(wires, n)
    return tuple(base + (1 if i < rem else 0) for i in range(n))


def _offsets(sizes) -> tuple[int, ...]:
    """Bit offset of each group, wire 0 (the most significant bit) first."""
    offs, o = [], 0
    for s in sizes:
        offs.append(o)
        o += s
    return tuple(offs)


def group_gates(mats: torch.Tensor, sizes) -> tuple[torch.Tensor, ...]:
    """Kronecker-compose per-wire gates into group matrices.

    mats: (..., wires, 2, 2) -> a tuple over groups of (..., 2**s, 2**s),
    differentiable by plain autograd."""
    return tuple(_batched_kron_chain(mats[..., off:off + s, :, :])
                 for off, s in zip(_offsets(sizes), sizes))
