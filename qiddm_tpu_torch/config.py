"""Numeric configuration and device selection for qiddm_tpu_torch.

Counterpart of ``qiddm_tpu/config.py:150-208, 343-414``: the complex/real
dtype switch (complex64 by default, complex128 for tight parity work), the
width caps of the hand-written kernels (and the wide chain's group width),
the wide chain's kernel variant, the two modes that pick among the routes
no kernel takes (``adjoint_mode``, ``wide_mode``) and the density-matrix
backend's two strategy switches.

TF32 is switched off for every float32 product this package issues. The
JAX simulator pins ``precision="highest"`` on its contractions because
reduced-precision passes let probability sums drift by ~1e-3; TF32 keeps
about three decimal digits, so the port pins full float32 the same way:

* ``torch.backends.cuda.matmul.allow_tf32 = False`` (already PyTorch's
  default, stated here so that no other import can leave it on);
* ``torch.backends.cudnn.allow_tf32 = False`` (PyTorch's default is True).

Both are process-wide PyTorch settings, set when this module is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_X64 = False

# Widest circuit the gate-chain kernels (the RZ and RY re-upload chains)
# and the density-matrix kernel take: the JAX package's pallas_max_wires
# (qiddm_tpu/config.py:199). At w=10 one sample's state is 8 KB of shared
# memory.
KERNEL_MAX_WIRES = 10
# Widest circuit the SEL-chain kernels and the amplitude-damping trajectory
# kernel take: the JAX package's traj_pallas_max_wires
# (qiddm_tpu/config.py:218), the trajectory backend's tiled route. At w=12
# one sample's state is 32 KB of shared memory.
SEL_KERNEL_MAX_WIRES = 12
# Widest circuit the wide chain kernels take (sim/wide_kernel.py, kernels
# #9-#12): the JAX package's superstate width, TOTAL_BITS
# (qiddm_tpu/sim/pallas_wide_kernel.py:74). At w=20 one state plane pair is
# 8 MB a sample, held in device memory between the group passes.
WIDE_KERNEL_MAX_WIRES = 20
# Largest group of wires whose per-wire rotations compose into one group
# matrix: 7 bits, 128 x 128 (qiddm_tpu/sim/wide.py:366-370). The kernels of
# csrc/wide_chain.cu and csrc/wide_mono.cu are written for it: at most 3
# groups (20 wires) of at most 128 rows.
MAX_GROUP_BITS = 7
# The engine's wide route starts at KERNEL_MAX_WIRES + 1 = 11, not at the
# JAX kernel's MIN_WIRES = 13. On the TPU, widths 11-12 stay on the XLA
# grouped chain and the kernel packs 2**(20 - w) samples into one
# 2**20-amplitude superstate behind identity groups. The port keeps the
# (d, B) planes and applies the balanced groups group_sizes(w) directly,
# with no packing and no padding, so the same kernels serve 11-12 wires
# where the gate chains stop (at w=16 the groups (6, 5, 5) do 128 complex
# MACs an amplitude against 320 for the packed (7, 7, 6)).


def enable_x64(on: bool = True) -> None:
    """Switch the simulator's dtypes to float64/complex128."""
    global _X64
    _X64 = on


def real_dtype() -> torch.dtype:
    return torch.float64 if _X64 else torch.float32


def complex_dtype() -> torch.dtype:
    return torch.complex128 if _X64 else torch.complex64


# Which hand-written kernels serve the wide chain on the card
# (qiddm_tpu/config.py:343-362, wide_kernel_variant):
# * "scan" (the default, as in the JAX package): kernel #11 for each wire
#   group of each sublayer and #12 for its adjoint (csrc/wide_chain.cu);
# * "monolith": the whole L*k chain in one cooperative launch, #9 forward
#   and #10 backward (csrc/wide_mono.cu).
# Both run the same tensor-core units on the same tiles, so they give the
# same bits; on a CPU tensor both run the plain versions. The JAX package's set_wide_kernel_mode is not ported: its "off"
# is the XLA grouped chain, and on the card #11/#12 stand in for that route,
# so a mode that turned the kernels off would put a plain version on the main
# path. Nor is its depth guard (qiddm_tpu/sim/wide.py:260-279): it guards a
# Mosaic compile that failed beyond L = 1, and nvcc compiles #9/#10 at any
# depth.
_WIDE_KERNEL_VARIANT = "scan"


def set_wide_kernel_variant(variant: str) -> None:
    if variant not in ("scan", "monolith"):
        raise ValueError(variant)
    global _WIDE_KERNEL_VARIANT
    _WIDE_KERNEL_VARIANT = variant


def wide_kernel_variant() -> str:
    return _WIDE_KERNEL_VARIANT


# Routes no kernel of the port takes (qiddm_tpu/config.py:240-292): the
# calls at a batch below 2**wires that fall outside every kernel's widths or
# dtype (an RY encode above 10 wires, a block above 20, a CNOT ring or
# complex128 above 8, the SEL chains above 12 or in complex128). Where a
# kernel takes a call, the kernel runs whatever these modes say: they choose
# among the plain-PyTorch routes the JAX package runs in XLA, and none of
# them switches a kernel off (as set_wide_kernel_mode is not ported above).
#
# adjoint_mode picks how those routes differentiate:
# * "auto": the adjoint chains of sim/wide.py (a backward that rebuilds the
#   states through the inverse gates, O(1) residuals) where autograd's
#   L*k*w stored states are the memory ceiling, by the JAX package's TPU
#   rule (qiddm_tpu/sim/engine.py::_use_adjoint, _use_wide): the grouped
#   chain from 9 wires, the per-gate chain (under wide_mode "off") past 10;
#   elsewhere, under autograd, the per-layer unitaries (re-upload blocks,
#   up to 8 wires) or the gate-by-gate sel_apply_gates;
# * "on": the adjoint chains at every width;
# * "off": autograd everywhere: sel_apply_gates, or the per-layer
#   unitaries up to 8 wires (the A/B and debugging route).
_ADJOINT_MODE = "auto"


def set_adjoint_mode(mode: str) -> None:
    if mode not in ("auto", "on", "off"):
        raise ValueError(mode)
    global _ADJOINT_MODE
    _ADJOINT_MODE = mode


def adjoint_mode() -> str:
    return _ADJOINT_MODE


# wide_mode picks the grouped-Kronecker chain (sim/wide.py: a sublayer's w
# rotations composed into ceil(w / 7) group matrices, one product each)
# over the per-gate adjoint chain (the same chain with one-wire groups: w
# passes a sublayer):
# * "auto": the grouped chain from 9 wires, the JAX package's TPU rule
#   (qiddm_tpu/sim/engine.py::_use_wide with wide_min_wires 9);
# * "on": the grouped chain at every width;
# * "off": the per-gate adjoint chain.
# adjoint_mode "off" turns the grouped chain off too: both are adjoint
# backwards.
_WIDE_MODE = "auto"


def set_wide_mode(mode: str) -> None:
    if mode not in ("auto", "on", "off"):
        raise ValueError(mode)
    global _WIDE_MODE
    _WIDE_MODE = mode


def wide_mode() -> str:
    return _WIDE_MODE


# Density-matrix backend (qiddm_tpu/config.py:370-414). Channel
# application for amplitude damping and depolarizing: "perwire" closed forms
# (a masked block pass per wire) or "grouped" superoperator contractions over
# groups of up to 4 wires. Both are exact.
_DM_CHANNEL_MODE = "perwire"
# SEL application on rho: "gates" runs the block through the density-matrix
# kernel (sim/dm_kernel.py) where it is eligible, else the SEL chain on both
# sides of rho (density.apply_chain_two_sided); "matmul" sandwiches rho
# between composed per-layer unitaries.
_DM_UNITARY_MODE = "gates"


def set_dm_channel_mode(mode: str) -> None:
    if mode not in ("perwire", "grouped"):
        raise ValueError(mode)
    global _DM_CHANNEL_MODE
    _DM_CHANNEL_MODE = mode


def dm_channel_mode() -> str:
    return _DM_CHANNEL_MODE


def set_dm_unitary_mode(mode: str) -> None:
    if mode not in ("gates", "matmul"):
        raise ValueError(mode)
    global _DM_UNITARY_MODE
    _DM_UNITARY_MODE = mode


def dm_unitary_mode() -> str:
    return _DM_UNITARY_MODE


def resolve_device(name) -> torch.device:
    """The ``torch.device`` for ``name``; raises when CUDA is asked for and
    this process has none. Nothing in the package falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False (torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}); pass a CPU device explicitly to run the "
            f"plain PyTorch path")
    return device
