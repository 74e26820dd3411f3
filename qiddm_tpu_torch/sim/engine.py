"""Circuit engine (counterpart of ``qiddm_tpu/sim/engine.py``:
``reupload_block``, ``qdense_circuit``, ``qnn_circuit`` and the noise
models).

* ``reupload_block`` (QIDDM family): L x [RZ or RY encode -> SEL(k, CZ
  ring)] followed by a readout.
* ``qdense_circuit`` (Qdense family): amplitude embedding -> SEL(depth),
  CNOT ring by default -> probabilities.
* ``qnn_circuit`` (QNN family): one RZ encode of |0...0>, or the RY product
  state (QNN_A) -> SEL(depth), CZ ring by default -> PauliZ expectations or
  probabilities.

Clean circuits take one of two statevector routes, chosen from the batch
size:

* batch < 2**wires: a gate chain. Where a kernel takes the call, on
  (d, B) float32 planes (complex64 only): ``gate_kernel.gate_chain_planes``
  (RZ) and ``ry_kernel.ry_chain_planes`` (RY) for the re-uploading blocks
  with a CZ ring up to 10 wires, ``wide_kernel.wide_chain_planes`` (RZ, CZ)
  for 11-20 wires, whose kernels ``config.wide_kernel_variant()`` picks
  (#11/#12 a wire group at a time, or #9/#10 a whole chain in one launch),
  ``unitary_kernel.unitary_chain_planes`` (#13/#14) for an RZ block with a
  CNOT ring up to 8 wires, and ``sel_kernel.sel_chain_planes`` for the SEL
  chains up to 12 wires (both rings); the CUDA kernels on the card
  (forward, and the adjoint backward under autograd), their plain versions
  on the CPU. Every other call (an RY encode above 10 wires, a block above
  20, a CNOT ring or complex128, the SEL chains above 12 wires or in
  complex128) takes the routes the JAX package runs in XLA, in plain
  PyTorch, as its TPU predicates pick them (:func:`_use_wide`,
  :func:`_use_adjoint`; ``config.wide_mode()``, ``config.adjoint_mode()``):
  the grouped chain from 9 wires (``wide.reupload_chain_wide``,
  ``wide.sel_chain_wide``), past 10 wires the per-gate adjoint chain where
  the grouped one is off (``wide.*_adjoint``), and where neither takes a
  call, the per-layer unitaries (re-uploading blocks up to 8 wires) or
  ``sel.sel_apply_gates`` under autograd. ``ROUTE_CALLS`` counts their
  calls;
* batch >= 2**wires: the layers composed into one unitary per block and
  applied with complex matmuls, which pays once the batch exceeds the
  state dimension; autograd differentiates it, as XLA does in JAX.

A :class:`NoiseModel` with a non-unitary channel (amplitude damping,
depolarizing, phase damping) switches the circuit to the density-matrix
backend (``sim/density.py``): in ``config.dm_unitary_mode()`` "gates" the
re-uploading block runs whole in the density-matrix kernel
(``dm_kernel.dm_chain``, complex64 up to 10 wires) where it is eligible,
else every SEL block goes through the SEL chain on both sides of rho (the
SEL-chain kernel in complex64 up to the dm cap of 12 wires,
``sel_apply_gates`` in complex128); "matmul" sandwiches rho between
composed unitaries. The unitary kinds stay on the statevector routes: the
rotation-angle error shifts the encoding angles, and a trailing phase shift
leaves the probabilities as they are.

With ``n_traj`` and a random source ``traj_rng`` (a ``torch.Generator`` on
the circuit's device), a non-unitary channel takes the Monte-Carlo
trajectory backend instead (``sim/trajectories.py``): ``n_traj`` statevector
trajectories per sample, the amplitude-damping pass in its kernel (complex64
up to 12 wires; past that its PyTorch counterpart), the SEL layers through
the SEL-chain kernel, composed or per-layer unitaries or
``sel_apply_gates``; without a
non-unitary channel ``n_traj`` changes nothing, as in the JAX package.

The mesh-sharded statevector raises ``NotImplementedError`` naming the
ROADMAP item that ports it; density matrices above
``density.MAX_DM_WIRES`` = 12 wires raise ``ValueError``, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import config as _config
from . import channels as ch
from . import density as dm
from .dm_kernel import KIND_IDS, dm_chain
from .gate_kernel import gate_chain_planes
from .gates import WEIGHT_MAPS, rot_matrix, ry_matrix
from .ry_kernel import ry_chain_planes
from .sel import (  # noqa: F401  (ROUTE_CALLS: the routes' counters)
    ROUTE_CALLS,
    reset_route_calls,
    sel_apply_gates,
    sel_layer_unitaries,
    sel_unitaries,
    sel_unitary,
)
from .sel_kernel import sel_chain_planes
from .statevector import (
    amplitude_embed,
    apply_ry_all,
    apply_unitary,
    expval_z,
    expval_z_from_planes,
    probs,
    probs_from_planes,
    ry_product_state,
    rz_phase_planes,
    rz_phases,
    zero_state,
)
from .trajectories import (
    qdense_circuit_trajectories,
    qnn_circuit_trajectories,
    reupload_block_trajectories,
)
from .unitary_kernel import MAX_WIRES as UNITARY_MAX_WIRES
from .unitary_kernel import unitary_chain_planes
from .wide import (
    reupload_chain_adjoint,
    reupload_chain_wide,
    sel_chain_adjoint,
    sel_chain_wide,
)
from .wide_kernel import wide_chain_planes

_ENCODES = ("rz", "rz_halfpi", "ry")
_IMPRIMITIVES = ("cz", "cnot")
# Where wide_mode and adjoint_mode "auto" take the grouped and the per-gate
# adjoint chains on the TPU: from the JAX package's wide_min_wires, and
# past its pallas_max_wires (qiddm_tpu/config.py)
_WIDE_MIN_WIRES = 9
_PALLAS_MAX_WIRES = 10


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """A hardware-noise channel injected on every wire.

    placement:
      * ``"encode"`` — after each data-encoding rotation, inside every
        spectrum layer (QIDDM family, reference nn/qdense.py:1406-1416);
      * ``"end"`` — once at the end of the circuit (Qdense/QNN_A family,
        reference nn/qdense.py:98-104, :174-180).

    ``strength`` is a Python float or a 0-d float32 tensor on the circuit's
    device; every consumer (Kraus builders, closed forms, the dm kernel,
    the encode over-rotation) takes either, so a sweep sets one tensor per
    intensity and nothing reads it back to the host.
    """

    kind: str
    strength: object   # float | 0-d tensor
    placement: str = "end"

    @property
    def is_unitary(self) -> bool:
        return self.kind in ("phase_shift", "rot_angle")


# (channel kind, strength) per reference family for add_noise codes 1..3
_FAMILY_NOISE = {
    # reference nn/qdense.py:98-104 (QDenseUndirected_old_noise) and
    # :431-439 (differN_noise): noise once at circuit end
    "qdense": {1: ("phase_shift", 0.05), 2: ("amplitude_damping", 0.1),
               3: ("depolarizing", 0.02), "placement": "end"},
    # reference nn/qdense.py:174-180 (QNN_A): end placement
    "qnn_a": {1: ("phase_damping", 0.05), 2: ("amplitude_damping", 0.05),
              3: ("depolarizing", 0.02), "placement": "end"},
    # reference nn/qdense.py:255-261 (QNN_noise): after each encode gate
    "qnn": {1: ("phase_damping", 0.03), 2: ("amplitude_damping", 0.05),
            3: ("depolarizing", 0.02), "placement": "encode"},
    # reference nn/qdense.py:520-526 (differN_noise_befor): encode placement
    "differn_befor": {1: ("phase_damping", 0.03),
                      2: ("amplitude_damping", 0.05),
                      3: ("depolarizing", 0.02), "placement": "encode"},
    # reference nn/qdense.py:1410-1416 (QIDDM family; the 0.9 depolarizing
    # strength is the reference's)
    "qiddm": {1: ("phase_damping", 0.03), 2: ("amplitude_damping", 0.05),
              3: ("depolarizing", 0.9), "placement": "encode"},
}


def noise_from_code(code: int, family: str,
                    intensity=None) -> Optional[NoiseModel]:
    """Map the reference's ``add_noise`` integer to a NoiseModel.

    ``code == 4`` is the rotation-angle error swept by reference
    src/mnist_noise.py:432, whose circuit branch is missing from the
    release: a deterministic encoding over-rotation of ``intensity``
    radians, which must be given. ``intensity`` (a float or a 0-d tensor)
    also overrides the family's strength for codes 1-3.
    """
    if code == 0:
        return None
    table = _FAMILY_NOISE[family]
    placement = table["placement"]
    if code == 4:
        if intensity is None:
            raise ValueError(
                "add_noise=4 (Rotation Angle error) requires an explicit "
                "noise intensity — a silent 0.0 would be a no-op labeled "
                "as a noise run")
        if isinstance(intensity, (int, float)):
            intensity = float(intensity)
        return NoiseModel("rot_angle", intensity, "encode")
    kind, strength = table[code]
    if intensity is not None:
        strength = (float(intensity)
                    if isinstance(intensity, (int, float)) else intensity)
    return NoiseModel(kind, strength, placement)


def _kraus_array(noise: NoiseModel, dtype, device) -> torch.Tensor:
    return torch.stack(ch.kraus_for(noise.kind, noise.strength)).to(
        dtype=dtype, device=device)


def _apply_noise_all_wires(rho, noise: NoiseModel, cdtype):
    """The channel on every wire: the closed forms
    (``density.apply_channel_all_wires``) for the three reference channel
    kinds, the generic Kraus sum otherwise."""
    try:
        return dm.apply_channel_all_wires(rho, noise.kind, noise.strength)
    except KeyError:
        return dm.apply_kraus_all_wires(
            rho, _kraus_array(noise, cdtype, rho.device))


def _needs_dm(noise: Optional[NoiseModel]) -> bool:
    return noise is not None and not noise.is_unitary


def _encode_angles(x, encode: str, noise: Optional[NoiseModel]):
    """The encoding angles: the halfpi scaling, then the rotation-angle
    error's over-rotation, in the JAX package's order."""
    if encode == "rz_halfpi":
        x = (math.pi * 0.5) * x
    if (noise is not None and noise.kind == "rot_angle"
            and noise.placement == "encode"):
        x = x + noise.strength
    return x


def _records_grad(*xs) -> bool:
    """Whether autograd records through any of ``xs`` (the JAX package
    asks whether an AD tracer is present, ``engine._ad_traced``)."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(x) and x.requires_grad for x in xs)


def _check_encode(encode: str) -> None:
    if encode not in _ENCODES:
        raise ValueError(f"unknown encode {encode!r} (known: {_ENCODES})")


def _use_wide(wires: int) -> bool:
    """The grouped chain for a call no kernel takes (the JAX package's
    ``_use_wide(wires, True)``): ``config.wide_mode()`` "on" always, "auto"
    from 9 wires, "off" never; never under ``adjoint_mode()`` "off"."""
    if _config.adjoint_mode() == "off":
        return False
    mode = _config.wide_mode()
    return mode == "on" or (mode == "auto" and wires >= _WIDE_MIN_WIRES)


def _use_adjoint(wires: int) -> bool:
    """The per-gate adjoint chain for a call no kernel takes and the
    grouped chain does not (the JAX package's ``_use_adjoint(wires,
    True)``): ``config.adjoint_mode()`` "on" always, "auto" past 10 wires,
    "off" never."""
    mode = _config.adjoint_mode()
    return mode == "on" or (mode == "auto" and wires > _PALLAS_MAX_WIRES)


def _sel_xla(states, w, imprimitive: str):
    """The SEL chain (full-depth range cycle) on (B, 2**w) complex states
    where no kernel takes it: the grouped chain, the per-gate adjoint chain
    or ``sel_apply_gates`` under autograd, by :func:`_use_wide` and
    :func:`_use_adjoint` (``qiddm_tpu/sim/engine.py:256-267``). ``w`` is in
    the states' real dtype."""
    wires = w.shape[1]
    if _use_wide(wires):
        return sel_chain_wide(states, w, imprimitive)
    if _use_adjoint(wires):
        return sel_chain_adjoint(states, w, imprimitive)
    return sel_apply_gates(states, w, imprimitive)


def _reupload_xla(x_enc, block_weights, *, encode: str, imprimitive: str,
                  cdtype):
    """The re-uploading block at a batch below ``2**wires`` where no kernel
    takes it, as the JAX package's ladder runs it in XLA
    (``engine.py:478-551``): the grouped chain, the per-gate adjoint chain,
    then, where neither takes the call, the per-layer unitaries up to 8
    wires and ``sel_apply_gates`` a spectrum layer (the ranges restart each
    layer) above. Returns the final states."""
    L, k, wires, _ = block_weights.shape
    kw = {"encode": encode, "imprimitive": imprimitive, "cdtype": cdtype}
    if _use_wide(wires):
        return reupload_chain_wide(x_enc, block_weights, **kw)
    if _use_adjoint(wires):
        return reupload_chain_adjoint(x_enc, block_weights, **kw)
    rdtype = cdtype.to_real()
    x_enc = x_enc.to(rdtype)
    block_weights = block_weights.to(rdtype)
    phases = None if encode == "ry" else rz_phases(x_enc, wires)
    lus = (sel_layer_unitaries(block_weights, imprimitive)
           if wires <= UNITARY_MAX_WIRES else None)
    states = zero_state(x_enc.shape[0], wires, dtype=cdtype,
                        device=x_enc.device)
    for l in range(L):
        states = (apply_ry_all(states, x_enc) if phases is None
                  else states * phases)
        if lus is None:
            states = sel_apply_gates(states, block_weights[l], imprimitive)
        else:
            for li in range(k):
                states = apply_unitary(states, lus[l, li])
    return states


def _readout(states, readout: str):
    return probs(states) if readout == "probs" else expval_z(states)


def _reupload_kernel(x_enc, block_weights, *, encode: str, readout: str):
    """The plane-kernel routes of a complex64 CZ block below ``2**wires``:
    the RY chain (#3/#4) up to 10 wires, the RZ gate chain (#1/#2) up to
    10 and the wide chain (#11/#12 or #9/#10) at 11-20."""
    L, k, wires, _ = block_weights.shape
    flat = block_weights.reshape(L * k, wires, 3)
    mats = rot_matrix(flat[..., 0], flat[..., 1], flat[..., 2])
    if encode == "ry":
        sr, si = ry_chain_planes(x_enc, mats, k, wires)
    else:
        pr, pi = rz_phase_planes(x_enc, wires)
        chain = (wide_chain_planes if wires > _config.KERNEL_MAX_WIRES
                 else gate_chain_planes)
        sr, si = chain(pr, pi, mats, k, wires)
    if readout == "probs":
        return probs_from_planes(sr, si)
    return expval_z_from_planes(sr, si)


def _kernel_takes_block(wires: int, encode: str, imprimitive: str,
                        cdtype) -> str:
    """Which kernel route takes a block below ``2**wires``: "planes" (the
    gate, RY or wide chain), "unitary" (#13/#14, a complex64 RZ block with
    a CNOT ring up to 8 wires) or "" (none: the XLA routes)."""
    if cdtype != torch.complex64:
        return ""
    if imprimitive == "cz":
        widest = (_config.KERNEL_MAX_WIRES if encode == "ry"
                  else _config.WIDE_KERNEL_MAX_WIRES)
        return "planes" if wires <= widest else ""
    if encode != "ry" and wires <= UNITARY_MAX_WIRES:
        return "unitary"
    return ""


def _reupload_per_layer(x_enc, block_weights, *, readout: str):
    """The unitary-streaming route of :func:`reupload_block` (a complex64 RZ
    block with a CNOT ring, below ``2**wires``, up to 8 wires): the layers'
    dense unitaries (``sel_layer_unitaries``, (L, k, d, d)) through
    ``unitary_chain_planes`` (#13/#14 on the card, its plain version on the
    CPU), the JAX package's per-layer branch (``engine.py:519-551``)."""
    L, k, wires, _ = block_weights.shape
    lus = sel_layer_unitaries(block_weights, "cnot")
    pr, pi = rz_phase_planes(x_enc, wires)
    flat = lus.reshape(L * k, 2**wires, 2**wires)
    sr, si = unitary_chain_planes(pr, pi, flat.real.contiguous(),
                                  flat.imag.contiguous(), k)
    if readout == "probs":
        return probs_from_planes(sr, si)
    return expval_z_from_planes(sr, si)


def _reupload_mesh(x_enc, block_weights, mesh, axis: str, *, encode: str,
                   imprimitive: str, noise: Optional[NoiseModel],
                   readout: str, cdtype, n_traj: int, traj_rng):
    """The mesh route of :func:`reupload_block` (``engine.py:366-392`` of
    the JAX package): the sharded program applies the halfpi scaling
    itself, so the encode-placement over-rotation is divided by that scale
    first, to land after it as on the dense route."""
    from .sharded import reupload_block_sharded

    if _needs_dm(noise) and not n_traj:
        raise NotImplementedError(
            "noise channels on the mesh-sharded statevector path need the "
            "trajectory backend: pass n_traj=.../traj_rng=... "
            "(sim/trajectories.py)")
    if (noise is not None and noise.kind == "rot_angle"
            and noise.placement == "encode"):
        scale = math.pi * 0.5 if encode == "rz_halfpi" else 1.0
        x_enc = x_enc + noise.strength / scale
    traj = {}
    if _needs_dm(noise):
        traj = {"noise_kind": noise.kind, "noise_strength": noise.strength,
                "traj_rng": traj_rng, "n_traj": n_traj,
                "noise_placement": noise.placement}
    return reupload_block_sharded(x_enc, block_weights, mesh, axis=axis,
                                  imprimitive=imprimitive, encode=encode,
                                  readout=readout, dtype=cdtype, **traj)


def reupload_block(x_enc: torch.Tensor, block_weights: torch.Tensor, *,
                   encode: str = "rz", imprimitive: str = "cz",
                   noise: Optional[NoiseModel] = None,
                   readout: str = "probs", cdtype=None, mesh=None,
                   mesh_axis: str = "data", n_traj: int = 0,
                   traj_rng=None) -> torch.Tensor:
    """One N-block: L x (encode -> SEL(k)) -> readout.

    x_enc: (batch, wires) encoding angles, re-uploaded in every spectrum
    layer; block_weights: (L, k, wires, 3); ``imprimitive`` the SEL ring,
    "cz" or "cnot". readout "probs" gives (batch, 2**w), "expvalz" gives
    (batch, wires). A non-unitary ``noise`` takes the density-matrix route
    (:func:`_reupload_dm`), or with ``n_traj`` the trajectory backend,
    drawing from ``traj_rng``.

    With ``mesh`` (a ``DeviceMesh``, ``parallel.make_mesh``), the
    statevector is split over ``mesh[mesh_axis]`` (``sim/sharded.py``),
    every rank calling with the same arguments; the result is on every
    rank. A non-unitary channel there needs the trajectory backend.
    """
    _check_encode(encode)
    if imprimitive not in _IMPRIMITIVES:
        raise ValueError(f"unknown imprimitive {imprimitive!r}")
    if readout not in ("probs", "expvalz"):
        raise ValueError(f"unknown readout {readout!r}")
    if cdtype is None:
        cdtype = _config.complex_dtype()
    if mesh is not None:
        return _reupload_mesh(x_enc, block_weights, mesh, mesh_axis,
                              encode=encode, imprimitive=imprimitive,
                              noise=noise, readout=readout, cdtype=cdtype,
                              n_traj=n_traj, traj_rng=traj_rng)
    L, k, wires, _ = block_weights.shape
    batch = x_enc.shape[0]
    x_enc = _encode_angles(x_enc, encode, noise)
    if n_traj and _needs_dm(noise):
        # x_enc carries the halfpi and rotation-angle transforms already
        return reupload_block_trajectories(
            x_enc, block_weights, rng=traj_rng, n_traj=n_traj, noise=noise,
            encode=encode, imprimitive=imprimitive, readout=readout,
            cdtype=cdtype)
    if _needs_dm(noise):
        return _reupload_dm(x_enc, block_weights, encode=encode,
                            imprimitive=imprimitive, noise=noise,
                            readout=readout, cdtype=cdtype)

    if batch < 2**wires:
        route = _kernel_takes_block(wires, encode, imprimitive, cdtype)
        if route == "planes":
            return _reupload_kernel(x_enc, block_weights, encode=encode,
                                    readout=readout)
        if route == "unitary":
            return _reupload_per_layer(x_enc, block_weights, readout=readout)
        return _readout(_reupload_xla(x_enc, block_weights, encode=encode,
                                      imprimitive=imprimitive,
                                      cdtype=cdtype), readout)

    rdtype = cdtype.to_real()
    us = sel_unitaries(block_weights.to(rdtype), imprimitive)
    x_enc = x_enc.to(rdtype)
    phases = None if encode == "ry" else rz_phases(x_enc, wires)
    states = zero_state(batch, wires, dtype=cdtype, device=x_enc.device)
    for u in us:
        states = (apply_ry_all(states, x_enc) if phases is None
                  else states * phases)
        states = apply_unitary(states, u)
    if readout == "probs":
        return probs(states)
    return expval_z(states)


def _dm_readout(rho, readout: str):
    return dm.probs(rho) if readout == "probs" else dm.expval_z(rho)


def _two_sided_sel(rho, w, wires: int, imprimitive: str):
    """U rho U^dagger for the SEL chain of ``w`` (depth, wires, 3) on the
    b*d column states, twice: in complex64 the SEL-chain kernel (#5/#6 on
    the card, up to its 12 wires; its plain version on the CPU), in
    complex128 ``sel_apply_gates``, as the JAX package's XLA route
    (``engine.py:627-632``). Differentiable either way."""
    if rho.dtype == torch.complex64:
        mats = rot_matrix(w[..., 0], w[..., 1], w[..., 2])
        return dm.apply_chain_two_sided(
            rho, lambda sr, si: sel_chain_planes(sr, si, mats, wires,
                                                 imprimitive))
    w = w.to(rho.real.dtype)

    def gates(sr, si):
        out = sel_apply_gates(torch.complex(sr, si).T, w, imprimitive)
        return out.real.T, out.imag.T

    return dm.apply_chain_two_sided(rho, gates)


def _apply_1q_batched_unitary(rho, gate, wire: int, wires: int):
    """rho -> G rho G^dagger with a per-sample (b, 2, 2) single-qubit gate."""
    r = dm._split(rho, wire)
    out = torch.einsum("bxy,blyrmzs,bwz->blxrmws", gate, r, gate.conj())
    return out.reshape(rho.shape)


def _reupload_dm(x_enc, block_weights, *, encode: str, imprimitive: str,
                 noise: NoiseModel, readout: str, cdtype):
    """The density-matrix route of :func:`reupload_block` (damping and
    depolarizing channels inside the loop or at its end).

    In ``dm_unitary_mode`` "gates", the whole block runs in the
    density-matrix kernel when the ring is CZ, the noise sits after each
    encode, its kind has a closed form, the dtype is complex64 and autograd
    does not record (the kernel has no backward; the JAX package routes by
    the same condition, ``engine.py:593-599``); otherwise every spectrum
    layer encodes, applies the channel and runs its SEL chain (either ring)
    on both sides of rho (:func:`_two_sided_sel`: the SEL-chain kernel in
    complex64, which differentiates, ``sel_apply_gates`` in complex128).
    The dm kernel takes up to 10 wires, the SEL chain up to
    ``density.MAX_DM_WIRES`` = 12, past which rho raises ``ValueError``, as
    in the JAX package. "matmul" sandwiches rho between the composed
    per-layer unitaries.

    Memory: rho is (batch, 4**wires) complex, ``batch * 4**w * 8`` bytes in
    complex64 on the input's device (0.5 MB a sample at w=8, 8 MB at w=10,
    128 MB at w=12); the two-sided route holds a few such tensors per
    layer, and autograd keeps each layer's.
    """
    L, k, wires, _ = block_weights.shape
    batch = x_enc.shape[0]
    dim = 2**wires
    rdtype = cdtype.to_real()
    dm_gates = _config.dm_unitary_mode() == "gates"
    dm._guard(wires)
    x_enc = x_enc.to(rdtype)
    phases = rz_phases(x_enc, wires) if encode != "ry" else None
    if (dm_gates and imprimitive == "cz" and noise.placement == "encode"
            and noise.kind in KIND_IDS and cdtype == torch.complex64
            and wires <= _config.KERNEL_MAX_WIRES
            and not _records_grad(x_enc, block_weights, noise.strength)):
        flat = block_weights.reshape(L * k, wires, 3)
        mats = rot_matrix(flat[..., 0], flat[..., 1], flat[..., 2])
        rho = dm_chain(x_enc if phases is None else phases, mats, k, wires,
                       noise.kind, noise.strength, ry=phases is None)
        return _dm_readout(rho, readout)

    def encode_rho(rho):
        if phases is not None:
            return dm.apply_diag(rho, phases)
        if dm_gates:
            x_cols = x_enc.repeat_interleave(dim, dim=0)  # column batch

            def ry_all(sr, si):
                out = apply_ry_all(torch.complex(sr, si).T, x_cols)
                return out.real.T, out.imag.T

            return dm.apply_chain_two_sided(rho, ry_all)
        gates = ry_matrix(x_enc).to(cdtype)  # (b, wires, 2, 2)
        for j in range(wires):
            rho = _apply_1q_batched_unitary(rho, gates[:, j], j, wires)
        return rho

    rho = dm.zero_density(batch, wires, dtype=cdtype, device=x_enc.device)
    us = (None if dm_gates
          else sel_unitaries(block_weights.to(rdtype), imprimitive))
    for l in range(L):
        rho = encode_rho(rho)
        if noise.placement == "encode":
            rho = _apply_noise_all_wires(rho, noise, cdtype)
        if dm_gates:
            rho = _two_sided_sel(rho, block_weights[l], wires, imprimitive)
        else:
            rho = dm.apply_unitary(rho, us[l])
    if noise.placement == "end":
        rho = _apply_noise_all_wires(rho, noise, cdtype)
    return _dm_readout(rho, readout)


def _sel_small_batch(states, w, imprimitive: str, cdtype):
    """Small-batch SEL application (batch < 2**wires) on (B, d) ``cdtype``
    start states; returns the (B, d) output states.

    Complex64 up to ``SEL_KERNEL_MAX_WIRES`` wires takes the SEL-chain
    kernel (#5/#6 on the card, its plain version on the CPU) on the states'
    (d, B) planes; everything else, :func:`_sel_xla` (the grouped or
    per-gate adjoint chain, or ``sel_apply_gates``), the routes the JAX
    package runs in XLA."""
    wires = w.shape[1]
    if cdtype == torch.complex64 and wires <= _config.SEL_KERNEL_MAX_WIRES:
        mats = rot_matrix(w[..., 0], w[..., 1], w[..., 2])
        sr, si = sel_chain_planes(states.real.T.contiguous(),
                                  states.imag.T.contiguous(), mats, wires,
                                  imprimitive)
        return torch.complex(sr, si).T
    return _sel_xla(states, w.to(cdtype.to_real()), imprimitive)


# ---------------------------------------------------------------------------
# qdense family
# ---------------------------------------------------------------------------

def qdense_circuit(x: torch.Tensor, weights: torch.Tensor, *, wires: int,
                   pad_with: float = 0.1, weight_map: str = "qw_tanh",
                   imprimitive: str = "cnot",
                   noise: Optional[NoiseModel] = None, cdtype=None,
                   n_traj: int = 0, traj_rng=None) -> torch.Tensor:
    """AmplitudeEmbedding -> SEL -> (noise) -> probs.

    x: (batch, n_features); weights: (depth, wires, 3). Returns (batch,
    2**w) probabilities. Reference: nn/qdense.py:40-47 / :95-105. A
    non-unitary ``noise`` acts once on |psi><psi| at the end (with
    ``n_traj``, on ``n_traj`` trajectories drawn from ``traj_rng``); a phase
    shift or the rotation-angle error leaves the probabilities as they are.
    """
    if cdtype is None:
        cdtype = _config.complex_dtype()
    if n_traj and _needs_dm(noise):
        return qdense_circuit_trajectories(
            x, weights, rng=traj_rng, n_traj=n_traj, noise=noise,
            wires=wires, pad_with=pad_with, weight_map=weight_map,
            imprimitive=imprimitive, cdtype=cdtype)
    w = WEIGHT_MAPS[weight_map](weights)
    if x.shape[0] >= 2**wires:
        states = amplitude_embed(x, wires, pad_with, dtype=cdtype)
        u = sel_unitary(w.to(cdtype.to_real()), imprimitive)
        states = apply_unitary(states, u)
        if not _needs_dm(noise):
            return probs(states)
    else:
        # batch < state dim: the gate-level chain, O(depth w B d) against
        # the composed route's O(depth d^3); the ranges cycle over the
        # full depth
        states = amplitude_embed(x.to(cdtype.to_real()), wires, pad_with,
                                 dtype=cdtype)
        states = _sel_small_batch(states, w, imprimitive, cdtype)
        if not _needs_dm(noise):
            return probs(states)
    rho = _apply_noise_all_wires(dm.from_statevector(states), noise, cdtype)
    return dm.probs(rho)


# ---------------------------------------------------------------------------
# qnn family
# ---------------------------------------------------------------------------

def qnn_circuit(x: torch.Tensor, weights: torch.Tensor, *,
                encode: str = "rz", imprimitive: str = "cz",
                weight_map: str = "none", noise: Optional[NoiseModel] = None,
                readout: str = "expvalz", cdtype=None,
                n_traj: int = 0, traj_rng=None) -> torch.Tensor:
    """Single encode -> SEL(depth) -> readout.

    x: (batch, wires); weights: (depth, wires, 3). readout "expvalz" gives
    (batch, wires), "probs" (batch, 2**wires).

    Faithfulness note: with RZ encoding on the fresh |0..0> state the input
    contributes only a global phase (reference nn/qdense.py:338-344 — the
    QNN circuit output is therefore input-independent; the surrounding
    linear layers do the learning). This reproduces that, so the gradient
    reaching ``x`` is zero up to float rounding.

    A non-unitary ``noise`` takes the density-matrix route: rho from the
    encoded state, the channel after the encode or at the end, and the SEL
    chain on both sides of rho ("gates") or the composed unitary
    ("matmul"); with ``n_traj``, the trajectory backend, drawing from
    ``traj_rng``.
    """
    _check_encode(encode)
    if readout not in ("probs", "expvalz"):
        raise ValueError(f"unknown readout {readout!r}")
    if cdtype is None:
        cdtype = _config.complex_dtype()
    batch, wires = x.shape
    w = WEIGHT_MAPS[weight_map](weights)
    x = _encode_angles(x, encode, noise)
    rdtype = cdtype.to_real()
    if n_traj and _needs_dm(noise):
        return qnn_circuit_trajectories(
            x, weights, rng=traj_rng, n_traj=n_traj, noise=noise,
            encode=encode, imprimitive=imprimitive, weight_map=weight_map,
            readout=readout, cdtype=cdtype)
    if _needs_dm(noise):
        if encode == "ry":
            rho = dm.from_statevector(
                ry_product_state(x.to(rdtype), wires, dtype=cdtype))
        else:
            rho = dm.apply_diag(
                dm.zero_density(batch, wires, dtype=cdtype, device=x.device),
                rz_phases(x.to(rdtype), wires))
        if noise.placement == "encode":
            rho = _apply_noise_all_wires(rho, noise, cdtype)
        if _config.dm_unitary_mode() == "gates":
            rho = _two_sided_sel(rho, w, wires, imprimitive)
        else:
            rho = dm.apply_unitary(rho, sel_unitary(w.to(rdtype),
                                                    imprimitive))
        if noise.placement == "end":
            rho = _apply_noise_all_wires(rho, noise, cdtype)
        return _dm_readout(rho, readout)
    if encode == "ry":
        states = ry_product_state(x.to(rdtype), wires, dtype=cdtype)
    else:
        states = zero_state(batch, wires, dtype=cdtype, device=x.device)
        states = states * rz_phases(x.to(rdtype), wires)
    if batch >= 2**wires:
        states = apply_unitary(states, sel_unitary(w.to(rdtype), imprimitive))
    else:
        states = _sel_small_batch(states, w, imprimitive, cdtype)
    return _readout(states, readout)
