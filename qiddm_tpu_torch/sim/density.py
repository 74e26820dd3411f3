"""Batched density-matrix simulation (counterpart of
``qiddm_tpu/sim/density.py``), in plain PyTorch.

Used when a circuit contains a non-unitary channel (amplitude damping,
depolarizing, phase damping). States are ``(batch, 2**w, 2**w)`` complex
density matrices; wire 0 is the most significant bit of both indices.

Memory: rho squares the qubit cost, ``batch * 4**w`` complex amplitudes
(8 bytes each in complex64: 0.5 MB per sample at 8 wires, 8 MB at 10, 128 MB
at 12). The noise sweeps run a few test images at w <= 10; the engine runs
up to ``MAX_DM_WIRES`` = 12 (qiddm_tpu/sim/density.py:23), past which
``from_statevector`` and ``zero_density`` raise ``ValueError``, as the JAX
package's do.
"""

from __future__ import annotations

import math

import torch

from .. import config as _config
from .statevector import _z_signs_on, rz_phases

MAX_DM_WIRES = 12


def _nwires(rho) -> int:
    return int(math.log2(rho.shape[-1]))


def _guard(wires: int, extra: str = "") -> None:
    if wires > MAX_DM_WIRES:
        raise ValueError(
            f"density-matrix mode capped at {MAX_DM_WIRES} wires{extra}; "
            f"got {wires} — the Monte-Carlo trajectory backend is the route "
            f"for wide noisy circuits")


def from_statevector(states: torch.Tensor) -> torch.Tensor:
    """|psi><psi| for a batch of pure states: (b, d) -> (b, d, d)."""
    wires = int(math.log2(states.shape[-1]))
    _guard(wires, f" (rho would be {4**wires} complex amplitudes per "
                  f"sample)")
    return states[:, :, None] * states.conj()[:, None, :]


def zero_density(batch: int, wires: int, dtype=torch.complex64,
                 device=None) -> torch.Tensor:
    """|0...0><0...0|: (batch, 2**w, 2**w)."""
    _guard(wires)
    dim = 2**wires
    rho = torch.zeros((batch, dim, dim), dtype=dtype, device=device)
    rho[:, 0, 0] = 1.0
    return rho


def apply_unitary(rho: torch.Tensor, unitary: torch.Tensor) -> torch.Tensor:
    """rho -> U rho U^dagger (two batched matmuls)."""
    return torch.einsum("ij,bjk,lk->bil", unitary, rho, unitary.conj())


def apply_chain_two_sided(rho: torch.Tensor, chain_fn) -> torch.Tensor:
    """rho -> U rho U^dagger with U given as a statevector gate chain.

    ``chain_fn(sr, si)`` maps (d, B) float32 state planes (real, imaginary;
    columns are states) to the planes of ``U @ states``, as the SEL-chain
    kernel does (``sel_kernel.sel_chain_planes``). With ``f(M) = U M``,
    columns of M taken as states, and rho Hermitian, ``(U rho)^dagger = rho
    U^dagger``, so ``U rho U^dagger = f((f(rho))^dagger)``: two chain passes
    over ``b*d`` column states instead of two (b*d, d) x (d, d) complex
    matmuls and the composition of U. Exact up to rounding and the
    Hermiticity of rho, which every CPTP step of the dm path keeps.
    Differentiable when ``chain_fn`` is.
    """
    b, d, _ = rho.shape

    def left(m):
        cols = m.permute(1, 0, 2).reshape(d, b * d)  # [row, (sample, col)]
        out_r, out_i = chain_fn(cols.real.contiguous(),
                                cols.imag.contiguous())
        return torch.complex(out_r, out_i).reshape(d, b, d).permute(1, 0, 2)

    return left(left(rho).conj().transpose(1, 2))


def apply_diag(rho: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """A diagonal unitary given as (batch, d) phases: rho_ij *= d_i d_j*."""
    return rho * (diag[:, :, None] * diag.conj()[:, None, :])


def rz_encode(rho: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-wire RZ data encoding on a density matrix (a diagonal unitary)."""
    return apply_diag(rho, rz_phases(x, _nwires(rho)))


def _split(rho: torch.Tensor, wire: int, group: int = 1) -> torch.Tensor:
    """(b, d, d) -> (b, left, 2^group, right, left, 2^group, right) around
    the wires ``wire .. wire+group-1``."""
    w = _nwires(rho)
    left, right = 2**wire, 2 ** (w - wire - group)
    return rho.reshape(rho.shape[0], left, 2**group, right, left, 2**group,
                       right)


def apply_1q_kraus(rho: torch.Tensor, kraus: torch.Tensor,
                   wire: int) -> torch.Tensor:
    """A single-qubit channel ``rho -> sum_k K rho K^dagger`` on one wire.

    kraus: (n_k, 2, 2) complex tensor.
    """
    out = torch.einsum("kxy,blyrmzs,kwz->blxrmws", kraus, _split(rho, wire),
                       kraus.conj())
    return out.reshape(rho.shape)


def apply_kraus_all_wires(rho: torch.Tensor, kraus: torch.Tensor):
    """The same single-qubit channel on every wire in turn (the
    reference's per-wire noise loops, nn/qdense.py:98-104)."""
    for j in range(_nwires(rho)):
        rho = apply_1q_kraus(rho, kraus, j)
    return rho


# --- closed-form channel applications --------------------------------------
# Phase damping is diagonal in the superoperator sense (one mask over rho);
# amplitude damping and depolarizing are elementwise block scalings plus one
# block move or trace per wire.

def _real_strength(strength, like: torch.Tensor) -> torch.Tensor:
    """The strength as a real 0-d tensor of rho's real dtype, on rho's
    device (a tensor strength keeps its autograd graph)."""
    return torch.as_tensor(strength, dtype=like.real.dtype,
                           device=like.device)


def _phase_damp_mask(wires: int, gamma, dtype, device=None) -> torch.Tensor:
    """All-wires phase damping: rho'[i, j] = rho[i, j] * s^hamming(i xor j),
    s = sqrt(1 - gamma): off-diagonal coherence decays per differing bit,
    diagonals untouched."""
    i = torch.arange(2**wires, dtype=torch.int64, device=device)
    x = i[:, None] ^ i[None, :]
    ham = torch.zeros_like(x)
    for _ in range(wires):
        ham = ham + (x & 1)
        x = x >> 1
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    s = torch.sqrt(1.0 - torch.as_tensor(gamma, dtype=rdt, device=device))
    return torch.pow(s, ham.to(rdt)).to(dtype)


def _amp_damp_wire(rho, gamma, wire: int, wires: int):
    """K0 = diag(1, s), K1 = [[0, sqrt(g)], [0, 0]]: the mask (1, s; s,
    1-g) on the wire's 2x2 block grid plus the |1><1| block moving to
    |0><0| with weight g."""
    r = _split(rho, wire)
    gamma = _real_strength(gamma, rho)
    s = torch.sqrt(1.0 - gamma)
    c = torch.stack([torch.ones_like(s), s])
    m = (c[:, None] * c[None, :]).to(rho.dtype)
    out = r * m.reshape(1, 1, 2, 1, 1, 2, 1)
    out[:, :, 0, :, :, 0, :] += gamma * r[:, :, 1, :, :, 1, :]
    return out.reshape(rho.shape)


def _depol_wire(rho, p, wire: int, wires: int):
    """XrX + YrY + ZrZ = 2 tr_w(r) (x) I - r, so the depolarizing channel
    is rho' = (1 - 4p/3) rho + (2p/3) I (x) tr_w(rho)."""
    r = _split(rho, wire)
    t = r[:, :, 0, :, :, 0, :] + r[:, :, 1, :, :, 1, :]
    out = (1.0 - 4.0 * p / 3.0) * r
    out[:, :, 0, :, :, 0, :] += (2.0 * p / 3.0) * t
    out[:, :, 1, :, :, 1, :] += (2.0 * p / 3.0) * t
    return out.reshape(rho.shape)


def apply_channel_all_wires(rho: torch.Tensor, kind: str, strength):
    """Closed-form all-wires application of the reference's channels.

    Equals ``apply_kraus_all_wires(rho, kraus_for(kind, strength))``
    (channels on distinct wires commute). ``strength`` is a float or a 0-d
    tensor. Raises KeyError for kinds without a closed form.

    Phase damping is one mask multiply. Damping and depolarizing follow
    ``config.dm_channel_mode()``: "perwire" closed forms, or "grouped"
    superoperator contractions (:func:`apply_channel_all_wires_grouped`).
    """
    w = _nwires(rho)
    if kind == "phase_damping":
        mask = _phase_damp_mask(w, strength, rho.dtype, rho.device)
        return rho * mask[None]
    if kind in ("amplitude_damping", "depolarizing"):
        if _config.dm_channel_mode() == "grouped":
            from .channels import kraus_for

            return apply_channel_all_wires_grouped(
                rho, torch.stack(kraus_for(kind, strength)))
        if kind == "amplitude_damping":
            for j in range(w):
                rho = _amp_damp_wire(rho, strength, j, w)
            return rho
        p = _real_strength(strength, rho)
        for j in range(w):
            rho = _depol_wire(rho, p, j, w)
        return rho
    raise KeyError(kind)


# --- grouped transfer-matrix channel application ----------------------------
# A single-qubit channel is a superoperator T[(x, y), (a, b)] = sum_K K[x, a]
# conj(K[y, b]) on the wire's (row, col) bit pair. Channels on distinct wires
# commute and tensor, so an all-wires pass groups wires and contracts each
# group's Kronecker power in one einsum.

def transfer_tensor(kraus: torch.Tensor) -> torch.Tensor:
    """(n_k, 2, 2) Kraus stack -> (2, 2, 2, 2) superoperator [x, y, a, b]."""
    return torch.einsum("kxa,kyb->xyab", kraus, kraus.conj())


def _group_transfer(t: torch.Tensor, g: int) -> torch.Tensor:
    """Kronecker power of a per-wire superoperator onto a g-wire group:
    (2, 2, 2, 2) -> (2^g, 2^g, 2^g, 2^g) as [X, Y, A, B] with X/A row bits
    and Y/B column bits in wire order."""
    out = t
    for _ in range(g - 1):
        out = torch.einsum("XYAB,xyab->XxYyAaBb", out, t)
        s = out.shape
        out = out.reshape(s[0] * s[1], s[2] * s[3], s[4] * s[5],
                          s[6] * s[7])
    return out


def apply_channel_all_wires_grouped(rho: torch.Tensor, kraus: torch.Tensor,
                                    group: int = 4) -> torch.Tensor:
    """The same single-qubit channel on every wire through grouped
    superoperator contractions; equals :func:`apply_kraus_all_wires`.
    ``group`` caps the fused group width (T_g holds 16^g entries)."""
    w = _nwires(rho)
    t1 = transfer_tensor(kraus.to(device=rho.device)).to(rho.dtype)
    pos = 0
    while pos < w:
        g = min(group, w - pos)
        tg = _group_transfer(t1, g) if g > 1 else t1
        rho = torch.einsum("XYac,blarmcs->blXrmYs", tg,
                           _split(rho, pos, g)).reshape(rho.shape)
        pos += g
    return rho


def probs(rho: torch.Tensor) -> torch.Tensor:
    """The real part of rho's diagonal: (b, d, d) -> (b, d)."""
    return torch.diagonal(rho, dim1=-2, dim2=-1).real


def expval_z(rho: torch.Tensor) -> torch.Tensor:
    """PauliZ expectation on every wire: (b, d, d) -> (b, wires)."""
    p = probs(rho)
    return p @ _z_signs_on(_nwires(rho), p.dtype, p.device)
