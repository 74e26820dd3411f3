"""Quantum convolution (counterpart of ``qiddm_tpu/nn/qconv.py``):
amplitude-embedded patch circuits as real matmuls.

``QConv2d`` (the reference's ``QConv2d = _QConv2d_FAST``) unfolds
k x k x Cin patches, amplitude-embeds each (pad 0.5, L2-normalize), applies
SEL(qw_tanh(w)) with the CNOT ring and reads probabilities back as output
channels. As in the JAX package, the SEL block is composed into one
unitary every forward, only the even probability rows the post-processing
keeps are computed, and since the embedded state is real those rows are
``(psi Ur^T)^2 + (psi Ui^T)^2``: two real (patches, d) @ (d, rows)
products. ``compat_dead_qnode=True`` reproduces the released (buggy)
forward, which post-processes the raw pixels and never runs its circuit.

``QConv2dMedium`` (``QConv2dSlow`` is an alias) chains a per-in-channel
state preparation (a Householder unitary, ``_prep_unitary``) and that
channel's SEL on the same wires. None of this runs a hand-written kernel:
the JAX package computes it with XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
import warnings
from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import complex_dtype
from ..sim.gates import qw_tanh
from ..sim.sel import sel_unitary
from ..sim.statevector import amplitude_rows, probs, zero_state
from .initializers import qconv_uniform


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _patches(x: torch.Tensor, kernel_size, padding) -> torch.Tensor:
    """(b, c, h, w) -> (b * h_out * w_out, c, kh * kw): every output
    position's patch, features in (c, kh, kw) order as
    ``conv_general_dilated_patches`` and ``torch.nn.Unfold`` give them."""
    b, c = x.shape[:2]
    kh, kw = kernel_size
    cols = F.unfold(x, (kh, kw), padding=padding)  # (b, c*kh*kw, L)
    return cols.reshape(b, c, kh * kw, -1).permute(0, 3, 1, 2).reshape(
        -1, c, kh * kw)


def _to_nchw(q: torch.Tensor, out_channels: int, b: int, h: int,
             w: int) -> torch.Tensor:
    """(b * h * w, n <= out_channels) -> (b, out_channels, h, w), the
    missing channels zero."""
    if q.shape[-1] < out_channels:
        q = F.pad(q, (0, out_channels - q.shape[-1]))
    return q.reshape(b, h, w, out_channels).permute(0, 3, 1, 2)


class QConv2d(torch.nn.Module):
    """Quantum 2-D convolution on NCHW images.

    wires = max(ceil(log2(k*k*Cin)), ceil(log2(Cout)), 1). ``qweights``
    (qdepth, wires, 3) is drawn from ``generator`` as
    ``U[0, 1) * pi - pi/2``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=(3, 3), padding=(1, 1), qdepth: int = 2,
                 compat_dead_qnode: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.padding = _pair(kernel_size), _pair(padding)
        self.qdepth, self.compat_dead_qnode = qdepth, compat_dead_qnode
        if self.wires > 10:
            warnings.warn(f"Too many wires ({self.wires}). "
                          "This might cause performance issues.")
        self.qweights = torch.nn.Parameter(
            qconv_uniform((qdepth, self.wires, 3), generator))

    @property
    def wires(self) -> int:
        kh, kw = self.kernel_size
        return max(math.ceil(math.log2(kh * kw * self.in_channels)),
                   math.ceil(math.log2(self.out_channels)), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h_in, w_in = x.shape
        if c != self.in_channels:
            raise ValueError(f"Expected {self.in_channels} channels, got {c}")
        (kh, kw), (ph, pw) = self.kernel_size, self.padding
        h_out, w_out = h_in + 2 * ph - kh + 1, w_in + 2 * pw - kw + 1
        # + 0.1: no all-zero patch (reference nn/qconv.py:78)
        feats = _patches(x, self.kernel_size, self.padding).reshape(
            -1, c * kh * kw) + 0.1
        if self.compat_dead_qnode:
            q = torch.clamp(feats * feats.shape[-1] * 0.5, 0.0, 1.0)
            q = q[:, ::2][:, :self.out_channels]
        else:
            u = sel_unitary(qw_tanh(self.qweights), imprimitive="cnot")
            dim = 2**self.wires
            n_rows = min(self.out_channels, dim - dim // 2)
            kept = u[0:2 * n_rows:2]                 # the even rows
            psi = amplitude_rows(feats, self.wires, 0.5).to(kept.real.dtype)
            pr = psi @ kept.real.T
            pi = psi @ kept.imag.T
            # the reference scales by the full probability width, 2**wires
            q = torch.clamp((pr * pr + pi * pi) * dim * 0.5, 0.0, 1.0)
        return _to_nchw(q, self.out_channels, b, h_out, w_out)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, padding={self.padding}, "
                f"wires={self.wires}")


def _prep_unitary(vecs: torch.Tensor) -> torch.Tensor:
    """State-preparation unitaries: U|0..0> = v for each row of ``vecs``.

    Householder completion: U = I - 2 w w^dagger with w ∝ (e0 - v), after
    aligning v's phase so that <e0, v> is real, and that phase put back.
    The reference uses MottonenStatePreparation here (nn/qconv.py:184,
    :266); on mid-circuit states the two differ by a unitary fixing
    |0..0>. vecs: (b, d) normalized complex -> (b, d, d)."""
    b, d = vecs.shape
    e0 = torch.zeros((b, d), dtype=vecs.dtype, device=vecs.device)
    e0[:, 0] = 1.0
    v0 = vecs[:, :1]
    mag = v0.abs()
    phase = torch.where(mag > 1e-9, v0 / torch.clamp(mag, min=1e-12),
                        torch.ones_like(v0))
    w = e0 - vecs * phase.conj()
    nrm = torch.sqrt(torch.sum(w.abs() ** 2, dim=1, keepdim=True))
    w = w / torch.clamp(nrm, min=1e-12)
    eye = torch.eye(d, dtype=vecs.dtype, device=vecs.device)[None]
    house = eye - 2.0 * w[:, :, None] * w.conj()[:, None, :]
    return phase[:, :, None] * house


class QConv2dMedium(torch.nn.Module):
    """Per-in-channel chained state preparations and per-channel SEL
    (reference ``_QConv2d_MEDIUM``, nn/qconv.py:129-216): pad the input
    with the constant 0.01, take each channel's k x k patches, pad them
    with 0.01 to 2**wires and L2-normalize; then for every in-channel
    prepare that channel's patch and apply that channel's SEL (CNOT ring,
    raw weights), all on the same wires; read the probabilities, scale by
    2**wires / 2, clip and keep the first Cout. ``_QConv2d_SLOW``
    (nn/qconv.py:219-304) computes the same circuit a patch at a time.

    wires = max(ceil(log2(k*k)), ceil(log2(Cout)), 1); ``qweights``
    (Cin, qdepth, wires, 3) is drawn ``U[0, 1)`` from ``generator``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=(3, 3), padding=(1, 1), qdepth: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.padding = _pair(kernel_size), _pair(padding)
        self.qdepth = qdepth
        self.qweights = torch.nn.Parameter(torch.rand(
            (in_channels, qdepth, self.wires, 3), generator=generator))

    @property
    def wires(self) -> int:
        kh, kw = self.kernel_size
        return max(math.ceil(math.log2(kh * kw)),
                   math.ceil(math.log2(self.out_channels)), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h_in, w_in = x.shape
        if c != self.in_channels:
            raise ValueError(f"Expected {self.in_channels} channels, got {c}")
        (kh, kw), (ph, pw) = self.kernel_size, self.padding
        h_out, w_out = h_in + 2 * ph - kh + 1, w_in + 2 * pw - kw + 1
        wires = self.wires
        dim = 2**wires
        xp = F.pad(x, (pw, pw, ph, ph), value=0.01)
        feats = _patches(xp, self.kernel_size, (0, 0))
        if kh * kw < dim:
            feats = F.pad(feats, (0, dim - kh * kw), value=0.01)
        nrm = torch.sqrt(torch.sum(feats * feats, dim=-1, keepdim=True))
        feats = feats / torch.clamp(nrm, min=1e-12)
        states = zero_state(feats.shape[0], wires, dtype=complex_dtype(),
                            device=x.device)
        for ic in range(self.in_channels):
            prep = _prep_unitary(feats[:, ic].to(states.dtype))
            states = torch.einsum("bij,bj->bi", prep, states)
            u = sel_unitary(self.qweights[ic], imprimitive="cnot")
            states = states @ u.to(states.dtype).T
        q = probs(states)
        q = torch.clamp(q * q.shape[-1] * 0.5, 0.0, 1.0)
        return _to_nchw(q[:, :self.out_channels], self.out_channels, b,
                        h_out, w_out)


QConv2dSlow = QConv2dMedium  # the same circuit; the reference loops patches
