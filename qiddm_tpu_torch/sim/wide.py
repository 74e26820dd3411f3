"""Wide re-uploading and SEL chains by grouped Kronecker contractions
(counterpart of ``qiddm_tpu/sim/wide.py``).

Per sublayer, the ``w`` per-wire rotations are Kronecker-composed into
``ceil(w / 7)`` group matrices of at most 128 x 128 (:func:`group_sizes`,
a balanced partition) and applied to the state's group bit axes; then the
ring: the CZ signs' multiply or the CNOT gather. The group matrices are
assembled outside the chain's autograd Function (``sel._batched_kron_chain``
on the (2, 2) gates: tiny tensors), so plain autograd carries ``dG`` back to
the rotation angles, as ``_make_wide_chain`` leaves it to JAX's autodiff.

Three routes run these groups:

* RZ-encoded blocks with a CZ ring at 11-20 wires in complex64 go through
  :func:`wide_kernel.wide_chain_planes`: on the card kernels #11 and #12
  (one launch per wire group) or, with
  ``config.set_wide_kernel_variant("monolith")``, #9 and #10; their plain
  versions on the CPU. The engine's ``reupload_block`` calls it.
* Everything else the kernels do not take goes through the grouped chain
  here, in plain PyTorch, as the JAX package runs it in XLA:
  :func:`reupload_chain_wide` (an RY encode above 10 wires, blocks above 20
  wires, a CNOT ring or complex128 from 9 wires) and :func:`sel_chain_wide`
  (the QNN and Qdense SEL chains above 12 wires, or in complex128 from 9).
  Its autograd Function has the adjoint backward of ``wide.py:181-228``:
  the states are rebuilt through the groups' inverses, so the residuals
  are the final state, the encoding and the group matrices. It is its own
  code: no kernel's plain twin runs here.
* The per-gate adjoint chains of the JAX package's ``sim/adjoint.py``
  (:func:`sel_chain_adjoint`, :func:`reupload_chain_adjoint`), taken under
  ``config.wide_mode()`` "off": the same chain with one-wire groups, so a
  sublayer is ``w`` (2, 2) contractions and the same O(1) residuals.

Cotangents follow PyTorch's convention for complex tensors. A linear map
``out = G s`` hands back ``grad_s = G^H grad_out`` and ``grad_G[x, y] =
sum grad_out[x] conj(s[y])``, so both the state (rebuilt through the true
inverse) and the cotangent go back through ``G^H``. (The JAX package pushes
its unconjugated cotangent through ``G^T``, ``_swapT``, and leaves ``s``
unconjugated in ``dG``; the two conventions are each other's conjugates,
so ``_swapT`` has no counterpart.) A CZ ring is a real diagonal, its own
inverse and adjoint; a CNOT ring is a basis permutation, whose inverse
gather is both its undo and its adjoint. Products run in full float32 or
float64: ``config`` keeps TF32 off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import config as _config
from .gates import rot_matrix
from .sel import (
    ROUTE_CALLS,
    _batched_kron_chain,
    apply_ring,
    cnot_ring_perm,
    ring_row,
    sel_ranges,
)
from .statevector import ry_gates, rz_phases, zero_state


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


def max_group_bits() -> int:
    """Group width cap: 7 bits, 128 x 128 group matrices
    (``config.MAX_GROUP_BITS``)."""
    return _config.MAX_GROUP_BITS


@functools.lru_cache(maxsize=None)
def _ring_tables(L: int, k: int, wires: int, imprimitive: str,
                 full_cycle: bool):
    """The ring data of a chain, deduplicated to the distinct ranges it uses.

    Returns ``(kind, ranges, idx)``: ``kind`` is "none" at one wire, else
    the imprimitive; ``ranges`` the distinct ring ranges, each of which
    becomes one row on the device (:func:`_ring_rows`); ``idx`` the (L, k)
    index into ``ranges`` of each sublayer. Storing each distinct row once
    matters at width: one row per sublayer is ~235 MB at (L=14, k=2,
    w=20). ``full_cycle`` makes the range cycle across the whole L*k chain
    (one deep SEL template, sel_apply_gates's semantics); otherwise it
    restarts every spectrum layer (the reference instantiates a fresh SEL
    template per re-uploading layer, nn/qdense.py:1302-1305), and every
    layer shares the first k ranges.
    """
    if imprimitive not in ("cz", "cnot"):
        raise ValueError(f"unknown imprimitive {imprimitive!r}")
    if wires == 1:
        return ("none", (), None)
    if full_cycle:
        ranges = np.asarray(sel_ranges(L * k, wires)).reshape(L, k)
    else:
        ranges = np.tile(np.asarray(sel_ranges(k, wires)), (L, 1))
    distinct = tuple(sorted({int(r) for r in ranges.flat}))
    idx = tuple(tuple(distinct.index(int(r)) for r in row) for row in ranges)
    return (imprimitive, distinct, idx)


@functools.lru_cache(maxsize=None)
def _undo_row(wires: int, rng: int, device: torch.device) -> torch.Tensor:
    """The CNOT ring's inverse gather on ``device``, made once."""
    return torch.as_tensor(np.argsort(cnot_ring_perm(wires, rng)),
                           device=device)


def _ring_rows(tables, wires: int, device, rdtype):
    """(forward rows, undo rows) of :func:`_ring_tables` on the device."""
    kind, ranges, _ = tables
    fwd = [ring_row(wires, r, kind, device, rdtype) for r in ranges]
    if kind == "cnot":
        return fwd, [_undo_row(wires, r, device) for r in ranges]
    return fwd, fwd


def _apply_group(states, g, off: int, size: int, wires: int):
    """Contract one group matrix against the state's [off, off + size) bit
    axes. states: (B, 2**w); g: (2**s, 2**s) shared or (B, 2**s, 2**s) per
    sample (RY encodings)."""
    b = states.shape[0]
    v = states.reshape(b, 2**off, 2**size, 2 ** (wires - off - size))
    spec = "xy,bpyq->bpxq" if g.ndim == 2 else "bxy,bpyq->bpxq"
    return torch.einsum(spec, g, v).reshape(b, -1)


def _group_dg(ct, s_in, off: int, size: int, wires: int, batched: bool):
    """A group's cotangent ``dG[x, y] = sum_{b, p, q} ct[..x..]
    conj(s_in[..y..])``; per sample, (B, 2**s, 2**s), when batched."""
    b = ct.shape[0]
    shape = (b, 2**off, 2**size, 2 ** (wires - off - size))
    spec = "bpxq,bpyq->bxy" if batched else "bpxq,bpyq->xy"
    return torch.einsum(spec, ct.reshape(shape), s_in.conj().reshape(shape))


def _adjT(g: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose: a unitary group's inverse and adjoint."""
    return g.conj().transpose(-1, -2)


class _WideConfig:
    """One static grouped chain: (L, k, wires, ring, encode, cycle, groups).
    ``enc`` is the RZ phases (B, 2**w), a tuple of per-sample RY group
    gates (B, 2**s, 2**s), or empty for "none"; ``gs`` a tuple over groups
    of (L, k, 2**s, 2**s)."""

    def __init__(self, L, k, wires, imprimitive, encode_kind, full_cycle,
                 sizes):
        self.L, self.k, self.wires = L, k, wires
        self.encode_kind = encode_kind
        self.sizes, self.offs = sizes, _offsets(sizes)
        self.tables = _ring_tables(L, k, wires, imprimitive, full_cycle)

    def _groups(self):
        return list(zip(self.offs, self.sizes))

    def _rows(self, like):
        if self.tables[0] == "none":
            return None, None
        return _ring_rows(self.tables, self.wires, like.device,
                          like.real.dtype)

    def forward(self, s, enc, gs):
        kind, _, idx = self.tables
        rows, _ = self._rows(s)
        for l in range(self.L):
            if self.encode_kind == "rz":
                s = s * enc[0]
            elif self.encode_kind == "ry":
                for (off, sz), e in zip(self._groups(), enc):
                    s = _apply_group(s, e, off, sz, self.wires)
            for li in range(self.k):
                for (off, sz), g in zip(self._groups(), gs):
                    s = _apply_group(s, g[l, li], off, sz, self.wires)
                if kind != "none":
                    s = apply_ring(s, rows[idx[l][li]], kind)
        return s

    def backward(self, out, ct, enc, gs):
        """(cotangent of the start state, of each encoding tensor, of each
        group's matrices)."""
        kind, _, idx = self.tables
        _, undo = self._rows(out)
        w = self.wires
        s, c = out, ct
        d_enc = [torch.zeros_like(e) for e in enc]
        dgs = [torch.zeros_like(g) for g in gs]
        groups = self._groups()
        for l in range(self.L - 1, -1, -1):
            for li in range(self.k - 1, -1, -1):
                if kind != "none":
                    row = undo[idx[l][li]]
                    s, c = apply_ring(s, row, kind), apply_ring(c, row, kind)
                for gi in range(len(groups) - 1, -1, -1):
                    off, sz = groups[gi]
                    g_h = _adjT(gs[gi][l, li])
                    s = _apply_group(s, g_h, off, sz, w)  # rebuild the input
                    dgs[gi][l, li] = _group_dg(c, s, off, sz, w, False)
                    c = _apply_group(c, g_h, off, sz, w)
            if self.encode_kind == "rz":
                e_h = enc[0].conj()  # unit phases: conj is the inverse
                s = s * e_h
                d_enc[0] += c * s.conj()
                c = c * e_h
            elif self.encode_kind == "ry":
                for gi in range(len(groups) - 1, -1, -1):
                    off, sz = groups[gi]
                    e_h = _adjT(enc[gi])
                    s = _apply_group(s, e_h, off, sz, w)
                    d_enc[gi] += _group_dg(c, s, off, sz, w, True)
                    c = _apply_group(c, e_h, off, sz, w)
        return c, d_enc, dgs


class _WideChain(torch.autograd.Function):
    """``(cfg, n_enc, states0, *enc, *gs) -> states``; saves the final
    state, the encoding and the group matrices: O(1) states."""

    @staticmethod
    def forward(ctx, cfg, n_enc, states0, *tensors):
        enc, gs = tensors[:n_enc], tensors[n_enc:]
        out = cfg.forward(states0, enc, gs)
        ctx.cfg, ctx.n_enc = cfg, n_enc
        ctx.save_for_backward(out, *tensors)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        out, *tensors = ctx.saved_tensors
        enc, gs = tensors[:ctx.n_enc], tensors[ctx.n_enc:]
        c0, d_enc, dgs = ctx.cfg.backward(out, ct, enc, gs)
        return (None, None, c0, *d_enc, *dgs)


@functools.lru_cache(maxsize=None)
def _make_wide_chain(L: int, k: int, wires: int, imprimitive: str,
                     encode_kind: str, full_cycle: bool, sizes: tuple):
    """The grouped chain for one static configuration: ``chain(states0,
    enc, gs) -> states`` with states0 (B, 2**w), enc a tuple (the RZ
    phases; the per-sample RY group gates; nothing for "none") and gs a
    tuple over groups of (L, k, 2**s, 2**s) sublayer group matrices.
    Gradients flow to all three; the ring rows are constants."""
    cfg = _WideConfig(L, k, wires, imprimitive, encode_kind, full_cycle,
                      sizes)

    def chain(states0, enc, gs):
        return _WideChain.apply(cfg, len(enc), states0, *enc, *gs)

    return chain


def _sublayer_groups(weights, sizes, cdtype):
    """(..., wires, 3) angles -> a tuple over groups of (..., 2**s, 2**s)
    composed rotations."""
    mats = rot_matrix(weights[..., 0], weights[..., 1],
                      weights[..., 2]).to(cdtype)
    return group_gates(mats, sizes)


def _encoding(x_enc, encode: str, wires: int, cdtype, sizes):
    """(kind, enc) of a re-upload: the RZ phases (B, 2**w), or the
    per-sample RY gates composed into group gates (B, 2**s, 2**s)."""
    x_enc = x_enc.to(cdtype.to_real())
    if encode in ("rz", "rz_halfpi"):
        return "rz", (rz_phases(x_enc, wires).to(cdtype),)
    if encode == "ry":
        return "ry", group_gates(ry_gates(x_enc, dtype=cdtype), sizes)
    raise ValueError(f"unknown encode {encode!r}")


def _reupload_chain(x_enc, block_weights, encode, imprimitive, cdtype,
                    sizes):
    L, k, wires, _ = block_weights.shape
    gs = _sublayer_groups(block_weights.to(cdtype.to_real()), sizes, cdtype)
    kind, enc = _encoding(x_enc, encode, wires, cdtype, sizes)
    states0 = zero_state(x_enc.shape[0], wires, dtype=cdtype,
                         device=x_enc.device)
    chain = _make_wide_chain(L, k, wires, imprimitive, kind, False, sizes)
    return chain(states0, enc, gs)


def _sel_chain(states, weights, imprimitive, sizes):
    depth, wires, _ = weights.shape
    gs = tuple(g[:, None] for g in _sublayer_groups(weights, sizes,
                                                     states.dtype))
    chain = _make_wide_chain(depth, 1, wires, imprimitive, "none", True,
                             sizes)
    return chain(states, (), gs)


def reupload_chain_wide(x_enc: torch.Tensor, block_weights: torch.Tensor, *,
                        encode: str = "rz", imprimitive: str = "cz",
                        cdtype=torch.complex64) -> torch.Tensor:
    """The grouped re-uploading block: a sublayer's wires in ceil(w / 7)
    group products.

    x_enc: (B, wires) encoding angles (the engine applies the halfpi and
    rotation-angle transforms first); block_weights: (L, k, wires, 3). The
    ring's range cycle restarts every spectrum layer (the reference
    instantiates a fresh SEL template per layer, nn/qdense.py:1302-1305).
    Returns the final states (B, 2**w); gradients flow to x_enc and the
    weights.
    """
    ROUTE_CALLS["wide"] += 1
    return _reupload_chain(x_enc, block_weights, encode, imprimitive, cdtype,
                           group_sizes(block_weights.shape[2]))


def reupload_chain_adjoint(x_enc: torch.Tensor, block_weights: torch.Tensor,
                           *, encode: str = "rz", imprimitive: str = "cz",
                           cdtype=torch.complex64) -> torch.Tensor:
    """:func:`reupload_chain_wide` gate by gate: one-wire groups."""
    ROUTE_CALLS["adjoint"] += 1
    return _reupload_chain(x_enc, block_weights, encode, imprimitive, cdtype,
                           (1,) * block_weights.shape[2])


def sel_chain_wide(states: torch.Tensor, weights: torch.Tensor,
                   imprimitive: str = "cnot") -> torch.Tensor:
    """The grouped SEL chain: ``sel.sel_apply_gates`` with the adjoint
    backward and a layer's wires in ceil(w / 7) group products (the QNN and
    Qdense wide circuits).

    states: (B, 2**w) complex; weights: (depth, wires, 3) (give them in the
    states' real dtype). The range cycle spans the full depth (one deep
    template). Gradients flow to ``states`` and ``weights``.
    """
    ROUTE_CALLS["wide"] += 1
    return _sel_chain(states, weights, imprimitive,
                      group_sizes(weights.shape[1]))


def sel_chain_adjoint(states: torch.Tensor, weights: torch.Tensor,
                      imprimitive: str = "cnot") -> torch.Tensor:
    """:func:`sel_chain_wide` gate by gate: one-wire groups."""
    ROUTE_CALLS["adjoint"] += 1
    return _sel_chain(states, weights, imprimitive,
                      (1,) * weights.shape[1])
