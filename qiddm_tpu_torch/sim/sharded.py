"""Distributed statevector simulation over a device mesh (counterpart of
``qiddm_tpu/sim/sharded.py``).

The state's most significant wires index the rank: the top
``log2(n)`` bits of the basis index select the shard of the ``n`` ranks
along the mesh dim, everything else stays local. Each rank holds a
(B, 2**w / n) slice and runs the same program on it; the device bits are
Python integers there, so a gate on a sharded wire branches in Python.

Communication a gate, as in the JAX package:

* a one-wire gate on a local wire: local (the wires of a sublayer in
  Kronecker groups, ``sim/wide.py``'s layout, unless
  ``config.wide_mode()`` is "off");
* a one-wire gate on a sharded wire: one pairwise exchange with the rank
  that differs in that bit (``batch_isend_irecv`` on the dim's group, the
  JAX ``ppermute``), then a local axpy;
* CZ: diagonal, always local (one sign row a ring, from the global index);
* CNOT: a sharded control with a local target flips locally; a sharded
  target takes one masked pairwise exchange;
* a readout: local partial sums and one all-reduce (the JAX ``psum``).

Autograd through the collectives follows ``shard_map``'s rules. The
replicated inputs (angles, weights) enter through :class:`_Varying`, whose
backward sums the ranks' partial cotangents in one all-reduce; the
all-reduce of a readout hands each rank its replicated output's cotangent
once (identity backward), as does the all-gather of the probabilities (each
rank takes its own columns); an all-reduce inside the program, whose
result meets the local state again (amplitude damping's branch weights),
sums its cotangent; the pairwise exchange is an involution, so its
backward is the same exchange. The adjoint route (:class:`_AdjointChain`)
rebuilds the state through the inverse gates in its backward instead of
keeping every intermediate, and leaves its gate cotangents as per-rank
partials for :class:`_Varying` to sum.

Trajectories draw their branches from one generator on every rank, in the
order ``sim/trajectories.py`` draws them (one (w, rows) draw an
application point), so a seed gives the sharded and the dense trajectory
backends the same branches. This module runs no kernel: the JAX package's
sharded programs are einsums and collectives inside ``jax.shard_map``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from .. import config as _config
from ..parallel.mesh import COLLECTIVES, axis_size, placements
from .gates import rot_matrix
from .sel import _batched_kron_chain, sel_ranges
from .statevector import _z_signs_on, ry_gates
from .trajectories import _pauli_mixture, _source
from .wide import _adjT, _apply_group, _group_dg, _offsets, group_sizes

_ENCODES = ("rz", "rz_halfpi", "ry")
_CHANNELS = ("phase_damping", "depolarizing", "amplitude_damping")


def _local_group_layout(local_wires: int, grouped: bool):
    """The LOCAL wires in Kronecker groups (``sim/wide.py``'s partition);
    ``grouped=False`` gives one-wire groups, the per-wire einsums."""
    if not local_wires:
        return (), ()
    sizes = group_sizes(local_wires) if grouped else (1,) * local_wires
    return sizes, _offsets(sizes)


class ShardedState:
    """A (2**wires,) statevector sharded over the mesh dim ``axis``: this
    rank's view of the layout (its index along ``axis``, the shard bits,
    the local wires)."""

    def __init__(self, wires: int, mesh, axis: str = "data"):
        self.wires = wires
        self.mesh = mesh
        self.axis = axis
        self.n_dev = axis_size(mesh, axis)
        self.shard_bits = int(math.log2(self.n_dev))
        if 2**self.shard_bits != self.n_dev:
            raise ValueError("device-axis size must be a power of two")
        if self.shard_bits > wires:
            raise ValueError("more shard bits than wires")
        self.local_wires = wires - self.shard_bits
        self.index = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device("cpu"))

    def dev_bit(self, j: int) -> int:
        """This rank's bit of sharded wire ``j``."""
        return (self.index >> (self.shard_bits - 1 - j)) & 1

    def wrap(self, local: torch.Tensor):
        """This rank's (1, 2**local_wires) slice as the global (n, 2**lw)
        DTensor, sharded over ``axis``."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.mesh,
                                  placements(self.mesh, self.axis),
                                  run_check=False)


def _local_of(state) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return state.to_local() if isinstance(state, DTensor) else state


def zero_state_sharded(spec: ShardedState, dtype=torch.complex64):
    """|0...0> as the (n, 2**local_wires) DTensor: the one amplitude lives
    in rank 0's shard."""
    local = torch.zeros((1, 2**spec.local_wires), dtype=dtype,
                        device=spec.device)
    if spec.index == 0:
        local[0, 0] = 1.0
    return spec.wrap(local)


# --- collectives with their autograd rules ------------------------------------

def _exchange(t: torch.Tensor, spec: ShardedState, bit: int) -> torch.Tensor:
    """``t`` of the rank whose index differs from this one's in ``bit``
    (contiguous real views on the wire)."""
    cplx = t.is_complex()
    send = (torch.view_as_real(t) if cplx else t).contiguous()
    recv = torch.empty_like(send)
    peer = dist.get_global_rank(spec.group, spec.index ^ bit)
    COLLECTIVES["p2p"] += 1
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, peer, spec.group),
            dist.P2POp(dist.irecv, recv, peer, spec.group)]):
        req.wait()
    return torch.view_as_complex(recv) if cplx else recv


def _all_reduce(t: torch.Tensor, spec: ShardedState) -> torch.Tensor:
    out = t.clone()
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(out, group=spec.group)
    return out


class _PairSwap(torch.autograd.Function):
    """The partner's slice across a sharded wire; an involution, so the
    backward exchanges the cotangent the same way."""

    @staticmethod
    def forward(ctx, t, spec, bit):
        ctx.spec, ctx.bit = spec, bit
        return _exchange(t, spec, bit)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _exchange(g, ctx.spec, ctx.bit), None, None


class _Varying(torch.autograd.Function):
    """Replicated inputs entering the per-rank program: identity forward;
    the backward sums the ranks' partial cotangents in one all-reduce (the
    transpose of ``shard_map``'s replicated in_specs)."""

    @staticmethod
    def forward(ctx, spec, *ts):
        ctx.spec = spec
        ctx.shapes = [t.shape for t in ts]
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    @once_differentiable
    def backward(ctx, *gs):
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in gs]), ctx.spec)
        parts = torch.split(flat, [math.prod(s) for s in ctx.shapes])
        return (None, *(p.reshape(s) for p, s in zip(parts, ctx.shapes)))


class _SumReplicated(torch.autograd.Function):
    """A readout's all-reduce: its output is replicated and every rank's
    loss is the same, so each rank's partial takes the cotangent once."""

    @staticmethod
    def forward(ctx, t, spec):
        return _all_reduce(t, spec)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumVarying(torch.autograd.Function):
    """An all-reduce whose result meets the local state again: each rank's
    use contributes a partial cotangent, summed in the backward."""

    @staticmethod
    def forward(ctx, t, spec):
        ctx.spec = spec
        return _all_reduce(t, spec)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _all_reduce(g, ctx.spec), None


class _GatherColumns(torch.autograd.Function):
    """(B, 2**lw) local probabilities -> (B, 2**w) on every rank, columns
    in rank order; the backward keeps this rank's columns."""

    @staticmethod
    def forward(ctx, t, spec):
        ctx.spec, ctx.cols = spec, t.shape[1]
        local = t.T.contiguous()
        out = local.new_empty((spec.n_dev * local.shape[0], local.shape[1]))
        COLLECTIVES["all_gather"] += 1
        dist.all_gather_into_tensor(out, local, group=spec.group)
        return out.T.contiguous()

    @staticmethod
    def backward(ctx, g):
        lo = ctx.spec.index * ctx.cols
        return g[:, lo:lo + ctx.cols], None


# --- per-rank gate semantics ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _local_bit(local_wires: int, tl: int, device: torch.device):
    """(2**lw,) bool: local wire ``tl``'s bit of each local amplitude."""
    idx = torch.arange(2**local_wires, device=device)
    return ((idx >> (local_wires - 1 - tl)) & 1).bool()


@functools.lru_cache(maxsize=None)
def _cz_row(wires: int, shard_bits: int, index: int, rng: int,
            device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The CZ ring ``prod_j CZ(j, (j + rng) % w)`` on this rank's local
    amplitudes: one (2**lw,) row of signs from their global indices."""
    lw = wires - shard_bits
    g = (index << lw) + np.arange(2**lw, dtype=np.int64)
    parity = np.zeros_like(g)
    for j in range(wires):
        t = (j + rng) % wires
        parity ^= (g >> (wires - 1 - j)) & (g >> (wires - 1 - t)) & 1
    return torch.as_tensor(1 - 2 * parity, dtype=dtype, device=device)


class _Ops:
    """The gate semantics on one rank's (B, 2**lw) slice, shared by the
    plain, trajectory and adjoint bodies so that they cannot drift."""

    def __init__(self, spec: ShardedState, grouped: bool):
        self.spec = spec
        self.s_bits, self.lw = spec.shard_bits, spec.local_wires
        self.sizes, self.offs = _local_group_layout(self.lw, grouped)

    def groups(self):
        return list(zip(self.offs, self.sizes))

    def local_groups_of(self, mats_local):
        """Per-LOCAL-wire gates (..., lw, 2, 2) Kronecker-composed into the
        group layout: a tuple of (..., 2**s, 2**s)."""
        return tuple(_batched_kron_chain(mats_local[..., o:o + s, :, :])
                     for o, s in self.groups())

    def swap(self, t, j):
        return _PairSwap.apply(t, self.spec, 1 << (self.s_bits - 1 - j))

    def apply_1q_shard(self, local, gate, j):
        """A (2, 2) gate, or one a sample (B, 2, 2), on sharded wire j."""
        other = self.swap(local, j)
        e = _entries(gate)
        if self.spec.dev_bit(j) == 0:
            return e(0, 0) * local + e(0, 1) * other
        return e(1, 0) * other + e(1, 1) * local

    def apply_1q_any(self, local, gate, j):
        if j < self.s_bits:
            return self.apply_1q_shard(local, gate, j)
        tl = j - self.s_bits
        return _apply_group(local, gate, tl, 1, self.lw)

    def apply_group(self, local, g, o, s):
        return _apply_group(local, g, o, s, self.lw)

    def _cnot(self, local, c, t):
        if c < self.s_bits:
            if not self.spec.dev_bit(c):
                return local
            mask = None
        else:
            mask = _local_bit(self.lw, c - self.s_bits, local.device)
        if t < self.s_bits:
            flipped = self.swap(local, t)
        else:
            tl = t - self.s_bits
            b = local.shape[0]
            flipped = local.reshape(b, 2**tl, 2, -1).flip(2).reshape(b, -1)
        return flipped if mask is None else torch.where(mask, flipped, local)

    def ring(self, local, rng: int, imprimitive: str, reverse: bool = False):
        """A SEL ring of range ``rng``. The CZ ring is one diagonal of
        signs, its own inverse; the CNOT ring is sequential, undone gate
        by gate in reverse order (each CNOT is self-inverse)."""
        wires = self.spec.wires
        if wires == 1:
            return local
        if imprimitive == "cz":
            return local * _cz_row(wires, self.s_bits, self.spec.index, rng,
                                   local.device, local.real.dtype)
        order = range(wires - 1, -1, -1) if reverse else range(wires)
        for j in order:
            local = self._cnot(local, j, (j + rng) % wires)
        return local

    def rz_plane(self, x, cplx):
        """exp(i * angle) on this rank's amplitudes, (B, 2**lw): the angle
        ``-0.5 * sum_j sign_j(i) * x_j`` with the device bits' part a
        scalar a sample, in the state's real precision."""
        rdt = cplx.to_real()
        x = x.to(rdt)
        ang = torch.zeros(x.shape[0], dtype=rdt, device=x.device)
        for j in range(self.s_bits):
            ang = ang - 0.5 * (1.0 - 2.0 * self.spec.dev_bit(j)) * x[:, j]
        signs = _z_signs_on(self.lw, rdt, x.device)
        total = ang[:, None] + (-0.5 * (x[:, self.s_bits:] @ signs.T))
        return torch.complex(torch.cos(total), torch.sin(total))

    def init_state(self, batch, cplx, device):
        local = torch.zeros((batch, 2**self.lw), dtype=cplx, device=device)
        if self.spec.index == 0:
            local[:, 0] = 1.0
        return local

    def wire_partials(self, p):
        """(B, wires) partial PauliZ sums of local probabilities ``p``."""
        shard = [(1.0 - 2.0 * self.spec.dev_bit(j)) * p.sum(1)
                 for j in range(self.s_bits)]
        local = p @ _z_signs_on(self.lw, p.dtype, p.device)
        if not shard:
            return local
        return torch.cat([torch.stack(shard, 1), local], 1)


def _entries(gate):
    """``e(x, y)``: entry (x, y) of a (2, 2) gate, or of per-sample gates
    (B, 2, 2) as a (B, 1) column against (B, 2**lw) slices."""
    if gate.ndim == 2:
        return lambda x, y: gate[x, y]
    return lambda x, y: gate[:, x, y, None]


def _probs(local):
    return local.real ** 2 + local.imag ** 2


# --- the SEL program -------------------------------------------------------------

def make_sel_program(spec: ShardedState, layers: int,
                     imprimitive: str = "cz"):
    """``f(state, weights)`` applying SEL(layers) to a sharded state (the
    DTensor of :func:`zero_state_sharded`); weights (layers, wires, 3),
    replicated. The ring ranges cycle over the full depth. Returns the new
    state as a DTensor of the same layout. Differentiable."""
    ops = _Ops(spec, _config.wide_mode() != "off")
    ranges = sel_ranges(layers, spec.wires)
    s_bits = spec.shard_bits

    def run(state, weights):
        local = _local_of(state)
        (weights,) = _Varying.apply(spec, weights)
        for l in range(layers):
            mats = rot_matrix(weights[l, :, 0], weights[l, :, 1],
                              weights[l, :, 2]).to(local.dtype)
            for j in range(s_bits):
                local = ops.apply_1q_shard(local, mats[j], j)
            for (o, s), g in zip(ops.groups(),
                                 ops.local_groups_of(mats[s_bits:])):
                local = ops.apply_group(local, g, o, s)
            local = ops.ring(local, ranges[l], imprimitive)
        return spec.wrap(local)

    return run


# --- the re-uploading program ----------------------------------------------------

class _AdjointChain(torch.autograd.Function):
    """``(prog, n_enc, *enc, mats_shard, *groups) -> local state``: the
    clean chain whose backward rebuilds the state through the inverse gates
    (O(1) saved states a rank) and hands back per-rank partial cotangents
    of the encoding and the gates, in PyTorch's complex convention (a map
    ``out = G s`` gives ``grad_s = G^H grad_out`` and ``grad_G = grad_out
    conj(s)``)."""

    @staticmethod
    def forward(ctx, prog, n_enc, *tensors):
        enc, mats_shard, groups = (tensors[:n_enc], tensors[n_enc],
                                   tensors[n_enc + 1:])
        out = prog.chain(enc, mats_shard, groups)
        ctx.prog, ctx.n_enc = prog, n_enc
        ctx.save_for_backward(out, *tensors)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        out, *tensors = ctx.saved_tensors
        n_enc = ctx.n_enc
        grads = ctx.prog.chain_bwd(out, ct, tensors[:n_enc], tensors[n_enc],
                                   tensors[n_enc + 1:])
        return (None, None, *grads)


class _ReuploadProgram:
    """One static configuration of the sharded re-uploading block."""

    def __init__(self, spec, L, k, imprimitive, encode, readout, dtype,
                 noise_kind, noise_placement, adjoint, grouped):
        self.spec, self.L, self.k = spec, L, k
        self.imprimitive, self.encode, self.readout = (imprimitive, encode,
                                                       readout)
        self.dtype = dtype
        self.noise_kind, self.noise_placement = noise_kind, noise_placement
        self.adjoint = adjoint
        self.ops = _Ops(spec, grouped)
        self.ranges = sel_ranges(k, spec.wires)  # restart every layer

    # the encoding ------------------------------------------------------------
    def build_enc(self, x):
        """RY: (per-sample gates on the sharded wires (B, s, 2, 2), their
        local groups (B, 2**s, 2**s)...), replicated; RZ: the phase plane
        (B, 2**lw), this rank's own. Built outside the adjoint Function, so
        autograd carries its cotangent back to x."""
        s_bits = self.spec.shard_bits
        if self.encode == "ry":
            g = ry_gates(x, dtype=self.dtype)
            return (g[:, :s_bits], *self.ops.local_groups_of(g[:, s_bits:]))
        return (self.ops.rz_plane(x, self.dtype),)

    def enc_fwd(self, local, enc):
        if self.encode != "ry":
            return local * enc[0]
        for j in range(self.spec.shard_bits):
            local = self.ops.apply_1q_shard(local, enc[0][:, j], j)
        for (o, s), g in zip(self.ops.groups(), enc[1:]):
            local = self.ops.apply_group(local, g, o, s)
        return local

    def sublayer(self, local, mats_shard, groups, kk):
        """One SEL sublayer: mats_shard (s, 2, 2), groups the local group
        matrices."""
        ops = self.ops
        for j in range(self.spec.shard_bits):
            local = ops.apply_1q_shard(local, mats_shard[j], j)
        for (o, s), g in zip(ops.groups(), groups):
            local = ops.apply_group(local, g, o, s)
        return ops.ring(local, self.ranges[kk], self.imprimitive)

    # the bodies --------------------------------------------------------------
    def chain(self, enc, mats_shard, groups):
        """The clean chain from |0...0>: mats_shard (L, k, s, 2, 2), groups
        a tuple of (L, k, 2**s, 2**s)."""
        local = self.ops.init_state(enc[0].shape[0], self.dtype,
                                    enc[0].device)
        for l in range(self.L):
            local = self.enc_fwd(local, enc)
            for kk in range(self.k):
                local = self.sublayer(local, mats_shard[l, kk],
                                      [g[l, kk] for g in groups], kk)
        return local

    def _g_bwd(self, s, c, g, j):
        """Reverse a one-wire gate on sharded wire j: this rank's input
        state, cotangent, and partial of dG (2, 2), or (B, 2, 2) for
        per-sample gates. Both halves of the input are computable from
        this rank's slice and its partner's."""
        so, co = self.ops.swap(s, j), self.ops.swap(c, j)
        e = _entries(g.conj())
        dims = (1,) if g.ndim == 3 else (0, 1)
        if self.spec.dev_bit(j) == 0:
            s_in = e(0, 0) * s + e(1, 0) * so
            s_par = e(0, 1) * s + e(1, 1) * so
            c_in = e(0, 0) * c + e(1, 0) * co
        else:
            s_in = e(0, 1) * so + e(1, 1) * s
            s_par = e(0, 0) * so + e(1, 0) * s
            c_in = e(0, 1) * co + e(1, 1) * c
        own = (c * s_in.conj()).sum(dim=dims)
        cross = (c * s_par.conj()).sum(dim=dims)
        zero = torch.zeros_like(own)
        if self.spec.dev_bit(j) == 0:
            rows = [[own, cross], [zero, zero]]
        else:
            rows = [[zero, zero], [cross, own]]
        du = torch.stack([torch.stack(r, -1) for r in rows], -2)
        return s_in, c_in, du

    def _group_bwd(self, s, c, g, o, sz, batched):
        s = self.ops.apply_group(s, _adjT(g), o, sz)
        dg = _group_dg(c, s, o, sz, self.ops.lw, batched)
        return s, self.ops.apply_group(c, _adjT(g), o, sz), dg

    def chain_bwd(self, out, ct, enc, mats_shard, groups):
        ops, s_bits = self.ops, self.spec.shard_bits
        layout = ops.groups()
        s, c = out, ct
        d_enc = [torch.zeros_like(e) for e in enc]
        dms = torch.zeros_like(mats_shard)
        dgs = [torch.zeros_like(g) for g in groups]
        for l in range(self.L - 1, -1, -1):
            for kk in range(self.k - 1, -1, -1):
                s = ops.ring(s, self.ranges[kk], self.imprimitive, True)
                c = ops.ring(c, self.ranges[kk], self.imprimitive, True)
                for gi in range(len(layout) - 1, -1, -1):
                    o, sz = layout[gi]
                    s, c, dgs[gi][l, kk] = self._group_bwd(
                        s, c, groups[gi][l, kk], o, sz, False)
                for j in range(s_bits - 1, -1, -1):
                    s, c, dms[l, kk, j] = self._g_bwd(s, c,
                                                      mats_shard[l, kk, j], j)
            if self.encode != "ry":
                e_h = enc[0].conj()  # unit phases: conj is the inverse
                s = s * e_h
                d_enc[0] += c * s.conj()
                c = c * e_h
                continue
            for gi in range(len(layout) - 1, -1, -1):
                o, sz = layout[gi]
                s, c, dg = self._group_bwd(s, c, enc[1 + gi], o, sz, True)
                d_enc[1 + gi] += dg
            for j in range(s_bits - 1, -1, -1):
                s, c, du = self._g_bwd(s, c, enc[0][:, j], j)
                d_enc[0][:, j] += du
        return (*d_enc, dms, *dgs)

    def channel(self, local, draws, strength):
        """One trajectory step of the per-wire channel, drawn as
        ``trajectories.apply_channel_trajectory`` draws it: (w, rows)
        branch indices for the Pauli kinds, (w, rows) uniforms for
        amplitude damping, whose branch weights take one all-reduce a
        wire (P(wire = 1) summed in float64, as the dense pass sums it)."""
        ops, spec = self.ops, self.spec
        wires, b, dev = spec.wires, local.shape[0], local.device
        if self.noise_kind != "amplitude_damping":
            p, mats = _pauli_mixture(self.noise_kind, strength, dev,
                                     local.dtype)
            idx = draws.branches(p, (wires, b), dev)
            for j in range(wires):
                local = ops.apply_1q_any(local, mats[idx[j]], j)
            return local
        u = draws.uniform((wires, b), dev)
        forced = draws.forced_picks()
        rdt = local.real.dtype
        g = torch.as_tensor(strength, dtype=rdt, device=dev)
        sqg = torch.sqrt(torch.clamp(g, min=0.0))
        sq1g = torch.sqrt(torch.clamp(1.0 - g, min=0.0))
        taken = []
        for j in range(wires):
            p = _probs(local).double()
            if j < spec.shard_bits:
                part = p.sum(1) * spec.dev_bit(j)
            else:
                part = p @ _local_bit(ops.lw, j - spec.shard_bits,
                                      dev).double()
            p1d = g.double() * _SumVarying.apply(part, spec)
            pick = (forced[j].to(torch.bool) if forced is not None
                    else u[j].double() < p1d)
            p1 = p1d.to(rdt)
            # the unused branch's argument set to 1: no infinite
            # derivative meets a zero cotangent in backward
            inv1 = torch.rsqrt(torch.where(pick, p1.clamp(min=1e-30), 1.0))
            inv0 = torch.rsqrt(torch.where(pick, 1.0,
                                           (1.0 - p1).clamp(min=1e-30)))
            zero = torch.zeros_like(inv0)
            g00 = torch.where(pick, zero, inv0)
            g01 = torch.where(pick, sqg * inv1, zero)
            g11 = torch.where(pick, zero, sq1g * inv0)
            gate = torch.stack([torch.stack([g00, g01], -1),
                                torch.stack([zero, g11], -1)], -2)
            local = ops.apply_1q_any(local, gate.to(local.dtype), j)
            taken.append(pick)
        draws.took(torch.stack(taken).to(torch.uint8))
        return local

    def plain(self, enc, weights, draws, strength):
        """The chain under autograd, with the trajectory channel when the
        program has one."""
        s_bits = self.spec.shard_bits
        noisy = self.noise_kind is not None
        local = self.ops.init_state(enc[0].shape[0], self.dtype,
                                    enc[0].device)
        for l in range(self.L):
            local = self.enc_fwd(local, enc)
            if noisy and self.noise_placement == "encode":
                local = self.channel(local, draws, strength)
            for kk in range(self.k):
                w = weights[l, kk]
                mats = rot_matrix(w[:, 0], w[:, 1], w[:, 2]).to(self.dtype)
                local = self.sublayer(local, mats[:s_bits],
                                      self.ops.local_groups_of(mats[s_bits:]),
                                      kk)
        if noisy and self.noise_placement == "end":
            local = self.channel(local, draws, strength)
        return local

    def __call__(self, x_enc, weights, rng=None, strength=None):
        """x_enc (B, wires), weights (L, k, wires, 3), both replicated.
        Returns (B, wires) expvals, replicated, or this rank's (B, 2**lw)
        columns of the probabilities."""
        rdt = self.dtype.to_real()
        x, w = _Varying.apply(self.spec, x_enc.to(self.spec.device, rdt),
                              weights.to(self.spec.device, rdt))
        if self.encode == "rz_halfpi":
            x = (math.pi * 0.5) * x
        enc = self.build_enc(x)
        s_bits = self.spec.shard_bits
        if self.adjoint:
            flat = w.reshape(self.L * self.k, self.spec.wires, 3)
            mats = rot_matrix(flat[..., 0], flat[..., 1],
                              flat[..., 2]).to(self.dtype).reshape(
                                  self.L, self.k, self.spec.wires, 2, 2)
            # group assembly outside the Function: autograd carries dG back
            # to the rotation angles
            groups = self.ops.local_groups_of(mats[:, :, s_bits:])
            local = _AdjointChain.apply(self, len(enc), *enc,
                                        mats[:, :, :s_bits], *groups)
        else:
            draws = _source(rng) if self.noise_kind is not None else None
            local = self.plain(enc, w, draws, strength)
        p = _probs(local)
        if self.readout == "probs":
            return p
        return _SumReplicated.apply(self.ops.wire_partials(p), self.spec)


def make_reupload_program(spec: ShardedState, L: int, k: int, *,
                          imprimitive: str = "cz", encode: str = "rz",
                          readout: str = "expvalz", dtype=torch.complex64,
                          noise_kind=None, noise_placement: str = "encode",
                          adjoint: bool = False, grouped: bool = True):
    """The batched re-uploading block over the mesh, the engine's
    ``reupload_block`` semantics (L x [per-wire encode -> SEL(k)]) for
    states too large for one device.

    Returns ``f(x_enc (B, wires), weights (L, k, wires, 3))``: (B, wires)
    expvals, replicated, or (B, 2**w / n) probabilities, this rank's
    columns. The batch is replicated; the state dimension is split over
    ``spec.axis``. With ``noise_kind`` the program is ONE Monte-Carlo
    trajectory of the noisy block (``noise_placement`` "encode" after every
    re-upload, "end" once after it): ``f(x_enc, weights, rng, strength)``,
    ``rng`` a generator (or ``trajectories.TrajDraws``) seeded alike on
    every rank. ``adjoint`` (clean chain only) takes the O(1)-residual
    adjoint backward."""
    if encode not in _ENCODES:
        raise NotImplementedError(
            f"sharded reupload supports rz/rz_halfpi/ry encodings, "
            f"got {encode!r}")
    if noise_kind is not None and noise_kind not in _CHANNELS:
        raise NotImplementedError(
            f"no trajectory unraveling for channel {noise_kind!r}")
    if imprimitive not in ("cz", "cnot"):
        raise ValueError(f"unknown imprimitive {imprimitive!r}")
    if readout not in ("probs", "expvalz"):
        raise ValueError(f"unknown readout {readout!r}")
    return _ReuploadProgram(spec, L, k, imprimitive, encode, readout, dtype,
                            noise_kind, noise_placement,
                            adjoint and noise_kind is None, grouped)


@functools.lru_cache(maxsize=64)
def _cached_reupload_program(wires, mesh, group, axis, L, k, imprimitive,
                             encode, readout, dtype, noise_kind=None,
                             noise_placement="encode", adjoint=False,
                             grouped=True):
    """One program object a static configuration. ``group`` (the dim's
    process group) is part of the key: meshes of the same layout compare
    equal, so a group formed after a ``shutdown`` gets a new program
    rather than one bound to the destroyed group."""
    return make_reupload_program(
        ShardedState(wires, mesh, axis), L, k, imprimitive=imprimitive,
        encode=encode, readout=readout, dtype=dtype, noise_kind=noise_kind,
        noise_placement=noise_placement, adjoint=adjoint, grouped=grouped)


def reupload_block_sharded(x_enc, block_weights, mesh, *, axis: str = "data",
                           imprimitive: str = "cz", encode: str = "rz",
                           readout: str = "expvalz", dtype=torch.complex64,
                           noise_kind=None, noise_strength=None,
                           traj_rng=None, n_traj: int = 0,
                           noise_placement: str = "encode"):
    """One-call form of :func:`make_reupload_program` for the engine's
    mesh route: expvals replicated, or the probabilities all-gathered to
    (B, 2**w), on every rank.

    With ``noise_kind`` and ``n_traj``: the Monte-Carlo trajectory
    estimate, the trajectories tiling the batch (row ``t * B + b``), the
    readout averaged over them, with the dense backend's draws for the
    same ``traj_rng`` seed."""
    L, k, wires, _ = block_weights.shape
    if noise_kind is not None and (n_traj <= 0 or traj_rng is None):
        raise ValueError(
            "noise_kind on the sharded path needs n_traj > 0 and a "
            "traj_rng (Monte-Carlo trajectory backend)")
    # the mesh path is the wide regime: the adjoint backward unless
    # config.adjoint_mode() is "off"; "off" of config.wide_mode() gives
    # one-wire groups
    adjoint = noise_kind is None and _config.adjoint_mode() != "off"
    grouped = _config.wide_mode() != "off"
    prog = _cached_reupload_program(wires, mesh, mesh.get_group(axis),
                                    axis, int(L), int(k), imprimitive,
                                    encode, readout, dtype, noise_kind,
                                    noise_placement, adjoint, grouped)
    if noise_kind is None:
        out = prog(x_enc, block_weights)
    else:
        b = x_enc.shape[0]
        xT = x_enc.repeat(n_traj, 1)
        out = prog(xT, block_weights, traj_rng, noise_strength)
    if readout == "probs":
        out = _GatherColumns.apply(out, prog.spec)
    if noise_kind is not None:
        out = out.reshape((n_traj, b) + tuple(out.shape[1:])).mean(dim=0)
    return out


def probs_sharded(spec: ShardedState, state):
    """The probability vector, still sharded: a DTensor of this rank's
    (1, 2**lw) slice."""
    return spec.wrap(_probs(_local_of(state)))


def expval_z_sharded(spec: ShardedState, state):
    """<Z_j> for every wire: local partials and one all-reduce, (wires,)
    replicated."""
    ops = _Ops(spec, False)
    partial = ops.wire_partials(_probs(_local_of(state)))
    return _SumReplicated.apply(partial, spec)[0]
