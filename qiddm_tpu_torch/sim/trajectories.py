"""Monte-Carlo trajectory (Kraus-unraveling) noise backend (counterpart of
``qiddm_tpu/sim/trajectories.py``).

The density-matrix backend simulates the channels exactly at O(4^w) memory
and work a sample. This module simulates the same per-wire channels on
statevectors by stochastic unraveling: each trajectory samples one Kraus
branch per (sample, application point, wire), and the readout is the mean
over ``n_traj`` trajectories, O(n_traj 2^w). It is the noisy route past the
density-matrix kernel's width.

Unravelings per channel kind (conventions of ``channels.py``):

* ``phase_damping(g)``: the channel equals ``rho -> (1-q) rho + q Z rho Z``
  with ``q = (1 - sqrt(1-g))/2``, so a trajectory applies Z with probability
  q. Both branches are diagonal, so the drawn Pauli string of a sample is one
  sign plane ``(-1)^popcount(i & zmask)``.
* ``depolarizing(p)``: I/X/Y/Z with probabilities ``(1-p, p/3, p/3, p/3)``,
  a per-wire single-qubit gate per sample.
* ``amplitude_damping(g)``: norm-weighted Kraus sampling, one pass over all
  wires in order: kernel #7, ``amp_damp_kernel.amp_damp``, for complex64
  states up to its 12 wires; past that, or in complex128, its PyTorch
  counterpart :func:`_amp_damp_xla` (the JAX package's XLA pass), chosen by
  width and dtype alone.

Trajectories are flattened into the batch, as in the JAX package: row
``t * B + b`` is trajectory t of sample b (:func:`_tile_traj`), so the SEL
layers are shared by all trajectories and only the channel draws are
per-row. The SEL step (:func:`_sel_route`): complex64 up to 12 wires takes
the engine's rule, at ``n_traj * B >= 2**w`` the composed per-layer
unitaries applied with one complex matmul each (the JAX package leaves that
product to XLA too), below it the SEL-chain kernel #5 on the (N, d) rows as
they are (``sel_kernel.sel_chain_rows``: no transpose), one call per
spectrum layer, whose ring ranges restart at each call as the JAX tiled
route relies on. Past 12 wires, or in complex128, the JAX package's XLA
routes: the per-layer unitaries up to 10 wires (composed from ``2**w``
rows) and ``sel.sel_apply_gates`` above.

Random draws. JAX keys cannot be matched bit for bit, so the port draws from
a ``torch.Generator`` on the states' device: (w, N) uniforms for amplitude
damping, and for the Pauli kinds (w, N) branch indices from uniforms by
inverse CDF against the cumulative mixture probabilities, on the device.
Every trajectory function takes its random source as ``rng``: a generator,
or a :class:`TrajDraws`. That class is the one seam through which draws are
injected: :class:`ReplayDraws` hands out given draws in the order of the
application points (tests pass the JAX package's draws; chip_smoke.py
replays the card's on the CPU) and can force recorded branch picks on the
amplitude-damping passes; :class:`RecordedDraws` keeps what a generator
drew and the picks the passes took.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from .. import config as _config
from .amp_damp_kernel import amp_damp
from .gates import WEIGHT_MAPS, rot_matrix
from .sel import (
    ROUTE_CALLS,
    sel_apply_gates,
    sel_layer_unitaries,
    sel_unitaries,
    sel_unitary,
)
from .sel_kernel import sel_chain_rows
from .statevector import (
    amplitude_embed,
    apply_1q,
    apply_ry_all,
    apply_unitary,
    bit_table,
    expval_z,
    probs,
    ry_product_state,
    rz_phases,
    zero_state,
)

_I2 = np.eye(2)
_X = np.array([[0, 1], [1, 0]])
_Y = np.array([[0, -1j], [1j, 0]])
_Z = np.diag([1, -1])


# --- random draws ------------------------------------------------------------

class TrajDraws:
    """The draws of the trajectory backend from a ``torch.Generator`` on the
    states' device. Each channel application point asks for one (w, N)
    draw: :meth:`uniform` for amplitude damping, :meth:`branches` for the
    Pauli kinds."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _rand(self, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=device)

    def uniform(self, shape, device) -> torch.Tensor:
        return self._rand(shape, device)

    def branches(self, p: torch.Tensor, shape, device) -> torch.Tensor:
        """Branch indices with probabilities ``p`` (m,): a uniform per entry
        against the cumulative probabilities, by inverse CDF on the
        device."""
        u = self._rand(shape, device)
        edges = torch.cumsum(p.to(u.dtype), 0)[:-1]
        return (u[..., None] >= edges).sum(-1)

    def forced_picks(self) -> Optional[torch.Tensor]:
        """Branch picks the next amplitude-damping pass must follow, or
        None to take its own from the uniforms."""
        return None

    def took(self, picks: torch.Tensor) -> None:
        """The picks an amplitude-damping pass took."""


class RecordedDraws(TrajDraws):
    """A generator's draws, each kept in ``draws`` as it is handed out, and
    the amplitude-damping passes' picks in ``picks``."""

    def __init__(self, generator: torch.Generator):
        super().__init__(generator)
        self.draws, self.picks = [], []

    def uniform(self, shape, device):
        self.draws.append(super().uniform(shape, device))
        return self.draws[-1]

    def branches(self, p, shape, device):
        self.draws.append(super().branches(p, shape, device))
        return self.draws[-1]

    def took(self, picks):
        self.picks.append(picks)


class ReplayDraws(TrajDraws):
    """Given draws, one per application point in order: (w, N) uniforms
    for amplitude damping, (w, N) branch indices for the Pauli kinds. With
    ``picks``, the amplitude-damping passes follow those picks in order."""

    def __init__(self, draws, picks=None):
        super().__init__(None)
        self._draws = iter(draws)
        self._picks = None if picks is None else iter(picks)

    def uniform(self, shape, device):
        return self._next(shape, device, torch.float32)

    def branches(self, p, shape, device):
        return self._next(shape, device, torch.int64)

    def forced_picks(self):
        return None if self._picks is None else next(self._picks)

    def _next(self, shape, device, dtype):
        try:
            draw = next(self._draws)
        except StopIteration:
            raise ValueError("the replayed draws ran out") from None
        if tuple(np.shape(draw)) != tuple(shape):
            raise ValueError(f"replayed draw of shape {tuple(draw.shape)}, "
                             f"the application point needs {tuple(shape)}")
        if not torch.is_tensor(draw):
            draw = torch.tensor(np.asarray(draw))
        return draw.to(device=device, dtype=dtype)


def _source(rng) -> TrajDraws:
    """The random source as a :class:`TrajDraws`; a missing one raises, as
    the JAX package's ``_require_key`` does."""
    if rng is None:
        raise ValueError(
            "the trajectory backend needs a random source: pass "
            "traj_rng=torch.Generator(device=...) alongside n_traj")
    if isinstance(rng, TrajDraws):
        return rng
    if isinstance(rng, torch.Generator):
        return TrajDraws(rng)
    raise TypeError(f"a trajectory random source is a torch.Generator or a "
                    f"TrajDraws, not {type(rng).__name__}")


# --- channels ----------------------------------------------------------------

_PAULI_MATS = {"phase_damping": np.stack([_I2, _Z]),
               "depolarizing": np.stack([_I2, _X, _Y, _Z])}


@functools.lru_cache(maxsize=None)
def _bits_on(wires: int, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """(w, d) wire bits of the basis states, on ``device``, made once: a
    copy from the host on every call would wait for the device."""
    return torch.as_tensor(bit_table(wires).T, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _pauli_mats_on(kind: str, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_PAULI_MATS[kind], dtype=dtype, device=device)


def _pauli_mixture(kind: str, strength, device=None,
                   dtype: torch.dtype = torch.complex128):
    """(probabilities (m,), unitaries (m, 2, 2) of ``dtype``) of a
    random-unitary kind. The probabilities are a float32 tensor on
    ``device``, computed from a float or a 0-d tensor strength with no host
    read."""
    if kind not in _PAULI_MATS:
        raise ValueError(f"{kind!r} has no random-unitary unraveling")
    g = torch.as_tensor(strength, dtype=torch.float32, device=device)
    if kind == "phase_damping":
        q = 0.5 * (1.0 - torch.sqrt(1.0 - g))
        p = torch.stack([1.0 - q, q])
    else:
        s = g / 3.0
        p = torch.stack([1.0 - g, s, s, s])
    return p, _pauli_mats_on(kind, dtype, g.device)


def wire_one_prob(states: torch.Tensor, wire: int) -> torch.Tensor:
    """P(wire = 1) per state: (N, 2**w) complex -> (N,) real."""
    wires = int(math.log2(states.shape[-1]))
    p = probs(states)
    return p @ _bits_on(wires, p.dtype, p.device)[wire]


def apply_channel_trajectory(states: torch.Tensor, kind: str, strength, rng):
    """One stochastic realization of the per-wire channel on all wires.

    states: (N, 2**w) complex; returns the same shape, norms kept. Branches
    are drawn independently per (state, wire) from ``rng``.
    """
    wires = int(math.log2(states.shape[-1]))
    n = states.shape[0]
    draws = _source(rng)
    if kind in _PAULI_MATS:
        p, mats = _pauli_mixture(kind, strength, states.device,
                                 states.dtype)
        idx = draws.branches(p, (wires, n), states.device)
        if kind == "phase_damping":
            # the drawn Z string of a state is one sign plane: the count of
            # Z's on the basis state's set bits, mod 2
            zcount = idx.T.to(torch.float32) @ _bits_on(
                wires, torch.float32, states.device)        # (N, d)
            sign = 1.0 - 2.0 * torch.remainder(zcount, 2.0)
            return states * sign.to(states.dtype)
        for j in range(wires):
            states = apply_1q(states, mats[idx[j]], j, wires)
        return states
    if kind == "amplitude_damping":
        u = draws.uniform((wires, n), states.device)
        forced = draws.forced_picks()
        if (states.dtype == torch.complex64
                and wires <= _config.SEL_KERNEL_MAX_WIRES):
            out, picks = amp_damp(states, u, strength, picks=forced)
        else:
            out, picks = _amp_damp_xla(states, u, strength, picks=forced)
        draws.took(picks)
        return out
    raise ValueError(f"no trajectory unraveling for channel {kind!r}")


def _amp_damp_xla(states, u, strength, picks=None):
    """The amplitude-damping pass in plain PyTorch, for the states kernel #7
    does not take: past its 12 wires, or in complex128 (counterpart of
    ``qiddm_tpu/sim/trajectories.py::_amp_damp_xla``, which the JAX package
    runs in XLA there). Wire by wire in order, ``p1 = g * P(wire = 1)`` of
    the state the earlier wires left; ``K1 / sqrt(p1)`` where ``u < p1``,
    else ``K0 / sqrt(1 - p1)``. Differentiable by autograd.

    ``P(wire = 1)`` is summed in float64, as #7 and its twin sum it (a
    float32 sum's order could flip a pick near ``u == p1``); the branch
    coefficients are in the states' real dtype. ``picks`` (w, N), when
    given, are followed instead of ``u < p1`` (a replay). Returns the new
    states and the picks taken, (w, N) uint8.
    """
    n, d = states.shape
    wires = int(math.log2(d))
    rdtype = states.real.dtype
    g = torch.as_tensor(strength, dtype=rdtype, device=states.device)
    sqg = torch.sqrt(torch.clamp(g, min=0.0))
    sq1g = torch.sqrt(torch.clamp(1.0 - g, min=0.0))
    taken = []
    for j in range(wires):
        v = states.reshape(n, 2**j, 2, d >> (j + 1))
        s0, s1 = v[:, :, 0], v[:, :, 1]
        p1d = g.double() * (s1.real.double() ** 2
                            + s1.imag.double() ** 2).sum(dim=(1, 2))
        pick = (picks[j].to(torch.bool) if picks is not None
                else u[j].double() < p1d)
        p1 = p1d.to(rdtype)
        # each branch's renormalization, the unused one's argument set to 1
        # so that no infinite derivative meets a zero cotangent in backward
        inv1 = torch.rsqrt(torch.where(pick, p1.clamp(min=1e-30), 1.0))
        inv0 = torch.rsqrt(torch.where(pick, 1.0,
                                       (1.0 - p1).clamp(min=1e-30)))
        n0 = torch.where(pick[:, None, None], (sqg * inv1)[:, None, None] * s1,
                         inv0[:, None, None] * s0)
        n1 = torch.where(pick, 0.0, sq1g * inv0)[:, None, None] * s1
        states = torch.stack([n0, n1], dim=2).reshape(n, d)
        taken.append(pick)
    ROUTE_CALLS["amp_xla"] += 1
    return states, torch.stack(taken).to(torch.uint8)


# --- circuits ----------------------------------------------------------------

def _tile_traj(x: torch.Tensor, n_traj: int) -> torch.Tensor:
    """Row ``t * B + b`` is sample b of trajectory t (``jnp.tile``)."""
    return x.repeat((n_traj,) + (1,) * (x.ndim - 1))


def _mean_over_traj(out: torch.Tensor, n_traj: int) -> torch.Tensor:
    return out.reshape((n_traj, -1) + tuple(out.shape[1:])).mean(dim=0)


def _sel_route(n: int, wires: int, cdtype) -> str:
    """How the SEL layers of ``n`` trajectory rows run. Complex64 up to the
    kernel's 12 wires: "composed" unitaries from ``2**wires`` rows (the
    engine's rule), else "rows", the SEL-chain kernel #5 on the rows. Past
    that, or in complex128, the JAX package's XLA routes: up to 10 wires
    "composed" from ``2**wires`` rows, else "layers", the per-layer
    unitaries (``_unitary_route``); above 10, "gates", ``sel_apply_gates``
    (``trajectories.py:277-299``)."""
    if cdtype == torch.complex64 and wires <= _config.SEL_KERNEL_MAX_WIRES:
        return "composed" if n >= 2**wires else "rows"
    if wires <= _config.KERNEL_MAX_WIRES:
        return "composed" if n >= 2**wires else "layers"
    return "gates"


def _sel_chain(states, w, imprimitive: str, cdtype):
    """SEL(depth) on the trajectory-expanded batch (ranges cycling over the
    full depth), by :func:`_sel_route`."""
    wires = w.shape[1]
    route = _sel_route(states.shape[0], wires, cdtype)
    if route == "rows":
        mats = rot_matrix(w[..., 0], w[..., 1], w[..., 2])
        return sel_chain_rows(states, mats, wires, imprimitive)
    w = w.to(cdtype.to_real())
    if route == "gates":
        return sel_apply_gates(states, w, imprimitive)
    if route == "layers":
        for u in sel_layer_unitaries(w, imprimitive):
            states = apply_unitary(states, u)
        return states
    return apply_unitary(states, sel_unitary(w, imprimitive))


def reupload_block_trajectories(x_enc, block_weights, *, rng, n_traj: int,
                                noise, encode: str = "rz",
                                imprimitive: str = "cz",
                                readout: str = "probs", cdtype=None):
    """Trajectory estimate of the density-matrix re-uploading block.

    Placement "encode" injects the channel after every re-upload (L x
    [encode -> channel -> SEL(k)]), "end" once after the block. x_enc must
    already carry any halfpi or rotation-angle transforms (the engine
    applies them before routing).

    x_enc: (batch, wires); block_weights: (L, k, wires, 3); rng: a
    generator or a :class:`TrajDraws`, one draw per application point in
    order (layers 0..L-1, then the end). Returns (batch, 2**w) probabilities
    or (batch, wires) Z-expectations, means over the trajectories.
    """
    draws = _source(rng)
    if cdtype is None:
        cdtype = _config.complex_dtype()
    L, k, wires, _ = block_weights.shape
    rdtype = cdtype.to_real()
    n = n_traj * x_enc.shape[0]
    xT = _tile_traj(x_enc.to(rdtype), n_traj)
    states = zero_state(n, wires, dtype=cdtype, device=x_enc.device)
    phases = rz_phases(xT, wires) if encode in ("rz", "rz_halfpi") else None
    route = _sel_route(n, wires, cdtype)
    if route == "rows":
        def apply_sel(s, l):
            # one kernel call per spectrum layer: its ring ranges restart,
            # as sel_unitaries' do per block
            w_l = block_weights[l]
            mats = rot_matrix(w_l[..., 0], w_l[..., 1], w_l[..., 2])
            return sel_chain_rows(s, mats, wires, imprimitive)
    elif route == "gates":
        wr = block_weights.to(rdtype)

        def apply_sel(s, l):
            # the ranges restart each spectrum layer here too
            return sel_apply_gates(s, wr[l], imprimitive)
    else:
        us = (sel_unitaries if route == "composed" else sel_layer_unitaries)(
            block_weights.to(rdtype), imprimitive).to(cdtype)

        def apply_sel(s, l):
            if route == "composed":
                return apply_unitary(s, us[l])
            for u in us[l]:
                s = apply_unitary(s, u)
            return s

    for l in range(L):
        states = (states * phases if phases is not None
                  else apply_ry_all(states, xT))
        if noise.placement == "encode":
            states = apply_channel_trajectory(states, noise.kind,
                                              noise.strength, draws)
        states = apply_sel(states, l)
    if noise.placement == "end":
        states = apply_channel_trajectory(states, noise.kind, noise.strength,
                                          draws)
    out = probs(states) if readout == "probs" else expval_z(states)
    return _mean_over_traj(out, n_traj)


def qdense_circuit_trajectories(x, weights, *, rng, n_traj: int, noise,
                                wires: int, pad_with: float = 0.1,
                                weight_map: str = "qw_tanh",
                                imprimitive: str = "cnot", cdtype=None):
    """Trajectory estimate of the Qdense density-matrix path: amplitude
    embedding -> SEL -> the channel at the end -> mean probabilities."""
    draws = _source(rng)
    if cdtype is None:
        cdtype = _config.complex_dtype()
    w = WEIGHT_MAPS[weight_map](weights)
    states = amplitude_embed(_tile_traj(x.to(cdtype.to_real()), n_traj),
                             wires, pad_with, dtype=cdtype)
    states = _sel_chain(states, w, imprimitive, cdtype)
    states = apply_channel_trajectory(states, noise.kind, noise.strength,
                                      draws)
    return _mean_over_traj(probs(states), n_traj)


def qnn_circuit_trajectories(x, weights, *, rng, n_traj: int, noise,
                             encode: str = "rz", imprimitive: str = "cz",
                             weight_map: str = "none",
                             readout: str = "expvalz", cdtype=None):
    """Trajectory estimate of the QNN density-matrix path: one encode ->
    (channel at placement "encode") -> SEL -> (channel at "end") -> mean
    readout. x must already carry the encode transforms."""
    draws = _source(rng)
    if cdtype is None:
        cdtype = _config.complex_dtype()
    wires = x.shape[-1]
    rdtype = cdtype.to_real()
    w = WEIGHT_MAPS[weight_map](weights)
    xT = _tile_traj(x.to(rdtype), n_traj)
    if encode == "ry":
        states = ry_product_state(xT, wires, dtype=cdtype)
    else:
        states = zero_state(xT.shape[0], wires, dtype=cdtype,
                            device=x.device) * rz_phases(xT, wires)
    if noise.placement == "encode":
        states = apply_channel_trajectory(states, noise.kind, noise.strength,
                                          draws)
    states = _sel_chain(states, w, imprimitive, cdtype)
    if noise.placement == "end":
        states = apply_channel_trajectory(states, noise.kind, noise.strength,
                                          draws)
    out = probs(states) if readout == "probs" else expval_z(states)
    return _mean_over_traj(out, n_traj)
