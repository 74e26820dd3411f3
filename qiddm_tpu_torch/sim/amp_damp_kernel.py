"""One amplitude-damping trajectory pass: a hand-written CUDA kernel and its
plain PyTorch twin (counterpart of ``qiddm_tpu/sim/pallas_gate_kernel.py``:
``amp_damp_call_planes``, ``_amp_damp_kernel``, and of
``qiddm_tpu/sim/trajectories.py``: ``_amp_damp_fused``, ``_amp_damp_xla``).

The Monte-Carlo unraveling of amplitude damping on every wire of a batch of
statevectors, wire by wire in order: the branch ``K1 = sqrt(g)|0><1|`` fires
with probability ``p1 = g * P(wire = 1)`` of the state left by the earlier
wires, decided by a presampled uniform ``u[j, n] < p1``, else ``K0 =
diag(1, sqrt(1-g))``; the chosen branch is divided by ``sqrt(p_branch)`` so
the state stays normalized.

``amp_damp`` is the entry the trajectory backend calls. It runs the
``_AmpDamp`` autograd Function, which picks the path by the device of its
input: a CPU tensor runs the plain twin (:func:`amp_damp_plain`); a CUDA
tensor launches the kernel of ``csrc/amp_damp.cu`` or raises. Nothing falls
back from the kernel to its plain twin. The kernel is built into the one
library of ``gate_kernel.py``.

Both return the branch picks, (w, N) uint8, beside the states. The branch
choice is data-dependent (the branch-pick hazard): a backward that re-derived
the picks from recomputed probabilities could follow another realization
than the forward took at a near tie. So the twin takes ``picks=`` to follow
given picks instead of drawing its own, and the Function's backward re-runs
the twin under autograd on the saved input with the same uniforms and the
forward's picks forced. That replay is the design, not a fallback: the JAX
package has no backward kernel for this pass either, and differentiates its
fused kernel by replaying the XLA twin (``_amp_damp_fused_bwd``). Sampling,
the hot path, never differentiates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from .. import config as _config
from . import gate_kernel as _gk

# Kernel launches since the last reset; chip_smoke.py reads it to show that
# the trajectory sampling paths went through the kernel.
AMP_DAMP_LAUNCHES = 0

# Widest state the kernel takes: the trajectory route's width, whose SEL
# chain is served by sel_kernel up to the same width. One state sits in
# registers: 32 KB at 12 wires, 16 amplitudes a thread.
MAX_WIRES = _config.SEL_KERNEL_MAX_WIRES

# The kernel's layout (csrc/amp_damp.cu's AmpShape): up to 9 wires a warp
# holds a state (below 5 wires, d lanes of one), 4 warps a block; from 9
# wires a thread holds 16 amplitudes, and from 10 a block holds a state.
WARP_BLOCK = 128
MAX_AMPS = 16


class AmpPlan(NamedTuple):
    """How the kernel lays out one pass: ``amps`` amplitudes a thread,
    ``threads_per_state`` threads (``warps_per_state`` warps, or part of
    one) a state, ``per_block`` states a block of ``threads`` threads,
    ``blocks`` blocks."""
    amps: int
    threads_per_state: int
    warps_per_state: int
    per_block: int
    threads: int
    blocks: int


def amp_damp_plan(wires: int, n: int) -> AmpPlan:
    """The kernel's layout for ``n`` states of ``wires`` wires, as
    ``AmpShape`` computes it: each wire's P(wire = 1) is a sum over a
    state's threads, by warp shuffles up to 9 wires (a warp or part of one
    a state) and with one barrier a wire from 10 (a block a state)."""
    d = 2**wires
    amps = 1 if wires < 5 else min(d // 32, MAX_AMPS)
    per_state = d // amps
    per_block = 1 if per_state > 32 else WARP_BLOCK // per_state
    return AmpPlan(amps, per_state, max(1, per_state // 32), per_block,
                   per_block * per_state, -(-n // per_block))


def _wires_of(states) -> int:
    d = states.shape[-1]
    wires = int(math.log2(d))
    if d != 2**wires or wires < 1:
        raise ValueError(f"states of {d} amplitudes do not hold whole wires")
    return wires


# --- plain PyTorch twin ------------------------------------------------------

def amp_damp_plain(states, u, strength, picks=None):
    """The pass in plain PyTorch, on any device, differentiable in
    ``states`` and a tensor ``strength``.

    states: (N, 2**w) complex; u: (w, N) uniforms; strength: a float or a
    0-d tensor; picks: None, or (w, N) branch picks to follow instead of
    ``u < p1``. Returns the new states and the picks, (w, N) uint8.

    ``P(wire = 1)`` is summed in float64, as the kernel sums it: the squares
    of float32 values are exact there, so the pick ``u < p1`` does not hang
    on the order of a float32 sum. The branch coefficients are float32.
    """
    n, d = states.shape
    wires = _wires_of(states)
    g = torch.as_tensor(strength, dtype=torch.float32, device=states.device)
    sqg = torch.sqrt(torch.clamp(g, min=0.0))
    sq1g = torch.sqrt(torch.clamp(1.0 - g, min=0.0))
    taken = []
    for j in range(wires):
        v = states.reshape(n, 2**j, 2, d >> (j + 1))
        s0, s1 = v[:, :, 0], v[:, :, 1]
        prob1 = (s1.real.double() ** 2 + s1.imag.double() ** 2).sum(dim=(1, 2))
        p1d = g.double() * prob1
        pick = (picks[j].to(torch.bool) if picks is not None
                else u[j].double() < p1d)
        p1 = p1d.float()
        # each branch's renormalization, the unused one's argument set to 1
        # so that no infinite derivative meets a zero cotangent in backward
        c1 = sqg * torch.rsqrt(torch.where(pick, p1.clamp(min=1e-30), 1.0))
        c0 = torch.rsqrt(torch.where(pick, 1.0,
                                     (1.0 - p1).clamp(min=1e-30)))
        keep = torch.where(pick, 0.0, c0 * sq1g)
        n0 = torch.where(pick[:, None, None], c1[:, None, None] * s1,
                         c0[:, None, None] * s0)
        n1 = keep[:, None, None] * s1
        states = torch.stack([n0, n1], dim=2).reshape(n, d)
        taken.append(pick)
    return states, torch.stack(taken).to(torch.uint8)


# --- CUDA kernel -------------------------------------------------------------

def _amp_damp_cuda(states, u, strength, forced):
    """Launch the kernel on PyTorch's current stream under
    :func:`amp_damp_plan`; returns new (N, d) complex64 states and (w, N)
    uint8 picks."""
    global AMP_DAMP_LAUNCHES
    what = "amplitude-damping kernel"
    dev = states.device
    wires = _wires_of(states)
    n = states.shape[0]
    tensors = [states, u] + ([strength] if torch.is_tensor(strength) else [])
    tensors += [] if forced is None else [forced]
    if any(t.device != dev or dev.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: every input must be on the same CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if (states.dtype != torch.complex64 or u.dtype != torch.float32
            or (torch.is_tensor(strength) and strength.dtype != torch.float32)
            or (forced is not None and forced.dtype != torch.uint8)
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError(f"{what}: needs contiguous complex64 states, float32 "
                         f"uniforms and strength and uint8 picks, got "
                         f"{[(t.dtype, t.is_contiguous()) for t in tensors]}")
    if not 1 <= wires <= MAX_WIRES:
        raise ValueError(f"{what} takes 1..{MAX_WIRES} wires, got {wires}")
    if (states.ndim != 2 or n < 1 or tuple(u.shape) != (wires, n)
            or (forced is not None and tuple(forced.shape) != (wires, n))
            or (torch.is_tensor(strength) and strength.numel() != 1)):
        raise ValueError(f"{what}: bad shapes: states {tuple(states.shape)}, "
                         f"u {tuple(u.shape)} for {wires} wires")
    plan = amp_damp_plan(wires, n)
    lib = _gk._library()
    out = torch.empty_like(states)
    picks = torch.empty((wires, n), dtype=torch.uint8, device=dev)
    ptr = strength.data_ptr() if torch.is_tensor(strength) else None
    value = 0.0 if torch.is_tensor(strength) else float(strength)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.amp_damp_fwd(states.data_ptr(), u.data_ptr(), ptr, value,
                           None if forced is None else forced.data_ptr(),
                           out.data_ptr(), picks.data_ptr(), wires, n,
                           plan.threads, plan.per_block, dev.index, stream)
    _gk._raise_on(err, lib, what)
    AMP_DAMP_LAUNCHES += 1
    return out, picks


class _AmpDamp(torch.autograd.Function):
    """``(states, u, strength, forced) -> (states', picks)``. Saves the
    input, the uniforms and the picks; the backward replays the plain twin
    with the picks forced (see the module docstring)."""

    @staticmethod
    def forward(ctx, states, u, strength, forced):
        if states.device.type == "cuda":
            if torch.is_tensor(strength):
                strength = strength.to(torch.float32).reshape(()).contiguous()
            out, picks = _amp_damp_cuda(states, u, strength, forced)
        else:
            out, picks = amp_damp_plain(states, u, strength, forced)
        is_tensor = torch.is_tensor(strength)
        ctx.save_for_backward(states, u, picks,
                              *([strength] if is_tensor else []))
        ctx.strength = None if is_tensor else strength
        ctx.mark_non_differentiable(picks)
        return out, picks

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out, _grad_picks):
        states, u, picks, *rest = ctx.saved_tensors
        strength = rest[0] if rest else ctx.strength
        want_s, _, want_g, _ = ctx.needs_input_grad
        want_g = want_g and bool(rest)
        with torch.enable_grad():
            s = states.detach().requires_grad_(want_s)
            g = strength.detach().requires_grad_(want_g) if rest else strength
            out, _ = amp_damp_plain(s, u, g, picks=picks)
            leaves = [t for t, want in ((s, want_s), (g, want_g)) if want]
            grads = iter(torch.autograd.grad(out, leaves, grad_out)
                         if leaves else ())
        ds = next(grads) if want_s else None
        dg = next(grads) if want_g else None
        return ds, None, dg, None


def amp_damp(states, u, strength, picks=None):
    """One amplitude-damping trajectory pass over every wire.

    states: (N, 2**w) complex64 rows, N = n_traj x batch; u: (w, N) float32
    presampled uniforms; strength: a float, or a 0-d float32 tensor on the
    states' device (read on the device: no host sync); picks: None, or
    (w, N) uint8 branch picks to follow (a replay). Returns the new states
    and the picks taken, (w, N) uint8.

    Differentiable in ``states`` and a tensor ``strength``: the backward
    replays the plain twin with the forward's picks, on either device.
    """
    if states.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no amplitude-damping path for device "
                         f"{states.device}")
    return _AmpDamp.apply(states.contiguous(), u.contiguous(), strength,
                          None if picks is None else picks.contiguous())
