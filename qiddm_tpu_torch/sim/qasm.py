"""QASM bridge (counterpart of the JAX package's ``sim/qasm.py``): emit
OPENQASM 2.0 for the framework's circuits, run it, and sample from it.

Reference: nn/utils.py:77-129 — ``circuit_to_qasm`` builds an
AngleEmbedding + StronglyEntanglingLayers circuit on a qiskit-aer device and
dumps its QASM; ``repeat_qasm`` splices the body N times (optionally
resetting an ancilla); ``sample_from_qiskit`` executes on Aer and returns a
count vector indexed by basis state.

The QASM is pure text (no qiskit), character for character the JAX
package's: each angle is ``repr`` of the same float. :func:`run_qasm` runs
the parsed gate stream on a torch statevector in complex128, on the card
unless the caller passes a CPU device; :func:`sample_from_qasm` draws its
shots with the native engine on the host (``native.sample_counts``, a C++
``mt19937_64``), so a seed gives the JAX package's counts. Counts use the
qiskit bit convention the reference relies on (creg bit j = qubit j, so a
basis index has qubit n-1 as its most significant bit, the reverse of the
simulator's wire-0-MSB layout).
"""

from __future__ import annotations

import math
import re
from typing import List, Optional

import numpy as np
import torch

from ..config import resolve_device
from .sel import sel_ranges
from .statevector import apply_1q


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def circuit_to_qasm(weights, wires: int, inp) -> str:
    """AngleEmbedding(X) -> SEL(weights) -> measure, as OPENQASM 2.0.

    weights: (layers, wires, 3); inp: (wires,) angles (the reference embeds
    with the default X rotation, nn/utils.py:83). Tensors or arrays.
    """
    weights = _numpy(weights)
    inp = _numpy(inp).reshape(-1)
    layers = weights.shape[0]
    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        f"qreg q[{wires}];",
        f"creg c[{wires}];",
    ]
    for j in range(wires):
        lines.append(f"rx({float(inp[j])!r}) q[{j}];")
    ranges = sel_ranges(layers, wires)
    for l in range(layers):
        for j in range(wires):
            phi, theta, omega = (float(v) for v in weights[l, j])
            # Rot(phi, theta, omega) = RZ(omega) RY(theta) RZ(phi)
            lines.append(f"rz({phi!r}) q[{j}];")
            lines.append(f"ry({theta!r}) q[{j}];")
            lines.append(f"rz({omega!r}) q[{j}];")
        if wires > 1:
            for j in range(wires):
                lines.append(f"cx q[{j}],q[{(j + ranges[l]) % wires}];")
    # barrier before measurement (as qiskit emits): repeat_qasm's slice
    # arithmetic (body = lines[4:-wires-1]) counts on exactly one line
    # between the last gate and the measures
    lines.append("barrier q;")
    for j in range(wires):
        lines.append(f"measure q[{j}] -> c[{j}];")
    return "\n".join(lines)


def repeat_qasm(qasm: str, wires: int, ancilla: bool, reps: int) -> str:
    """Splice the circuit body ``reps`` times (reference nn/utils.py:93-111):
    keep the 4 header lines and the trailing measurement lines, optionally
    reset the last wire before each repetition."""
    qasm_ = qasm.split("\n")
    while qasm_ and not qasm_[-1].strip():
        qasm_.pop()  # robust to trailing blank lines
    header = "\n".join(qasm_[0:4])
    measurements = "\n".join(qasm_[-wires:])
    body = qasm_[4: -wires - 1]
    if ancilla:
        body = [f"reset q[{wires - 1}];"] + ["barrier q;"] + body
    body = body + ["barrier q;"]
    repeated: List[str] = []
    for _ in range(reps):
        repeated += body
    return "\n".join([header, "\n".join(repeated), measurements])


_GATE_RE = re.compile(
    r"^(rx|ry|rz)\(([-+0-9.eE]+)\)\s+q\[(\d+)\];$")
_CX_RE = re.compile(r"^(cx|cz)\s+q\[(\d+)\],q\[(\d+)\];$")
_RESET_RE = re.compile(r"^reset\s+q\[(\d+)\];$")
_QREG_RE = re.compile(r"^qreg\s+q\[(\d+)\];$")


def parse_qasm(qasm_str: str):
    """``(wires, ops)`` of the emitted-QASM subset: ops are ``("rx"|"ry"|
    "rz", wire, angle)``, ``("cx"|"cz", control, target)`` and
    ``("reset", wire)``; barriers, measures, headers and comments are
    skipped. Raises ``ValueError`` on any other line or without a qreg."""
    wires = None
    ops = []
    for raw in qasm_str.split("\n"):
        line = raw.strip()
        if not line or line.startswith(("OPENQASM", "include", "creg",
                                       "barrier", "measure", "//")):
            continue
        m = _QREG_RE.match(line)
        if m:
            wires = int(m.group(1))
            continue
        m = _GATE_RE.match(line)
        if m:
            ops.append((m.group(1), int(m.group(3)), float(m.group(2))))
            continue
        m = _CX_RE.match(line)
        if m:
            ops.append((m.group(1), int(m.group(2)), int(m.group(3))))
            continue
        m = _RESET_RE.match(line)
        if m:
            ops.append(("reset", int(m.group(1))))
            continue
        raise ValueError(f"unsupported QASM line: {line!r}")
    if wires is None:
        raise ValueError("no qreg declaration found")
    return wires, ops


def _gate_matrix(kind: str, t: float) -> np.ndarray:
    c, s = math.cos(t / 2), math.sin(t / 2)
    if kind == "rx":
        return np.array([[c, -1j * s], [-1j * s, c]], np.complex128)
    if kind == "ry":
        return np.array([[c, -s], [s, c]], np.complex128)
    return np.array([[complex(c, -s), 0], [0, complex(c, s)]],
                    np.complex128)


def _project_zero(state: torch.Tensor, wires: int,
                  wire: int) -> torch.Tensor:
    """Deterministic reset of ``wire`` on a (2**wires,) state: collapse to
    the |0> branch when it has weight, otherwise the wire was (almost)
    surely |1> — measurement yields 1 and the reset flips it, i.e. the
    |1>-branch amplitudes move to the |0> slots. One host read of the
    branch's weight."""
    bit = 1 << (wires - 1 - wire)
    idx = torch.arange(2**wires, device=state.device)
    is1 = (idx & bit) != 0
    s0 = torch.where(is1, torch.zeros_like(state), state)
    p0 = float(torch.sum(torch.abs(s0) ** 2))
    if p0 > 1e-12:
        return s0 / math.sqrt(p0)
    moved = torch.where(is1, torch.zeros_like(state), state[idx | bit])
    n = float(torch.linalg.vector_norm(moved))
    return moved / max(n, 1e-300)


def _project_zero_host(state: np.ndarray, wires: int,
                       wire: int) -> np.ndarray:
    """:func:`_project_zero` in numpy, the JAX package's own form: the host
    reference's reset, written apart from the one the card's run takes."""
    bit = 1 << (wires - 1 - wire)
    idx = np.arange(2**wires)
    is1 = (idx & bit).astype(bool)
    s0 = np.where(is1, 0.0, state)
    p0 = float(np.sum(np.abs(s0) ** 2))
    if p0 > 1e-12:
        return s0 / np.sqrt(p0)
    moved = np.zeros_like(state)
    zero_slots = idx[~is1]
    moved[zero_slots] = state[zero_slots | bit]
    n = np.linalg.norm(moved)
    return moved / max(n, 1e-300)


def run_qasm(qasm_str: str, device="cuda") -> torch.Tensor:
    """The probability vector of an emitted-QASM-subset circuit run from
    |0...0> as a complex128 statevector on ``device`` (the card by
    default): (2**wires,) float64 in the simulator's wire-0-MSB order.
    Supported: rx/ry/rz, cx and cz on any wire pair, reset (projective,
    renormalized), barrier, measure (ignored)."""
    device = resolve_device(device)
    wires, ops = parse_qasm(qasm_str)
    dim = 2**wires
    idx = np.arange(dim)
    state = torch.zeros((1, dim), dtype=torch.complex128, device=device)
    state[0, 0] = 1.0
    for op in ops:
        kind = op[0]
        if kind in ("rx", "ry", "rz"):
            gate = torch.as_tensor(_gate_matrix(kind, op[2]), device=device)
            state = apply_1q(state, gate, op[1], wires)
        elif kind == "cx":
            cbit, tbit = (1 << (wires - 1 - op[1]),
                          1 << (wires - 1 - op[2]))
            src = np.where(idx & cbit, idx ^ tbit, idx)
            state = state[:, torch.as_tensor(src, device=device)]
        elif kind == "cz":
            both = ((idx >> (wires - 1 - op[1])) & 1) & (
                (idx >> (wires - 1 - op[2])) & 1)
            sign = torch.as_tensor(1.0 - 2.0 * both, dtype=torch.float64,
                                   device=device)
            state = state * sign
        else:
            state = _project_zero(state[0], wires, op[1])[None]
    return state[0].real ** 2 + state[0].imag ** 2


def run_qasm_native(qasm_str: str) -> np.ndarray:
    """:func:`run_qasm` on the native engine on the host, as the JAX
    package's ``run_qasm`` runs it: the gates between resets as one
    float64 stream each, every reset a projection of the numpy state
    (:func:`_project_zero_host`). The probability vector (2**wires,)
    float64, the reference the card's run is held to: its gates and resets
    are computed apart from :func:`run_qasm`'s, its parse is the same."""
    from .. import native

    kinds = {"rx": native.qsim.RX, "ry": native.qsim.RY,
             "rz": native.qsim.RZ, "cx": native.qsim.CNOT,
             "cz": native.qsim.CZ}
    wires, ops = parse_qasm(qasm_str)
    state = np.zeros(2**wires, complex)
    state[0] = 1.0
    pending = []
    for op in ops + [("reset", None)]:
        if op[0] != "reset":
            kind = kinds[op[0]]
            pending.append((kind, op[1], 0, op[2])
                           if op[0] in ("rx", "ry", "rz")
                           else (kind, op[1], op[2]))
            continue
        if pending:
            _, _, state = native.statevector_run(
                wires, pending, init_amps=state, want_state=True)
            pending = []
        if op[1] is not None:
            state = _project_zero_host(state, wires, op[1])
    return np.abs(state) ** 2


def qiskit_order(probs: np.ndarray) -> np.ndarray:
    """Reorder a wire-0-MSB probability vector into the qiskit creg
    convention (qubit 0 the least significant bit)."""
    wires = int(math.log2(len(probs)))
    perm = np.zeros(len(probs), np.int64)
    for i in range(len(probs)):
        rev = 0
        for b in range(wires):
            if i & (1 << b):
                rev |= 1 << (wires - 1 - b)
        perm[rev] = i
    return probs[perm]


def sample_from_qasm(qasm_str: str, shots: Optional[int] = None,
                     seed: int = 0, device="cuda") -> np.ndarray:
    """Counts vector indexed like the reference's ``sample_from_qiskit``
    (nn/utils.py:114-129): index i's bits follow the qiskit creg convention
    (qubit 0 = least significant bit). ``shots=None`` returns the exact
    probabilities (statevector backend analogue). The circuit runs on
    ``device``; the shots are drawn on the host by the native engine."""
    probs_q = qiskit_order(run_qasm(qasm_str, device).cpu().numpy())
    if shots is None:
        return probs_q
    from .. import native

    return native.sample_counts(probs_q, shots, seed).astype(np.float32)
