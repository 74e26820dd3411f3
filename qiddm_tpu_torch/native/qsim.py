"""ctypes bindings and the on-demand build of the native qsim engine
(counterpart of the JAX package's ``native/qsim.py``).

The engine runs on the host, in float64: it is the port's one entry point
that does not run on the card, as the JAX package's engine and the
reference's lightning.qubit run on the host. It is built with g++ at first
use from this package's own ``qsim.cpp`` into the git-ignored
``build/qiddm_tpu_torch/`` (the library's name carries a digest of the
source and the flags), through a per-process temporary name and an atomic
``os.replace``, so processes that build at once never load half a file.
A failed build makes :func:`available` false and every run raise
``RuntimeError`` with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_SRC = pathlib.Path(__file__).with_name("qsim.cpp")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "qiddm_tpu_torch"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None
_BUILD_ERROR: Optional[str] = None

# op kinds: keep in sync with qsim.cpp
RX, RY, RZ, ROT, CZ, CNOT, PHASESHIFT = range(7)
CH_PHASE_DAMP, CH_AMP_DAMP, CH_DEPOL = 7, 8, 9

_CHANNEL_KINDS = {
    "phase_shift": PHASESHIFT,
    "phase_damping": CH_PHASE_DAMP,
    "amplitude_damping": CH_AMP_DAMP,
    "depolarizing": CH_DEPOL,
}


class Op(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("wire", ctypes.c_int32),
        ("wire2", ctypes.c_int32),
        ("p0", ctypes.c_double),
        ("p1", ctypes.c_double),
        ("p2", ctypes.c_double),
    ]


def library_path() -> pathlib.Path:
    """Where the engine for this source and these flags is built."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + b"\0"
                            + _SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libqsim_{digest}.so"


def _build(lib: pathlib.Path) -> Optional[str]:
    """Compile ``qsim.cpp`` into ``lib``; returns the error, or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:  # no compiler
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.stderr[-2000:]
    os.replace(tmp, lib)
    return None


def _load():
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is not None or _BUILD_ERROR is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _BUILD_ERROR = _build(path)
            if _BUILD_ERROR is not None:
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _BUILD_ERROR = f"loading {path} failed: {e}"
            return None
        pd = ctypes.POINTER(ctypes.c_double)
        lib.qsim_statevector_run.restype = ctypes.c_int
        lib.qsim_statevector_run.argtypes = [
            ctypes.c_int, ctypes.POINTER(Op), ctypes.c_int, pd, pd, pd, pd]
        lib.qsim_density_run.restype = ctypes.c_int
        lib.qsim_density_run.argtypes = [
            ctypes.c_int, ctypes.POINTER(Op), ctypes.c_int, pd, pd, pd]
        lib.qsim_sample_counts.restype = ctypes.c_int
        lib.qsim_sample_counts.argtypes = [
            pd, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.qsim_adjoint_grad.restype = ctypes.c_int
        lib.qsim_adjoint_grad.argtypes = [
            ctypes.c_int, ctypes.POINTER(Op), ctypes.c_int, pd, pd, pd]
        lib.qsim_n_params.restype = ctypes.c_int
        lib.qsim_n_params.argtypes = [ctypes.POINTER(Op), ctypes.c_int]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _BUILD_ERROR


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native qsim unavailable: {_BUILD_ERROR}")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ops_array(ops: Sequence[tuple]):
    arr = (Op * len(ops))()
    for i, o in enumerate(ops):
        kind, wire, wire2, p0, p1, p2 = (list(o) + [0, 0, 0.0, 0.0, 0.0])[:6]
        arr[i] = Op(int(kind), int(wire), int(wire2), float(p0), float(p1),
                    float(p2))
    return arr


def _init_amps(init_amps):
    """Interleaved (re, im) float64 amplitudes, or None for |0...0>."""
    if init_amps is None:
        return None
    return np.ascontiguousarray(
        np.stack([np.real(init_amps), np.imag(init_amps)], -1).ravel(),
        dtype=np.float64)


def statevector_run(wires: int, ops: Sequence[tuple],
                    init_amps: Optional[np.ndarray] = None,
                    want_state: bool = False):
    """Run a gate stream; returns (probs, expvals[, state])."""
    lib = _lib()
    dim = 1 << wires
    init = _init_amps(init_amps)
    probs = np.zeros(dim, np.float64)
    ev = np.zeros(wires, np.float64)
    state = np.zeros(2 * dim, np.float64) if want_state else None
    rc = lib.qsim_statevector_run(
        wires, _ops_array(ops), len(ops),
        None if init is None else _ptr(init),
        _ptr(state) if want_state else None, _ptr(probs), _ptr(ev))
    if rc != 0:
        raise ValueError("channel ops require density_run")
    if want_state:
        return probs, ev, state[0::2] + 1j * state[1::2]
    return probs, ev


def density_run(wires: int, ops: Sequence[tuple],
                init_amps: Optional[np.ndarray] = None):
    """Run a stream with channels on a density matrix; returns
    (probs, expvals)."""
    lib = _lib()
    dim = 1 << wires
    init = _init_amps(init_amps)
    probs = np.zeros(dim, np.float64)
    ev = np.zeros(wires, np.float64)
    lib.qsim_density_run(wires, _ops_array(ops), len(ops),
                         None if init is None else _ptr(init), _ptr(probs),
                         _ptr(ev))
    return probs, ev


def adjoint_grad(wires: int, ops: Sequence[tuple],
                 init_amps: Optional[np.ndarray] = None):
    """Adjoint-method Jacobian, the lightning.qubit differentiator.

    Returns ``(expvals, jac)``: ``expvals`` (wires,) are the final-state
    <Z_w>; ``jac`` (wires, n_params) holds d<Z_w>/dtheta for every
    parametrized gate in stream order (RX/RY/RZ/PhaseShift contribute one
    column, Rot three). Channel ops raise ``ValueError``: the adjoint
    method needs a unitary stream."""
    lib = _lib()
    arr = _ops_array(ops)
    n_params = lib.qsim_n_params(arr, len(ops))
    init = _init_amps(init_amps)
    ev = np.zeros(wires, np.float64)
    jac = np.zeros((wires, n_params), np.float64)
    rc = lib.qsim_adjoint_grad(wires, arr, len(ops),
                               None if init is None else _ptr(init),
                               _ptr(ev), _ptr(jac))
    if rc != 0:
        raise ValueError("adjoint differentiation requires a unitary "
                         "stream (no channel ops)")
    return ev, jac


def sample_counts(probs: np.ndarray, shots: int, seed: int = 0) -> np.ndarray:
    """Multinomial shot sampling (the aer backend's analogue): ``shots``
    draws of a C++ ``mt19937_64`` seeded ``seed``, so a seed gives the JAX
    package's counts."""
    lib = _lib()
    probs = np.ascontiguousarray(probs, np.float64)
    counts = np.zeros(len(probs), np.int64)
    lib.qsim_sample_counts(
        _ptr(probs), len(probs), int(shots), int(seed),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return counts


# --- circuit builders (the structure of qiddm_tpu_torch.sim's circuits) -----

def build_sel_ops(weights: np.ndarray, imprimitive: str = "cnot",
                  ranges: Optional[List[int]] = None) -> List[tuple]:
    """StronglyEntanglingLayers as a gate stream.

    weights: (layers, wires, 3); ranges default to the cycling pattern."""
    from ..sim.sel import sel_ranges

    layers, wires, _ = weights.shape
    if ranges is None:
        ranges = sel_ranges(layers, wires)
    imp = CNOT if imprimitive == "cnot" else CZ
    ops: List[tuple] = []
    for l in range(layers):
        for j in range(wires):
            ops.append((ROT, j, 0, weights[l, j, 0], weights[l, j, 1],
                        weights[l, j, 2]))
        if wires > 1:
            for j in range(wires):
                ops.append((imp, j, (j + ranges[l]) % wires))
    return ops


def build_reupload_ops(x: np.ndarray, weights: np.ndarray,
                       encode: str = "rz", imprimitive: str = "cz",
                       noise_kind: Optional[str] = None,
                       noise_strength: float = 0.0,
                       noise_placement: str = "encode") -> List[tuple]:
    """One re-uploading block as a gate stream.

    x: (wires,) angles; weights: (L, k, wires, 3)."""
    L, k, wires, _ = weights.shape
    enc = {"rz": RZ, "ry": RY, "rz_halfpi": RZ}[encode]
    scale = 0.5 * np.pi if encode == "rz_halfpi" else 1.0
    ops: List[tuple] = []
    for i in range(L):
        for j in range(wires):
            ops.append((enc, j, 0, scale * float(x[j])))
            if noise_kind and noise_placement == "encode":
                ops.append((_CHANNEL_KINDS[noise_kind], j, 0, noise_strength))
        ops.extend(build_sel_ops(weights[i], imprimitive))
    if noise_kind and noise_placement == "end":
        for j in range(wires):
            ops.append((_CHANNEL_KINDS[noise_kind], j, 0, noise_strength))
    return ops
