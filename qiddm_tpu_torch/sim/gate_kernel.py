"""The re-uploading gate chain: hand-written CUDA kernel and its plain
PyTorch version (counterpart of ``qiddm_tpu/sim/pallas_gate_kernel.py``,
forward only).

``gate_chain_planes`` is the entry the engine calls. It picks the path by
the device of its input: a CPU tensor runs :func:`gate_chain_planes_plain`;
a CUDA tensor launches ``csrc/gate_chain.cu`` or raises. Nothing falls back
from the kernel to the plain version.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
source in this checkout, into ``build/qiddm_tpu_torch/`` next to the
package; the library's file name carries a hash of the source and the
flags, so an edit rebuilds it. It has a plain C interface and is bound with
``ctypes``.

There is no backward kernel yet (ROADMAP Queue 2 kernel #2), so the entry
raises when autograd would need one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import torch

from .. import config as _config
from .sel import cz_ring_signs, sel_ranges

# Kernel launches since the last reset; chip_smoke.py reads it to show that
# the sampling path went through the kernel.
LAUNCHES = 0

_SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "gate_chain.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "qiddm_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Opt-in shared memory per block on Hopper (H100/H200).
_MAX_SMEM_BYTES = 232448

_LIB = None


def _to_g8(rot_mats: torch.Tensor) -> torch.Tensor:
    """Pack complex (..., 2, 2) gate matrices as (..., 8) float32
    ``(g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i)``."""
    m = rot_mats
    return torch.stack([
        m[..., 0, 0].real, m[..., 0, 0].imag,
        m[..., 0, 1].real, m[..., 0, 1].imag,
        m[..., 1, 0].real, m[..., 1, 0].imag,
        m[..., 1, 1].real, m[..., 1, 1].imag,
    ], dim=-1).to(torch.float32).contiguous()


def _sign_planes(k: int, wires: int) -> np.ndarray:
    """The k CZ-ring sign planes (ranges cycle per block of k), (k, d, 1)."""
    ranges = sel_ranges(k, wires)
    return np.stack([cz_ring_signs(wires, ranges[li])[:, None]
                     for li in range(k)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _sign_planes_on(k: int, wires: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_sign_planes(k, wires), device=device)


# --- plain PyTorch version ---------------------------------------------------

def _gate_apply(sr, si, g, j: int):
    """One 2x2 gate on wire j of (d, B) planes: reshape to
    (2^j, 2, d / 2^(j+1), B) and mix the two halves."""
    g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i = g.unbind()
    d, B = sr.shape
    left = 2**j
    vr = sr.reshape(left, 2, d // (2 * left), B)
    vi = si.reshape(left, 2, d // (2 * left), B)
    s0r, s1r = vr[:, 0], vr[:, 1]
    s0i, s1i = vi[:, 0], vi[:, 1]
    n0r = g00r * s0r - g00i * s0i + g01r * s1r - g01i * s1i
    n0i = g00r * s0i + g00i * s0r + g01r * s1i + g01i * s1r
    n1r = g10r * s0r - g10i * s0i + g11r * s1r - g11i * s1i
    n1i = g10r * s0i + g10i * s0r + g11r * s1i + g11i * s1r
    return (torch.stack([n0r, n1r], dim=1).reshape(d, B),
            torch.stack([n0i, n1i], dim=1).reshape(d, B))


def gate_chain_planes_plain(pr, pi, rot_mats, k: int, wires: int):
    """The chain in plain PyTorch, on any device: same arguments and
    results as :func:`gate_chain_planes`."""
    g8 = _to_g8(rot_mats)
    signs = _sign_planes_on(k, wires, pr.device)
    sr = torch.zeros_like(pr)
    sr[0] = 1.0
    si = torch.zeros_like(pi)
    for l in range(g8.shape[0]):
        if l % k == 0:
            sr, si = sr * pr - si * pi, sr * pi + si * pr
        for j in range(wires):
            sr, si = _gate_apply(sr, si, g8[l, j], j)
        sg = signs[l % k]
        sr, si = sr * sg, si * sg
    return sr, si


# --- CUDA kernel -------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin "
                       "(default /usr/local/cuda): cannot build "
                       f"{_SOURCE.name}")


def build_library() -> pathlib.Path:
    """Compile ``csrc/gate_chain.cu`` unless a library from the same source
    and flags is already built; returns its path. The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside it
    with the suffix ``.log``."""
    key = hashlib.sha256(_SOURCE.read_bytes()
                         + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"gate_chain_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                           str(_SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.gate_chain_fwd.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
        lib.gate_chain_fwd.restype = ctypes.c_int
        lib.gate_chain_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.gate_chain_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.gate_chain_error_string.argtypes = [ctypes.c_int]
        lib.gate_chain_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _gate_chain_cuda(pr, pi, g8, signs, k: int, wires: int):
    """Launch the kernel on PyTorch's current stream; (sr, si) are new
    (d, B) float32 tensors."""
    global LAUNCHES
    tensors = (pr, pi, g8, signs)
    if any(t.device != pr.device or t.device.type != "cuda" for t in tensors):
        raise ValueError("gate-chain kernel: every input must be on the "
                         "same CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("gate-chain kernel: inputs must be contiguous "
                         "float32, got "
                         f"{[(t.dtype, t.is_contiguous()) for t in tensors]}")
    if not 1 <= wires <= _config.KERNEL_MAX_WIRES:
        raise ValueError("gate-chain kernel takes "
                         f"1..{_config.KERNEL_MAX_WIRES} wires, "
                         f"got {wires}")
    d, B = pr.shape
    n_layers = g8.shape[0]
    if (pi.shape != (d, B) or B < 1 or k < 1 or n_layers < 1
            or g8.shape != (n_layers, wires, 8) or signs.shape != (k, d, 1)):
        raise ValueError(
            f"gate-chain kernel: bad shapes pr {tuple(pr.shape)}, pi "
            f"{tuple(pi.shape)}, g8 {tuple(g8.shape)}, signs "
            f"{tuple(signs.shape)} for wires={wires}, k={k}")
    lib = _library()
    smem = lib.gate_chain_fwd_smem_bytes(wires, n_layers, k)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"gate-chain kernel needs {smem} B of shared "
                         f"memory per block (limit {_MAX_SMEM_BYTES}): "
                         f"{n_layers} layers x {wires} wires is too deep")
    sr = torch.empty_like(pr)
    si = torch.empty_like(pi)
    stream = torch.cuda.current_stream(pr.device).cuda_stream
    err = lib.gate_chain_fwd(pr.data_ptr(), pi.data_ptr(), g8.data_ptr(),
                             signs.data_ptr(), sr.data_ptr(), si.data_ptr(),
                             wires, B, n_layers, k, pr.device.index, stream)
    if err != 0:
        raise RuntimeError("gate-chain kernel launch failed: "
                           f"{lib.gate_chain_error_string(err).decode()} "
                           f"(cudaError {err})")
    LAUNCHES += 1
    return sr, si


def gate_chain_planes(pr, pi, rot_mats, k: int, wires: int):
    """Plane-level re-uploading chain from |0...0>.

    pr, pi: (d, B) float32 RZ phase planes, applied before layers 0, k,
    2k, ...; rot_mats: (L*k, wires, 2, 2) complex per-wire rotations; the
    CZ ring after each layer uses range ``sel_ranges(k, wires)[l % k]``.
    Returns the state planes ``(sr, si)``, each (d, B) float32.

    Forward only: raises under grad mode when an input requires grad.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pr, pi, rot_mats)):
        raise RuntimeError(
            "gate_chain_planes is forward-only (its backward kernel is "
            "ROADMAP Queue 2 kernel #2): call it under torch.no_grad()")
    if pr.shape[0] != 2**wires:
        raise ValueError(f"planes of {pr.shape[0]} rows do not hold "
                         f"{wires} wires")
    if pr.device.type == "cpu":
        return gate_chain_planes_plain(pr, pi, rot_mats, k, wires)
    if pr.device.type == "cuda":
        return _gate_chain_cuda(pr, pi, _to_g8(rot_mats),
                                _sign_planes_on(k, wires, pr.device),
                                k, wires)
    raise ValueError(f"no gate-chain path for device {pr.device}")
