"""The re-uploading gate chain and its adjoint backward: hand-written CUDA
kernels and their plain PyTorch versions (counterpart of
``qiddm_tpu/sim/pallas_gate_kernel.py``: ``_fwd_kernel``, ``_bwd_kernel``).

``gate_chain_planes`` is the entry the engine calls. It runs the
``_GateChain`` autograd Function, which picks the path by the device of its
input, in the forward and in the backward pass alike: a CPU tensor runs the
plain versions (:func:`gate_chain_planes_plain`,
:func:`gate_chain_bwd_plain`); a CUDA tensor launches the kernels of
``csrc/gate_chain.cu`` or raises. Nothing falls back from a kernel to its
plain version.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use, from
the source in this checkout, into ``build/qiddm_tpu_torch/`` next to the
package; the library's file name carries a hash of the source and the
flags, so an edit rebuilds it. It has a plain C interface and is bound with
``ctypes``.
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
from torch.autograd.function import once_differentiable

from .. import config as _config
from .sel import cz_ring_signs, sel_ranges

# Kernel launches since the last reset, forward and backward; chip_smoke.py
# reads them to show that the sampling and training paths went through the
# kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0

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


def _chain_plain(pr, pi, g8, signs, k: int, wires: int):
    """The forward chain on packed gates, in plain PyTorch."""
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


def gate_chain_planes_plain(pr, pi, rot_mats, k: int, wires: int):
    """The chain in plain PyTorch, on any device: same arguments and
    results as :func:`gate_chain_planes`."""
    return _chain_plain(pr, pi, _to_g8(rot_mats),
                        _sign_planes_on(k, wires, pr.device), k, wires)


# g8 index permutation and signs that give the adjoint gate conj(g).T
_ADJ_ORDER = [0, 1, 4, 5, 2, 3, 6, 7]
_ADJ_SIGNS = (1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0)


def _plane_dg(cr, ci, sr, si, j: int):
    """(8,) gradient of the gate on wire j from the output-side cotangent
    and the gate's input state: ``dg[x, y]`` sums over the rows whose wire
    bit is x (cotangent) and y (state), over the whole batch, of
    ``(c_r s_r + c_i s_i, c_i s_r - c_r s_i)``."""
    d, B = cr.shape
    left = 2**j
    shape = (left, 2, d // (2 * left), B)
    c_r, c_i = cr.reshape(shape), ci.reshape(shape)
    s_r, s_i = sr.reshape(shape), si.reshape(shape)
    out = []
    for x in range(2):
        for y in range(2):
            out.append((c_r[:, x] * s_r[:, y] + c_i[:, x] * s_i[:, y]).sum())
            out.append((c_i[:, x] * s_r[:, y] - c_r[:, x] * s_i[:, y]).sum())
    return torch.stack(out)


def gate_chain_bwd_plain(pr, pi, g8, signs, fr, fi, gr, gi, k: int,
                         wires: int):
    """The adjoint reverse walk in plain PyTorch, on any device.

    From the forward output ``(fr, fi)`` and its cotangent ``(gr, gi)``
    (all (d, B) float32), rebuild each layer's state through the inverse
    gates and return ``(dpr, dpi, dg)``: the (d, B) phase-plane gradients
    and the (L*k, wires, 8) packed gate gradient."""
    n_layers = g8.shape[0]
    adj = g8[..., _ADJ_ORDER] * g8.new_tensor(_ADJ_SIGNS)
    sr, si, cr, ci = fr, fi, gr, gi
    dpr = torch.zeros_like(pr)
    dpi = torch.zeros_like(pi)
    dg = [[None] * wires for _ in range(n_layers)]
    for l in range(n_layers - 1, -1, -1):
        sg = signs[l % k]  # CZ is self-inverse
        sr, si, cr, ci = sr * sg, si * sg, cr * sg, ci * sg
        for j in range(wires - 1, -1, -1):
            sr, si = _gate_apply(sr, si, adj[l, j], j)  # the gate's input
            dg[l][j] = _plane_dg(cr, ci, sr, si, j)
            cr, ci = _gate_apply(cr, ci, adj[l, j], j)
        if l % k == 0:
            spr = sr * pr + si * pi  # state before the phase
            spi = si * pr - sr * pi
            dpr = dpr + cr * spr + ci * spi
            dpi = dpi + ci * spr - cr * spi
            cr, ci = cr * pr + ci * pi, ci * pr - cr * pi
            sr, si = spr, spi
    return dpr, dpi, torch.stack([torch.stack(row) for row in dg])


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
        lib.gate_chain_bwd.argtypes = ([ctypes.c_void_p] * 12
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
        lib.gate_chain_bwd.restype = ctypes.c_int
        for fn in (lib.gate_chain_fwd_smem_bytes,
                   lib.gate_chain_bwd_smem_bytes):
            fn.argtypes = [ctypes.c_int] * 3
            fn.restype = ctypes.c_size_t
        lib.gate_chain_error_string.argtypes = [ctypes.c_int]
        lib.gate_chain_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_cuda_inputs(planes, g8, signs, k: int, wires: int):
    """Raise unless every tensor is contiguous float32 on one CUDA device
    and the shapes fit; returns (d, B, n_layers)."""
    tensors = (*planes, g8, signs)
    dev = planes[0].device
    if any(t.device != dev or t.device.type != "cuda" for t in tensors):
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
    d, B = planes[0].shape
    n_layers = g8.shape[0]
    if (any(t.shape != (d, B) for t in planes) or B < 1 or k < 1
            or n_layers < 1 or g8.shape != (n_layers, wires, 8)
            or signs.shape != (k, d, 1)):
        raise ValueError(
            "gate-chain kernel: bad shapes "
            f"{[tuple(t.shape) for t in planes]}, g8 {tuple(g8.shape)}, "
            f"signs {tuple(signs.shape)} for wires={wires}, k={k}")
    return d, B, n_layers


def _check_smem(smem: int, n_layers: int, wires: int) -> None:
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"gate-chain kernel needs {smem} B of shared "
                         f"memory per block (limit {_MAX_SMEM_BYTES}): "
                         f"{n_layers} layers x {wires} wires is too deep")


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.gate_chain_error_string(err).decode()} "
                           f"(cudaError {err})")


def _gate_chain_cuda(pr, pi, g8, signs, k: int, wires: int):
    """Launch the forward kernel on PyTorch's current stream; (sr, si) are
    new (d, B) float32 tensors."""
    global LAUNCHES
    d, B, n_layers = _check_cuda_inputs((pr, pi), g8, signs, k, wires)
    lib = _library()
    _check_smem(lib.gate_chain_fwd_smem_bytes(wires, n_layers, k), n_layers,
                wires)
    sr = torch.empty_like(pr)
    si = torch.empty_like(pi)
    stream = torch.cuda.current_stream(pr.device).cuda_stream
    err = lib.gate_chain_fwd(pr.data_ptr(), pi.data_ptr(), g8.data_ptr(),
                             signs.data_ptr(), sr.data_ptr(), si.data_ptr(),
                             wires, B, n_layers, k, pr.device.index, stream)
    _raise_on(err, lib, "gate-chain kernel")
    LAUNCHES += 1
    return sr, si


def _gate_chain_bwd_cuda(pr, pi, g8, signs, fr, fi, gr, gi, k: int,
                         wires: int):
    """Launch the backward kernel (and its fixed-order batch sum of dg) on
    PyTorch's current stream; returns new (dpr, dpi, dg) as
    :func:`gate_chain_bwd_plain` does."""
    global BWD_LAUNCHES
    d, B, n_layers = _check_cuda_inputs((pr, pi, fr, fi, gr, gi), g8, signs,
                                        k, wires)
    lib = _library()
    _check_smem(lib.gate_chain_bwd_smem_bytes(wires, n_layers, k), n_layers,
                wires)
    dg_part = torch.empty((B, n_layers, wires, 8), dtype=torch.float32,
                          device=pr.device)
    dg = torch.empty_like(g8)
    dpr = torch.empty_like(pr)
    dpi = torch.empty_like(pi)
    stream = torch.cuda.current_stream(pr.device).cuda_stream
    err = lib.gate_chain_bwd(pr.data_ptr(), pi.data_ptr(), g8.data_ptr(),
                             signs.data_ptr(), fr.data_ptr(), fi.data_ptr(),
                             gr.data_ptr(), gi.data_ptr(), dg_part.data_ptr(),
                             dg.data_ptr(), dpr.data_ptr(), dpi.data_ptr(),
                             wires, B, n_layers, k, pr.device.index, stream)
    _raise_on(err, lib, "gate-chain backward kernel")
    BWD_LAUNCHES += 1
    return dpr, dpi, dg


class _GateChain(torch.autograd.Function):
    """``(pr, pi, g8) -> (sr, si)`` on real float32 planes, so autograd
    carries ``dg`` back to the complex rotations through :func:`_to_g8`'s
    ``.real``/``.imag`` and no conjugation is written by hand. Saves
    ``(pr, pi, g8, sr, si)``, as ``_gate_chain_fwd`` does on the TPU; the
    backward rebuilds the states from the output."""

    @staticmethod
    def forward(ctx, pr, pi, g8, k: int, wires: int):
        signs = _sign_planes_on(k, wires, pr.device)
        if pr.device.type == "cuda":
            sr, si = _gate_chain_cuda(pr, pi, g8, signs, k, wires)
        else:
            sr, si = _chain_plain(pr, pi, g8, signs, k, wires)
        ctx.save_for_backward(pr, pi, g8, sr, si)
        ctx.k, ctx.wires = k, wires
        return sr, si

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        pr, pi, g8, fr, fi = ctx.saved_tensors
        k, wires = ctx.k, ctx.wires
        # readouts hand back transposed views; an unused output gives None
        gr = torch.zeros_like(fr) if gr is None else gr.contiguous()
        gi = torch.zeros_like(fi) if gi is None else gi.contiguous()
        signs = _sign_planes_on(k, wires, pr.device)
        if pr.device.type == "cuda":
            dpr, dpi, dg = _gate_chain_bwd_cuda(pr, pi, g8, signs, fr, fi,
                                                gr, gi, k, wires)
        else:
            dpr, dpi, dg = gate_chain_bwd_plain(pr, pi, g8, signs, fr, fi,
                                                gr, gi, k, wires)
        return dpr, dpi, dg, None, None


def gate_chain_planes(pr, pi, rot_mats, k: int, wires: int):
    """Plane-level re-uploading chain from |0...0>.

    pr, pi: (d, B) float32 RZ phase planes, applied before layers 0, k,
    2k, ...; rot_mats: (L*k, wires, 2, 2) complex per-wire rotations; the
    CZ ring after each layer uses range ``sel_ranges(k, wires)[l % k]``.
    Returns the state planes ``(sr, si)``, each (d, B) float32.

    Differentiable in ``pr``, ``pi`` and ``rot_mats``: the backward runs
    the adjoint kernel on a CUDA tensor, its plain version on a CPU one.
    """
    if pr.shape[0] != 2**wires:
        raise ValueError(f"planes of {pr.shape[0]} rows do not hold "
                         f"{wires} wires")
    if pr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no gate-chain path for device {pr.device}")
    return _GateChain.apply(pr, pi, _to_g8(rot_mats), k, wires)
