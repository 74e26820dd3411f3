"""The re-uploading gate chain and its adjoint backward: hand-written CUDA
kernels and their plain PyTorch versions (counterpart of
``qiddm_tpu/sim/pallas_gate_kernel.py``: ``_fwd_kernel``, ``_bwd_kernel``).

``gate_chain_planes`` is the entry the engine calls. It runs the
``_GateChain`` autograd Function, which picks the path by the device of its
input, in the forward and in the backward pass alike: a CPU tensor runs the
plain versions (:func:`gate_chain_planes_plain`,
:func:`gate_chain_bwd_plain`); a CUDA tensor launches the kernels of
``csrc/gate_chain.cu`` or raises. Nothing falls back from a kernel to its
plain version. The forward goes through the operator ``qiddm::gate_chain``
(``sim/ops.py``), whose CUDA and CPU implementations are the two paths,
so ``torch.export`` can trace it.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use, from
the sources in this checkout, into ``build/qiddm_tpu_torch/`` next to the
package. One library holds every kernel of the port (this chain's, the SEL
chain's of ``sel_kernel.py``, the RY chain's of ``ry_kernel.py``, the
density-matrix block's of ``dm_kernel.py``, the amplitude-damping
trajectory pass of ``amp_damp_kernel.py``, the wide chain's grouped
sublayer and its backward and its monolithic forward and backward of
``wide_kernel.py``, the unitary-streaming chain and its backward of
``unitary_kernel.py``, and the ceiling probes of
``tools/probe_kernels.py``); its
file name carries a hash of all the sources and the flags, so an edit of
any of them rebuilds it. It has a plain C interface and is bound with
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
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import config as _config
from .sel import cz_ring_signs, sel_ranges

# Kernel launches since the last reset, forward and backward; chip_smoke.py
# reads them to show that the sampling and training paths went through the
# kernels. BWD_BATCH_SUMS counts the backward calls whose batch did not fit
# one cluster (chain_bwd_plan), so that a second launch summed dg.
LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_BATCH_SUMS = 0

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
# compiled together into one library; the headers are hashed, not compiled
_SOURCES = (_CSRC / "gate_chain.cu", _CSRC / "sel_chain.cu",
            _CSRC / "ry_chain.cu", _CSRC / "dm_chain.cu",
            _CSRC / "amp_damp.cu", _CSRC / "wide_chain.cu",
            _CSRC / "wide_mono.cu", _CSRC / "unitary_chain.cu",
            _CSRC / "probes.cu")
_HEADERS = (_CSRC / "chain_common.cuh", _CSRC / "chain_regs.cuh",
            _CSRC / "wide_common.cuh")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "qiddm_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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

def _pair_update(g, s0r, s0i, s1r, s1i):
    """The packed 2x2 gate g on amplitude pairs (s0, s1): the new pair."""
    g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i = g.unbind()
    return (g00r * s0r - g00i * s0i + g01r * s1r - g01i * s1i,
            g00r * s0i + g00i * s0r + g01r * s1i + g01i * s1r,
            g10r * s0r - g10i * s0i + g11r * s1r - g11i * s1i,
            g10r * s0i + g10i * s0r + g11r * s1i + g11i * s1r)


def _gate_apply(sr, si, g, j: int):
    """One 2x2 gate on wire j of (d, B) planes: reshape to
    (2^j, 2, d / 2^(j+1), B) and mix the two halves."""
    d, B = sr.shape
    left = 2**j
    vr = sr.reshape(left, 2, d // (2 * left), B)
    vi = si.reshape(left, 2, d // (2 * left), B)
    n0r, n0i, n1r, n1i = _pair_update(g, vr[:, 0], vi[:, 0], vr[:, 1],
                                      vi[:, 1])
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


# --- the kernels' launch plans -----------------------------------------------

def _walk_shape(wires: int) -> tuple[int, int]:
    """Warps a sample and samples a CTA at most, as chain_regs.cuh's
    walk_warps and walk_max_samples: a warp up to 7 wires, 2 at 8, 4 at
    9-10, 8 at 11 and 16 at 12 (the SEL chain's widths); 4 samples a CTA up
    to 7 wires, 2 at 8-10, 1 from 11."""
    warps = (1 if wires < 8 else 2 if wires == 8 else 4 if wires <= 10
             else 8 if wires == 11 else 16)
    return warps, 4 if wires < 8 else 2 if wires <= 10 else 1


class ChainFwdPlan(NamedTuple):
    """How the register forwards (``csrc/chain_regs.cuh``'s ``chain_fwd``,
    kernels #1 and #3, and ``sel_fwd``, #5) lay out a call: ``warps`` warps
    a sample, ``samples`` samples a CTA, ``grid`` CTAs of ``threads``
    threads, a plain launch."""
    warps: int
    samples: int
    grid: int
    threads: int


def _fwd_layout(wires: int, batch: int) -> ChainFwdPlan:
    """A CTA of four warps, one for each of an SM's schedulers (4 samples
    up to 7 wires, 2 at 8, 1 from 9; from 11 wires a sample's own 8 or 16
    warps), or of the batch's samples if fewer."""
    warps = _walk_shape(wires)[0]
    samples = max(1, min(4 // warps, batch))
    return ChainFwdPlan(warps, samples, -(-batch // samples),
                        32 * warps * samples)


def chain_fwd_plan(wires: int, batch: int) -> ChainFwdPlan:
    """The forward's layout for ``batch`` samples at ``wires`` wires, from
    the shape alone: a CTA of four warps, one for each of an SM's
    schedulers (4 samples up to 7 wires, 2 at 8, 1 from 9), or of the
    batch's samples if fewer. The forward issues as fast as a warp alone
    on its scheduler can; a second warp on one halves both."""
    if not 1 <= wires <= _config.KERNEL_MAX_WIRES or batch < 1:
        raise ValueError(f"no forward plan for {wires} wires, batch {batch}")
    return _fwd_layout(wires, batch)


# CTAs a thread-block cluster (portable)
_WALK_MAX_CLUSTER = 8


class ChainBwdPlan(NamedTuple):
    """How the register walks (``csrc/chain_regs.cuh``: the backward
    kernels #2 and #4, and #6) lay out a call: ``warps`` warps a sample,
    ``samples`` samples a CTA, ``cluster`` CTAs a thread-block cluster,
    ``clusters`` clusters in the grid (``grid`` CTAs of ``threads``
    threads), and whether dg's batch sum ends in the launch (one cluster)
    or a second launch adds the clusters' sums in order."""
    warps: int
    samples: int
    cluster: int
    clusters: int
    grid: int
    threads: int
    in_launch: bool


def _bwd_layout(wires: int, batch: int) -> ChainBwdPlan:
    """A cluster of up to 8 CTAs holds the batch when it can: as few
    samples a CTA as spread it over 8 CTAs. A larger batch takes one sample
    a CTA, 8 CTAs a cluster, and the clusters' dg sums are added by a
    second launch."""
    warps, max_samples = _walk_shape(wires)
    cluster = min(_WALK_MAX_CLUSTER, 1 << (batch - 1).bit_length())
    samples = -(-batch // cluster)
    if samples > max_samples:
        samples = 1
    clusters = -(-batch // (samples * cluster))
    return ChainBwdPlan(warps, samples, cluster, clusters, cluster * clusters,
                        32 * warps * samples, clusters == 1)


def chain_bwd_plan(wires: int, batch: int) -> ChainBwdPlan:
    """The backward walk's layout for ``batch`` samples at ``wires`` wires,
    from the shape alone: a warp a sample up to 7 wires, 2 at 8, 4 from 9.
    A cluster of up to 8 CTAs holds the batch when it can (32 samples, 16
    from 8 wires): as few samples a CTA as spread it over 8 CTAs. A larger
    batch takes one sample a CTA, 8 CTAs a cluster, and the clusters' dg
    sums are added by a second launch."""
    if not 1 <= wires <= _config.KERNEL_MAX_WIRES or batch < 1:
        raise ValueError(f"no backward plan for {wires} wires, batch {batch}")
    return _bwd_layout(wires, batch)


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
                       + ", ".join(p.name for p in _SOURCES))


def build_library() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into one library unless one from the same
    sources, header and flags is already built; returns its path. One nvcc
    per source, all started together, then one link. The compilers' output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library with the suffix ``.log``."""
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in (*_SOURCES, *_HEADERS):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    lib = BUILD_DIR / f"chain_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in _SOURCES]
    try:
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_SOURCES, objs)]
        log = "".join(proc.communicate()[0] for proc in procs)
        codes = [proc.returncode for proc in procs]
        if not any(codes):
            link = subprocess.run([nvcc, *_NVCC_FLAGS[:2], "-shared", "-o",
                                   str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            codes = [link.returncode]
        if any(codes):
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed with code {max(codes)}:\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.gate_chain_fwd.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
        lib.gate_chain_fwd.restype = ctypes.c_int
        lib.gate_chain_bwd.argtypes = ([ctypes.c_void_p] * 12
                                       + [ctypes.c_int] * 8
                                       + [ctypes.c_void_p])
        lib.gate_chain_bwd.restype = ctypes.c_int
        for fn in (lib.gate_chain_fwd_smem_bytes,
                   lib.gate_chain_bwd_smem_bytes,
                   lib.ry_chain_fwd_smem_bytes,
                   lib.ry_chain_bwd_smem_bytes):
            fn.argtypes = [ctypes.c_int] * 4
            fn.restype = ctypes.c_size_t
        lib.sel_chain_fwd.argtypes = ([ctypes.c_void_p] * 6
                                      + [ctypes.c_int] * 7
                                      + [ctypes.c_void_p])
        lib.sel_chain_fwd.restype = ctypes.c_int
        lib.sel_chain_bwd.argtypes = ([ctypes.c_void_p] * 10
                                      + [ctypes.c_int] * 8
                                      + [ctypes.c_void_p])
        lib.sel_chain_bwd.restype = ctypes.c_int
        for fn in (lib.sel_chain_fwd_smem_bytes,
                   lib.sel_chain_bwd_smem_bytes):
            fn.argtypes = [ctypes.c_int] * 4
            fn.restype = ctypes.c_size_t
        lib.sel_rows_fwd.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 5
                                     + [ctypes.c_void_p])
        lib.sel_rows_fwd.restype = ctypes.c_int
        lib.sel_rows_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.sel_rows_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.ry_chain_fwd.argtypes = ([ctypes.c_void_p] * 5
                                     + [ctypes.c_int] * 7
                                     + [ctypes.c_void_p])
        lib.ry_chain_fwd.restype = ctypes.c_int
        lib.ry_chain_bwd.argtypes = ([ctypes.c_void_p] * 10
                                     + [ctypes.c_int] * 8
                                     + [ctypes.c_void_p])
        lib.ry_chain_bwd.restype = ctypes.c_int
        lib.dm_chain_fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                                     + [ctypes.c_void_p] + [ctypes.c_int] * 9
                                     + [ctypes.c_void_p])
        lib.dm_chain_fwd.restype = ctypes.c_int
        lib.dm_chain_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.dm_chain_smem_bytes.restype = ctypes.c_size_t
        lib.dm_chain_active_clusters.argtypes = [ctypes.c_int] * 6
        lib.dm_chain_active_clusters.restype = ctypes.c_int
        lib.amp_damp_fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                                     + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 5
                                     + [ctypes.c_void_p])
        lib.amp_damp_fwd.restype = ctypes.c_int
        ptr, num = ctypes.c_void_p, ctypes.c_int
        lib.wide_chain_fwd.argtypes = [ptr] * 10 + [num] * 8 + [ptr]
        lib.wide_chain_fwd.restype = num
        lib.wide_chain_bwd.argtypes = [ptr] * 23 + [num] * 8 + [ptr]
        lib.wide_chain_bwd.restype = num
        lib.wide_chain_bwd_part_floats.argtypes = [num] * 5
        lib.wide_chain_bwd_part_floats.restype = ctypes.c_size_t
        lib.wide_mono_fwd.argtypes = [ptr] * 10 + [num] * 8 + [ptr]
        lib.wide_mono_fwd.restype = num
        lib.wide_mono_bwd.argtypes = [ptr] * 23 + [num] * 8 + [ptr]
        lib.wide_mono_bwd.restype = num
        lib.wide_mono_plan.argtypes = [num] * 7 + [ptr]
        lib.wide_mono_plan.restype = num
        lib.unitary_chain_fwd.argtypes = [ptr] * 6 + [num] * 6 + [ptr]
        lib.unitary_chain_fwd.restype = num
        lib.unitary_chain_bwd.argtypes = [ptr] * 13 + [num] * 6 + [ptr]
        lib.unitary_chain_bwd.restype = num
        for fn in (lib.unitary_chain_fwd_smem_bytes,
                   lib.unitary_chain_bwd_smem_bytes):
            fn.argtypes = [num] * 2
            fn.restype = ctypes.c_size_t
        for fn in (lib.unitary_chain_fwd_active_clusters,
                   lib.unitary_chain_bwd_active_clusters):
            fn.argtypes = [num] * 3
            fn.restype = num
        lib.gate_chain_error_string.argtypes = [ctypes.c_int]
        lib.gate_chain_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_cuda_inputs(what: str, planes, g8, table, table_shape,
                       wires: int, rows: int = 0,
                       max_wires: int = _config.KERNEL_MAX_WIRES):
    """Raise unless every tensor is contiguous on one CUDA device, the
    planes and gates float32 (the table float32 or int32), 1 <= wires <=
    ``max_wires``, and the shapes fit: planes (rows, B) with ``rows``
    2**wires unless given, g8 (n_layers, wires, 8), the sign or ring table
    ``table_shape``. Returns (rows, B, n_layers)."""
    tensors = (*planes, g8, table)
    dev = planes[0].device
    if any(t.device != dev or t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: every input must be on the same CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if (any(t.dtype != torch.float32 for t in (*planes, g8))
            or table.dtype not in (torch.float32, torch.int32)
            or not all(t.is_contiguous() for t in tensors)):
        raise ValueError(f"{what}: inputs must be contiguous float32, got "
                         f"{[(t.dtype, t.is_contiguous()) for t in tensors]}")
    if not 1 <= wires <= max_wires:
        raise ValueError(f"{what} takes 1..{max_wires} wires, got {wires}")
    d, B = planes[0].shape
    n_layers = g8.shape[0]
    if (any(t.shape != (d, B) for t in planes) or B < 1 or n_layers < 1
            or d != (rows or 2**wires) or g8.shape != (n_layers, wires, 8)
            or table.shape != tuple(table_shape)):
        raise ValueError(
            f"{what}: bad shapes {[tuple(t.shape) for t in planes]}, g8 "
            f"{tuple(g8.shape)}, table {tuple(table.shape)} for "
            f"wires={wires}")
    return d, B, n_layers


def _check_smem(smem: int, n_layers: int, wires: int) -> None:
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"chain kernel needs {smem} B of shared "
                         f"memory per block (limit {_MAX_SMEM_BYTES}): "
                         f"{n_layers} layers x {wires} wires is too deep")


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.gate_chain_error_string(err).decode()} "
                           f"(cudaError {err})")


def _gate_chain_cuda(pr, pi, g8, signs, k: int, wires: int):
    """Launch the forward kernel on PyTorch's current stream, laid out by
    :func:`chain_fwd_plan`; (sr, si) are new (d, B) float32 tensors."""
    global LAUNCHES
    d, B, n_layers = _check_cuda_inputs("gate-chain kernel", (pr, pi), g8,
                                        signs, (k, 2**wires, 1), wires)
    lib = _library()
    plan = chain_fwd_plan(wires, B)
    _check_smem(lib.gate_chain_fwd_smem_bytes(wires, n_layers, k,
                                              plan.samples), n_layers, wires)
    sr = torch.empty_like(pr)
    si = torch.empty_like(pi)
    stream = torch.cuda.current_stream(pr.device).cuda_stream
    err = lib.gate_chain_fwd(pr.data_ptr(), pi.data_ptr(), g8.data_ptr(),
                             signs.data_ptr(), sr.data_ptr(), si.data_ptr(),
                             wires, B, n_layers, k, plan.samples, plan.grid,
                             pr.device.index, stream)
    _raise_on(err, lib, "gate-chain kernel")
    LAUNCHES += 1
    return sr, si


def _gate_chain_bwd_cuda(pr, pi, g8, signs, fr, fi, gr, gi, k: int,
                         wires: int):
    """Launch the backward kernel on PyTorch's current stream, laid out by
    :func:`chain_bwd_plan` (and, for a batch larger than one cluster, the
    fixed-order sum of the clusters' dg); returns new (dpr, dpi, dg) as
    :func:`gate_chain_bwd_plain` does."""
    global BWD_LAUNCHES, BWD_BATCH_SUMS
    d, B, n_layers = _check_cuda_inputs(
        "gate-chain backward kernel", (pr, pi, fr, fi, gr, gi), g8, signs,
        (k, 2**wires, 1), wires)
    lib = _library()
    plan = chain_bwd_plan(wires, B)
    _check_smem(lib.gate_chain_bwd_smem_bytes(wires, n_layers, k,
                                              plan.samples), n_layers, wires)
    dg = torch.empty_like(g8)
    dg_part = dg if plan.in_launch else torch.empty(
        (plan.clusters, n_layers, wires, 8), dtype=torch.float32,
        device=pr.device)
    dpr = torch.empty_like(pr)
    dpi = torch.empty_like(pi)
    stream = torch.cuda.current_stream(pr.device).cuda_stream
    err = lib.gate_chain_bwd(pr.data_ptr(), pi.data_ptr(), g8.data_ptr(),
                             signs.data_ptr(), fr.data_ptr(), fi.data_ptr(),
                             gr.data_ptr(), gi.data_ptr(), dg_part.data_ptr(),
                             dg.data_ptr(), dpr.data_ptr(), dpi.data_ptr(),
                             wires, B, n_layers, k, plan.samples,
                             plan.cluster, plan.clusters, pr.device.index,
                             stream)
    _raise_on(err, lib, "gate-chain backward kernel")
    BWD_LAUNCHES += 1
    if not plan.in_launch:
        BWD_BATCH_SUMS += 1
    return dpr, dpi, dg


class _GateChain(torch.autograd.Function):
    """``(pr, pi, g8) -> (sr, si)`` on real float32 planes, so autograd
    carries ``dg`` back to the complex rotations through :func:`_to_g8`'s
    ``.real``/``.imag`` and no conjugation is written by hand. Saves
    ``(pr, pi, g8, sr, si)``, as ``_gate_chain_fwd`` does on the TPU; the
    backward rebuilds the states from the output.

    In the ``setup_context`` form, with a generated vmap rule, so
    ``torch.func.vmap`` passes through it to the operator's batching rule
    (``sim/ops.py``), which launches #1 once for each weight set."""

    generate_vmap_rule = True

    @staticmethod
    def forward(pr, pi, g8, k: int, wires: int):
        return torch.ops.qiddm.gate_chain.default(pr, pi, g8, k, wires)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pr, pi, g8, k, wires = inputs
        ctx.save_for_backward(pr, pi, g8, *output)
        ctx.k, ctx.wires = k, wires

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
