"""The ceiling probes: hand-written CUDA kernels and their plain PyTorch
versions (counterparts of the six ``pl.pallas_call`` sites of the TPU's
``tools/bench_pallas_wide_probe.py`` and ``tools/vpu_ceiling.py``).

Each probe has a wrapper and a plain version with the same signature. The
wrapper picks the path by the device of its input: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel of ``csrc/probes.cu`` or
raises. Nothing falls back from a kernel to its plain version. The kernels
are built into the one library of ``sim/gate_kernel.py``. No probe has a
gradient.

* P1 :func:`smem_probe` (``probe_vmem``): an (S / 512, 128) float32 scratch
  of S bytes of shared memory, x written into its first and last 8 rows,
  ``head + tail`` returned: ``2 x``. The TPU kernel reads a tail it never
  wrote (its output is undefined); the port defines it. One block is a
  plain launch; a cluster of ``cluster`` > 1 blocks is a cluster launch in
  which block 0 reads the tail of the last block's scratch through
  distributed shared memory. Returns ``None`` when the card refuses the
  shape (its only capacity answer), asked once a shape and device.
* P2 :func:`transpose_probe` (``probe_transpose``): ``n_iters`` x
  ``x <- transpose(transpose(x) * 1.000001)``, a block a column strip held
  in shared memory with its transpose through every iteration
  (:func:`transpose_plan`).
* P3 :func:`reshape_probe` (``probe_reshape``): ``n_iters`` x
  ``x <- reshape(reshape(x, (C, R)) * 1.000001, (R, C)) * 0.999999``, in
  one wave of blocks that each own a contiguous run of float4s
  (:func:`reshape_plan`); the plain version's bits.
* P5 :func:`matmul2_probe` (``probe_matmul2``): ``n_iters`` x ``x <- g @ x``
  to float32 accuracy as 3xTF32 ``wgmma`` products on the tensor cores
  (sm_90a), a block a strip of columns held in shared memory through every
  product (:func:`matmul2_plan`); within its stated tolerance of the plain
  version, the same bits call after call.
* P4 :func:`dot3d_probe` (``probe_dot3d``): ``out[a, i, c] = sum_j g[i, j]
  x[a, j, c]``, a block a slice (:func:`dot3d_plan`).
* :func:`fma_ceiling` (``_fma_kernel``): ``chains`` accumulators
  ``a_c = x * (1 + 0.1 c)``, ``iters`` x ``a <- a * 1.0000001 + y`` (one
  FMA, one rounding, on the card and in the plain version), output the
  left fold ``a_0 + a_1 + ...``.

P4 sums each output over k in order from zero, one float32 FMA a term:
:func:`in_order_matmul` gives its bits exactly.
"""

from __future__ import annotations

import ctypes

import torch

from ..sim import gate_kernel as _gk

# Kernel launches since the last reset, one a wrapper call; chip_smoke.py
# reads them to show that the probe tools went through the kernels.
PROBE_LAUNCHES = {"smem": 0, "transpose": 0, "reshape": 0, "matmul2": 0,
                  "dot3d": 0, "fma": 0}

# probe_smem's answer when the card cannot hold the scratch or the cluster
_CAPACITY_REFUSED = -1
# P1's scratch rows are 128 float32; x fills 8 of them at each end
ROW_BYTES = 512
MIN_SMEM_BYTES = 16 * ROW_BYTES
# P4: each thread of a block owns 8 rows x 4 columns of the product
SLAB_ROWS, SLAB_COLS, SLAB_MAX_THREADS = 8, 4, 256
# P4 takes the (m, w) whose slab_smem_bytes(m, w + 4) fit a block: the
# shapes the probe always took (its first layout padded g's rows by 4),
# a little inside what the present layout needs
SLAB_TAKEN_PAD = 4
# P5: a block's strip of columns (wgmma's N, ``kCols``), a warpgroup's rows (wgmma's M), the rows a block takes at most (two
# warpgroups, g's hi and lo halves in registers), and the 8-deep k-steps the
# large term g_hi x_hi chains in one accumulator before it is added in
# float32 (``kRun`` of csrc/probes.cu; set against P5's tolerance by
# tests/test_torch_probe_tf32.py)
MATMUL2_COLS = 64
MATMUL2_ROW_TILE = 64
MATMUL2_MAX_ROWS = 128
MATMUL2_RUN = 8
# P3: 256-thread blocks (``kThreads`` of csrc/probes.cu), at most 4 an SM
# (one wave)
RESHAPE_THREADS, RESHAPE_BLOCKS_PER_SM = 256, 4
FMA_CHAINS = (1, 4, 8)

# Streaming multiprocessors of the H100, which P2's strips fill
_SMS = 132

_BOUND = False
# P1's capacity answers, (device index, bytes, cluster) -> fits
_SMEM_FITS: dict = {}


def reset_launches() -> None:
    for key in PROBE_LAUNCHES:
        PROBE_LAUNCHES[key] = 0


# --- plain PyTorch versions --------------------------------------------------

def smem_probe_plain(x, smem_bytes: int, cluster: int = 1):
    """P1 in plain PyTorch: ``2 x`` (head plus the tail it was copied to)."""
    return x + x


def transpose_probe_plain(x, n_iters: int):
    """P2 in plain PyTorch: two transposes a step, the first scaled."""
    for _ in range(n_iters):
        x = (x.t().contiguous() * 1.000001).t().contiguous()
    return x


def reshape_probe_plain(x, n_iters: int):
    """P3 in plain PyTorch: two reshapes a step, each followed by a scale."""
    rows, cols = x.shape
    for _ in range(n_iters):
        y = x.reshape(cols, rows) * 1.000001
        x = y.reshape(rows, cols) * 0.999999
    return x


def matmul2_probe_plain(g, x, n_iters: int):
    """P5 in plain PyTorch: ``n_iters`` x ``x <- g @ x`` in float32 (TF32
    off, as ``qiddm_tpu_torch.config`` pins it)."""
    for _ in range(n_iters):
        x = g @ x
    return x


def dot3d_probe_plain(g, x):
    """P4 in plain PyTorch: ``g`` (m, m) against each (m, w) slice of ``x``."""
    return torch.matmul(g, x)


def _fma_round(p, c):
    """float32 ``p + c`` rounded once, for p an exact float64 product of two
    float32 and c float32: fmaf's result. The float64 sum s is rounded;
    TwoSum gives its error e, so s + e is the exact sum. Rounding s to
    float32 errs only where s lies exactly halfway between two float32 and
    e is not 0: there the exact sum lies on e's side."""
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    f = s.float()
    d = f.double()
    inf = torch.full_like(f, float("inf"))
    other = torch.nextafter(f, torch.where(s > d, inf, -inf))
    tie = (s != d) & (2 * s == d + other.double()) & (e != 0)
    return torch.where(tie, torch.where(e > 0, torch.maximum(f, other),
                                        torch.minimum(f, other)), f)


def in_order_matmul(g, x):
    """``g @ x`` (x (m, n) or (a, m, n)) with each output summed over k in
    order from zero, one float32 FMA (one rounding) a term: the P4
    kernel's arithmetic, emulated exactly in float64, so its outputs equal
    it bit for bit."""
    g64, x64 = g.double(), x.double()
    acc = torch.zeros(x.shape[:-2] + (g.shape[0], x.shape[-1]),
                      dtype=torch.float32, device=x.device)
    for k in range(g.shape[1]):
        acc = _fma_round(g64[:, k, None] * x64[..., k, None, :], acc)
    return acc


def fma_ceiling_plain(x, y, iters: int, chains: int):
    """The FMA recurrence in plain PyTorch, the chains stacked on a leading
    axis. Each step is ``a * 1.0000001 + y`` with the FMA's one rounding:
    the product and the sum in float64 (the product of two float32 is exact
    there), rounded to float32. A float32 multiply and add round twice and
    lose the product's increment (1.2e-7 of a) to the first rounding step
    after step: 8e-5 relative apart from the FMA at (1024, 80) after 4096
    steps."""
    scale = torch.tensor([1.0 + 0.1 * c for c in range(chains)],
                         dtype=x.dtype, device=x.device)
    accs = x * scale.reshape(chains, *([1] * x.dim()))
    mult = torch.tensor(1.0000001, dtype=torch.float32).item()
    y64 = y.double()
    for _ in range(iters):
        accs = (accs.double() * mult + y64).to(x.dtype)
    out = accs[0]
    for c in range(1, chains):
        out = out + accs[c]
    return out


# --- CUDA kernels ------------------------------------------------------------

def _library():
    global _BOUND
    lib = _gk._library()
    if not _BOUND:
        ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, args in (
                ("probe_smem_fits", [num, num, num]),
                ("probe_smem", [ptr, ptr, num, num, num, ptr]),
                ("probe_transpose", [ptr, ptr] + [num] * 5 + [ptr]),
                ("probe_reshape", [ptr, ptr, big, num, num, num, ptr]),
                ("probe_matmul2", [ptr, ptr, ptr] + [num] * 7 + [ptr]),
                ("probe_dot3d", [ptr, ptr, ptr] + [num] * 7 + [ptr]),
                ("fma_ceiling", [ptr, ptr, ptr, big, num, num, num, ptr])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = num
        for name, args in (("probe_transpose_smem_bytes", [num, num]),
                           ("probe_matmul2_smem_bytes", [num])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_size_t
        _BOUND = True
    return lib


def _check(what: str, tensors, shapes) -> torch.device:
    """Raise unless every tensor is contiguous float32 on one CUDA device
    with the given shape; returns the device."""
    dev = tensors[0].device
    if any(t.device != dev or t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: every input must be on the same CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous float32, got "
                         f"{[(t.dtype, t.is_contiguous()) for t in tensors]}")
    got = [tuple(t.shape) for t in tensors]
    if got != [tuple(s) for s in shapes]:
        raise ValueError(f"{what}: shapes {got}, expected {shapes}")
    return dev


def _dispatch(what: str, first):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if first.device.type == "cpu":
        return False
    if first.device.type != "cuda":
        raise ValueError(f"{what}: no path for device {first.device}")
    return True


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launched(err: int, lib, what: str, key: str) -> None:
    _gk._raise_on(err, lib, what)
    PROBE_LAUNCHES[key] += 1


def smem_probe(x, smem_bytes: int, cluster: int = 1):
    """P1: ``2 x`` for x (8, 128) float32 through a scratch of
    ``smem_bytes`` of shared memory a block (a multiple of 512, at least
    8 KB), in a cluster of ``cluster`` blocks; ``None`` when the card
    refuses that shape. Any other error raises."""
    if smem_bytes % ROW_BYTES or smem_bytes < MIN_SMEM_BYTES or cluster < 1:
        raise ValueError(f"P1 takes a multiple of {ROW_BYTES} bytes from "
                         f"{MIN_SMEM_BYTES} and a cluster >= 1, got "
                         f"{smem_bytes}, {cluster}")
    if not _dispatch("P1", x):
        return smem_probe_plain(x, smem_bytes, cluster)
    dev = _check("P1", (x,), [(8, 128)])
    _aligned("P1", (x,))
    lib = _library()
    shape = (dev.index, smem_bytes, cluster)
    if shape not in _SMEM_FITS:
        err = lib.probe_smem_fits(smem_bytes, cluster, dev.index)
        if err != _CAPACITY_REFUSED:
            _gk._raise_on(err, lib, "P1 probe_smem_fits")
        _SMEM_FITS[shape] = err != _CAPACITY_REFUSED
    if not _SMEM_FITS[shape]:
        return None
    out = torch.empty_like(x)
    err = lib.probe_smem(x.data_ptr(), out.data_ptr(), smem_bytes, cluster,
                         dev.index, _stream(dev))
    _launched(err, lib, "P1 probe_smem kernel", "smem")
    return out


def transpose_smem_bytes(rows: int, w: int) -> int:
    """Shared memory of a P2 block at a strip of ``w`` columns: the strip
    [rows][w + 1] and its transpose [w][rows + 1] in float32
    (``transpose_smem`` of ``csrc/probes.cu``)."""
    return 4 * (rows * (w + 1) + w * (rows + 1))


def transpose_plan(rows: int, cols: int) -> tuple[int, int, int]:
    """P2's layout for an (R, C) plane: (w, blocks, smem_bytes), a block
    the column strip of w columns. w is 32 times a power of two that
    divides C and whose strip and transpose fit a block's shared memory:
    the narrowest whose blocks all find one of the card's 132 SMs, else
    the widest (then some SMs take two strips in turn). Raises for sides
    that are not multiples of 32 or a strip of 32 that does not fit."""
    if rows < 32 or cols < 32 or rows % 32 or cols % 32:
        raise ValueError(f"P2 takes sides that are multiples of 32, got "
                         f"({rows}, {cols})")
    widths = []
    w = 32
    while cols % w == 0:
        if transpose_smem_bytes(rows, w) <= _gk._MAX_SMEM_BYTES:
            widths.append(w)
        w *= 2
    if not widths:
        raise ValueError(f"P2: a strip of 32 columns of {rows} rows needs "
                         f"{transpose_smem_bytes(rows, 32)} B of shared "
                         f"memory a block (limit {_gk._MAX_SMEM_BYTES})")
    w = next((w for w in widths if cols // w <= _SMS), widths[-1])
    return w, cols // w, transpose_smem_bytes(rows, w)


def transpose_probe(x, n_iters: int):
    """P2 on an (R, C) float32 plane, R and C multiples of 32."""
    if n_iters < 1:
        raise ValueError(f"P2 takes n_iters >= 1, got {n_iters}")
    if not _dispatch("P2", x):
        return transpose_probe_plain(x, n_iters)
    rows, cols = x.shape
    dev = _check("P2", (x,), [(rows, cols)])
    w, _, smem = transpose_plan(rows, cols)
    lib = _library()
    if lib.probe_transpose_smem_bytes(rows, w) != smem:
        raise ValueError(f"P2: the kernel's shared memory at {rows} rows "
                         f"and {w} columns is not its plan's {smem} B")
    out = torch.empty_like(x)
    err = lib.probe_transpose(x.data_ptr(), out.data_ptr(), rows, cols, w,
                              n_iters, dev.index, _stream(dev))
    _launched(err, lib, "P2 probe_transpose kernel", "transpose")
    return out


def reshape_plan(n: int, sms: int = _SMS) -> tuple[int, int, int]:
    """P3's launch for a plane of n float32: ``(elements a thread, blocks,
    threads)``. One wave of ``RESHAPE_BLOCKS_PER_SM`` blocks of
    ``RESHAPE_THREADS`` an SM (fewer where a thread would not get a
    float4), so every SM gets the same work; block b owns the b-th of
    ``blocks`` equal contiguous runs of the n // 4 float4s, and a thread
    takes every 256th float4 of its run, loaded before any arithmetic. The
    n % 4 elements past the last float4 are a tail that block 0's first
    threads take. Elements a thread: 4 for each float4 of the run a thread
    takes at most. Raises for an empty plane."""
    if n < 1:
        raise ValueError(f"P3 takes a non-empty plane, got {n} elements")
    n4 = n // 4
    blocks = max(1, min(RESHAPE_BLOCKS_PER_SM * sms,
                        -(-n4 // RESHAPE_THREADS)))
    run = -(-n4 // blocks)
    return 4 * max(1, -(-run // RESHAPE_THREADS)), blocks, RESHAPE_THREADS


def reshape_probe(x, n_iters: int):
    """P3 on an (R, C) float32 plane."""
    if n_iters < 0:
        raise ValueError(f"P3 takes n_iters >= 0, got {n_iters}")
    if not _dispatch("P3", x):
        return reshape_probe_plain(x, n_iters)
    dev = _check("P3", (x,), [tuple(x.shape)])
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"P3 takes a 2-D plane, got {tuple(x.shape)}")
    _aligned("P3", (x,))
    lib = _library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, blocks, _ = reshape_plan(x.numel(), sms)
    out = torch.empty_like(x)
    err = lib.probe_reshape(x.data_ptr(), out.data_ptr(), x.numel(), n_iters,
                            blocks, dev.index, _stream(dev))
    _launched(err, lib, "P3 probe_reshape kernel", "reshape")
    return out


def _aligned(what: str, tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the kernel loads 16 bytes at a time; "
                         f"inputs must start 16-byte aligned")


def slab_smem_bytes(m: int, w: int) -> int:
    """Shared memory of a P4 block: g (m, m) and its (m, w) slab in
    float32 (``slab_smem`` of ``csrc/probes.cu``)."""
    return 4 * m * (m + w)


def _slab_fits(what: str, m: int, w: int) -> None:
    """Raise unless P4 takes (m, w): m rows of g a multiple of 8, w
    columns a block a multiple of 4, at most 256 threads of 8 x 4, and
    ``slab_smem_bytes(m, w + SLAB_TAKEN_PAD)`` within a block's opt-in
    shared memory."""
    threads = (m // SLAB_ROWS) * (w // SLAB_COLS)
    if (m < SLAB_ROWS or m % SLAB_ROWS or w < SLAB_COLS or w % SLAB_COLS
            or threads > SLAB_MAX_THREADS):
        raise ValueError(f"{what}: rows {m} must be a multiple of "
                         f"{SLAB_ROWS} and columns {w} of {SLAB_COLS}, at "
                         f"most {SLAB_MAX_THREADS} threads of 8 x 4")
    smem = slab_smem_bytes(m, w + SLAB_TAKEN_PAD)
    if smem > _gk._MAX_SMEM_BYTES:
        raise ValueError(f"{what}: {smem} B of shared memory a block "
                         f"(limit {_gk._MAX_SMEM_BYTES}) at m={m}, w={w}")


def dot3d_plan(a: int, m: int, w: int) -> tuple[int, int, int]:
    """P4's launch at x (a, m, w): ``(grid, threads, smem_bytes)``. A block
    owns one slice: ``a`` blocks of ``(m / 8) (w / 4)`` threads, each
    holding g and its slice's (m, w) slab in shared memory. Raises for a
    shape the probes do not take."""
    _slab_fits("P4", m, w)
    if a < 1:
        raise ValueError(f"P4 takes at least one slice, got {a}")
    return (a, (m // SLAB_ROWS) * (w // SLAB_COLS), slab_smem_bytes(m, w))


def matmul2_smem_bytes(m: int) -> int:
    """Shared memory of a P5 block: two buffers of its strip's TF32 hi and
    lo planes, ``MATMUL2_COLS`` columns by the k of ceil(m / 64) row tiles
    of 64, float32 (``matmul2_smem`` of ``csrc/probes.cu``)."""
    return (2 * 2 * MATMUL2_COLS * MATMUL2_ROW_TILE
            * -(-m // MATMUL2_ROW_TILE) * 4)


def matmul2_plan(m: int, n: int) -> tuple[int, int, int, int]:
    """P5's launch at g (m, m), x (m, n): ``(columns a block, blocks,
    threads, smem_bytes)``. A block owns a strip of ``MATMUL2_COLS``
    columns across all rows: one warpgroup of 128 threads a 64-row tile of
    g, one tile for m <= 64 and two to 128 (rows and k past m
    zero-padded), and the strip's hi and lo planes twice in shared memory.
    Raises for m outside 1..128 or n not a positive multiple of the
    strip."""
    w = MATMUL2_COLS
    if not 1 <= m <= MATMUL2_MAX_ROWS:
        raise ValueError(f"P5 takes 1..{MATMUL2_MAX_ROWS} rows (g's hi and "
                         f"lo halves in two warpgroups' registers), got {m}")
    if n < w or n % w:
        raise ValueError(f"P5: {n} columns are not a multiple of {w}")
    tiles = -(-m // MATMUL2_ROW_TILE)
    return w, n // w, 128 * tiles, matmul2_smem_bytes(m)


def matmul2_probe(g, x, n_iters: int):
    """P5: ``n_iters`` x ``x <- g @ x``, g (m, m), x (m, n) float32; on the
    card under :func:`matmul2_plan`."""
    if n_iters < 0:
        raise ValueError(f"P5 takes n_iters >= 0, got {n_iters}")
    if not _dispatch("P5", x):
        return matmul2_probe_plain(g, x, n_iters)
    m, n = x.shape
    dev = _check("P5", (g, x), [(m, m), (m, n)])
    _aligned("P5", (g, x))
    _, blocks, threads, smem = matmul2_plan(m, n)
    lib = _library()
    if lib.probe_matmul2_smem_bytes(m) != smem:
        raise ValueError(f"P5: the kernel's shared memory at {m} rows is "
                         f"not its plan's {smem} B")
    out = torch.empty_like(x)
    err = lib.probe_matmul2(g.data_ptr(), x.data_ptr(), out.data_ptr(), m, n,
                            blocks, threads, smem, n_iters, dev.index,
                            _stream(dev))
    _launched(err, lib, "P5 probe_matmul2 kernel", "matmul2")
    return out


def dot3d_probe(g, x):
    """P4: g (m, m) float32 against each (m, w) slice of x (a, m, w)."""
    if not _dispatch("P4", x):
        return dot3d_probe_plain(g, x)
    a, m, w = x.shape
    dev = _check("P4", (g, x), [(m, m), (a, m, w)])
    _aligned("P4", (g, x))
    grid, threads, smem = dot3d_plan(a, m, w)
    lib = _library()
    out = torch.empty_like(x)
    err = lib.probe_dot3d(g.data_ptr(), x.data_ptr(), out.data_ptr(), a, m,
                          w, grid, threads, smem, dev.index, _stream(dev))
    _launched(err, lib, "P4 probe_dot3d kernel", "dot3d")
    return out


def fma_ceiling(x, y, iters: int, chains: int):
    """The FMA ceiling on (d, B) float32 planes x and y; ``chains`` in
    1, 4, 8."""
    if chains not in FMA_CHAINS or iters < 0:
        raise ValueError(f"the FMA probe takes chains in {FMA_CHAINS} and "
                         f"iters >= 0, got {chains}, {iters}")
    if not _dispatch("FMA probe", x):
        return fma_ceiling_plain(x, y, iters, chains)
    dev = _check("FMA probe", (x, y), [tuple(x.shape)] * 2)
    if x.numel() == 0:
        raise ValueError("the FMA probe takes a non-empty plane")
    lib = _library()
    out = torch.empty_like(x)
    err = lib.fma_ceiling(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                          x.numel(), iters, chains, dev.index, _stream(dev))
    _launched(err, lib, "FMA ceiling kernel", "fma")
    return out
