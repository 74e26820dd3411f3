"""The ceiling probes of qiddm_tpu_torch.tools (rows 15a-15e and 16): the
plain PyTorch versions against the JAX kernel bodies of
``tools/bench_pallas_wide_probe.py`` and ``tools/vpu_ceiling.py`` run in
Pallas interpret mode on the CPU, the FMA recurrence also against float64,
the wrappers' dispatch and guards (a CPU tensor runs the plain version
and reaches no kernel), P2's plan (``transpose_plan``: its strips own every
element once, and their transposes, each in its own block, compose to the
plain version's bits), P4's launch plan (``dot3d_plan``: its blocks and
thread tiles cover every output once, within the card's limits, and it
refuses what the probes never took), P5's plan (``matmul2_plan``: its
strips own every column once, a warpgroup a 64-row tile, the shared memory
of two buffers of hi and lo planes; what it refuses) and P3's
(``reshape_plan``: one wave of equal contiguous runs that own every
element once, the tail included), the in-order FMA emulation that P4's
kernel equals bit for bit (``in_order_matmul``, against exact rational
arithmetic; P5's kernel no longer sums in that order: its 3xTF32
arithmetic is emulated in ``tests/test_torch_probe_tf32.py``), and the two
tools' entry points.

The TPU tools are imported by path and stay as they are. The FMA body is a
module function, run as ``functools.partial(_fma_kernel, iters, chains)``.
P1-P5's bodies are closures built inside the probe functions: a stand-in
``pl`` set on the imported module records each body and its output shape
and scratch (dropping the block specs and compiler parameters), and the
test runs the recorded body under ``pl.pallas_call(..., interpret=True)``
on seeded inputs.

Tolerances, relative to max(1, max|reference|): P2 and P3 1e-6 (the same
float32 roundings in the same order); P4 and P5 1e-5 (128-term float32 sums
in another order); the FMA recurrence 1e-5 against the JAX body and against
a float64 run. At the tool's 4096 iterations the FMA plain version equals
the JAX body bit for bit: both round once a step (XLA:CPU contracts the
body's multiply and add into one FMA), while a float32 multiply then add
rounds twice and drifts 8.07e-5 relative away. P1's plain version is exactly 2 x: the TPU body reads a tail
of its scratch it never wrote, so its output is undefined (interpret mode
fills the unwritten scratch with NaN); the port writes x to the tail too.
"""

import functools
import importlib.util
import pathlib
import types
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from qiddm_tpu_torch.sim import gate_kernel as _gk
from qiddm_tpu_torch.tools import probe_kernels as pk
from qiddm_tpu_torch.tools import vpu_ceiling, wide_probe

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
LAYOUT_TOL = 1e-6
SLAB_TOL = 1e-5
FMA_TOL = 1e-5


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probe():
    return _load("bench_pallas_wide_probe")


@pytest.fixture(scope="module")
def jax_vpu():
    return _load("vpu_ceiling")


def _record(monkeypatch, mod, probe, *args, **kwargs):
    """The kernel body, output shape and scratch that ``probe`` hands to
    pl.pallas_call, with the call itself replaced by zeros."""
    seen = {}

    def pallas_call(kernel, out_shape, scratch_shapes=(), **_):
        seen.update(kernel=kernel, out_shape=out_shape,
                    scratch_shapes=scratch_shapes)
        return lambda *a: jnp.zeros(out_shape.shape, out_shape.dtype)

    stub = types.SimpleNamespace(pallas_call=pallas_call,
                                 BlockSpec=lambda *a, **k: None)
    monkeypatch.setattr(mod, "pl", stub)
    probe(*args, **kwargs)
    return seen


def _interpret(seen, *inputs):
    return np.asarray(pl.pallas_call(
        seen["kernel"], out_shape=seen["out_shape"],
        scratch_shapes=seen.get("scratch_shapes", ()),
        interpret=True)(*inputs))


def _assert_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _orthogonal(m, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(m, m)))
    return (q * 0.9999).astype(np.float32)


# --- each plain version against the JAX kernel body --------------------------

def test_transpose_plain_matches_jax_body(monkeypatch, jax_probe):
    seen = _record(monkeypatch, jax_probe, jax_probe.probe_transpose,
                   n_iters=2)
    assert seen["out_shape"].shape == (128, 8192)
    x = np.random.default_rng(0).uniform(size=(128, 8192)).astype(np.float32)
    want = _interpret(seen, x)
    got = pk.transpose_probe_plain(torch.as_tensor(x), 2)
    _assert_rel(got.numpy(), want, LAYOUT_TOL)


def test_reshape_plain_matches_jax_body(monkeypatch, jax_probe):
    seen = _record(monkeypatch, jax_probe, jax_probe.probe_reshape,
                   n_iters=2)
    assert seen["out_shape"].shape == (8192, 128)
    x = np.random.default_rng(1).uniform(size=(8192, 128)).astype(np.float32)
    want = _interpret(seen, x)
    got = pk.reshape_probe_plain(torch.as_tensor(x), 2)
    _assert_rel(got.numpy(), want, LAYOUT_TOL)


@pytest.mark.parametrize("m,n", [(16, 64), (128, 8192)])
def test_matmul2_plain_matches_jax_body(monkeypatch, jax_probe, m, n):
    seen = _record(monkeypatch, jax_probe, jax_probe.probe_matmul2,
                   n_iters=3, m=m, n=n)
    assert seen["out_shape"].shape == (m, n)
    g = _orthogonal(m, 2)
    x = np.random.default_rng(3).uniform(size=(m, n)).astype(np.float32)
    want = _interpret(seen, g, x)
    got = pk.matmul2_probe_plain(torch.as_tensor(g), torch.as_tensor(x), 3)
    _assert_rel(got.numpy(), want, SLAB_TOL)


def test_dot3d_plain_matches_jax_body(monkeypatch, jax_probe):
    seen = _record(monkeypatch, jax_probe, jax_probe.probe_dot3d)
    assert seen["out_shape"].shape == (128, 128, 64)
    rng = np.random.default_rng(4)
    g = rng.normal(size=(128, 128)).astype(np.float32)
    x = rng.uniform(size=(128, 128, 64)).astype(np.float32)
    want = _interpret(seen, g, x)
    got = pk.dot3d_probe_plain(torch.as_tensor(g), torch.as_tensor(x))
    _assert_rel(got.numpy(), want, SLAB_TOL)


def _fma_f64(x, y, iters, chains):
    accs = [x.astype(np.float64) * np.float64(np.float32(1.0 + 0.1 * c))
            for c in range(chains)]
    c32 = np.float64(np.float32(1.0000001))
    for _ in range(iters):
        accs = [a * c32 + y for a in accs]
    return functools.reduce(np.add, accs)


@pytest.mark.parametrize("chains", [1, 4, 8])
@pytest.mark.parametrize("iters", [64, 256])
def test_fma_plain_matches_jax_body_and_float64(jax_vpu, iters, chains):
    rng = np.random.default_rng(5)
    x, y = (rng.uniform(size=(16, 8)).astype(np.float32) for _ in range(2))
    kern = functools.partial(jax_vpu._fma_kernel, iters, chains)
    want = _interpret({"kernel": kern, "out_shape": jax.ShapeDtypeStruct(
        (16, 8), jnp.float32)}, x, y)
    got = pk.fma_ceiling_plain(torch.as_tensor(x), torch.as_tensor(y), iters,
                               chains).numpy()
    exact = _fma_f64(x, y.astype(np.float64), iters, chains)
    _assert_rel(got, want, FMA_TOL)
    _assert_rel(got, exact, FMA_TOL)
    _assert_rel(want, exact, FMA_TOL)


def _fma_two_roundings(x, y, iters, chains):
    """The recurrence as float32 multiply then add: two roundings a step."""
    accs = [x * (1.0 + 0.1 * c) for c in range(chains)]
    for _ in range(iters):
        accs = [a * 1.0000001 + y for a in accs]
    return functools.reduce(torch.add, accs)


@pytest.mark.parametrize("chains", [1, 4, 8])
def test_fma_plain_rounds_once_as_the_jax_body_compiles(jax_vpu, chains):
    iters = 4096  # the tool's default
    rng = np.random.default_rng(5)
    x, y = (rng.uniform(size=(16, 8)).astype(np.float32) for _ in range(2))
    kern = functools.partial(jax_vpu._fma_kernel, iters, chains)
    want = _interpret({"kernel": kern, "out_shape": jax.ShapeDtypeStruct(
        (16, 8), jnp.float32)}, x, y)
    got = pk.fma_ceiling_plain(torch.as_tensor(x), torch.as_tensor(y), iters,
                               chains).numpy()
    np.testing.assert_array_equal(got, want)
    two = _fma_two_roundings(torch.as_tensor(x), torch.as_tensor(y), iters,
                             chains).numpy().astype(np.float64)
    gap = np.abs(two - want).max() / np.abs(want).max()
    assert 7e-5 <= gap <= 9e-5, gap


def test_smem_plain_is_2x_where_the_tpu_tail_is_undefined(monkeypatch,
                                                          jax_probe):
    x = np.random.default_rng(6).uniform(size=(8, 128)).astype(np.float32)
    got = pk.smem_probe_plain(torch.as_tensor(x), 227 * 1024)
    assert torch.equal(got, torch.as_tensor(2 * x))
    # the TPU body adds a scratch tail it never wrote: not 2 x
    seen = _record(monkeypatch, jax_probe, jax_probe.probe_vmem, 1)
    assert seen["scratch_shapes"][0].shape == (1024 * 1024 // 512, 128)
    tpu = _interpret(seen, x)
    assert tpu.shape == (8, 128) and not np.array_equal(tpu, 2 * x)


# --- the wrappers on the CPU -------------------------------------------------

def _cases():
    rng = np.random.default_rng(7)
    t = lambda *s: torch.as_tensor(rng.uniform(size=s).astype(np.float32))
    return [
        ("smem", pk.smem_probe, pk.smem_probe_plain, (t(8, 128), 48 * 1024)),
        ("transpose", pk.transpose_probe, pk.transpose_probe_plain,
         (t(32, 64), 3)),
        ("reshape", pk.reshape_probe, pk.reshape_probe_plain, (t(64, 32), 3)),
        ("matmul2", pk.matmul2_probe, pk.matmul2_probe_plain,
         (torch.as_tensor(_orthogonal(16, 8)), t(16, 64), 3)),
        ("dot3d", pk.dot3d_probe, pk.dot3d_probe_plain,
         (t(16, 16), t(4, 16, 8))),
        ("fma", pk.fma_ceiling, pk.fma_ceiling_plain, (t(16, 8), t(16, 8),
                                                       64, 4)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_wrapper_runs_plain_on_a_cpu_tensor_without_counting(case):
    key, wrapper, plain, args = _cases()[case]
    pk.reset_launches()
    assert torch.equal(wrapper(*args), plain(*args))
    assert pk.PROBE_LAUNCHES[key] == 0


@pytest.mark.parametrize("case", range(6))
def test_wrapper_refuses_other_devices(case):
    _, wrapper, _, args = _cases()[case]
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    with pytest.raises(ValueError, match="no path for device"):
        wrapper(*meta)


def test_wrappers_reject_bad_arguments():
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError):
        pk.smem_probe(x, 1000)
    with pytest.raises(ValueError):
        pk.smem_probe(x, 512)
    with pytest.raises(ValueError):
        pk.transpose_probe(torch.zeros(32, 32), 0)
    with pytest.raises(ValueError):
        pk.fma_ceiling(x, x, 4, 3)
    with pytest.raises(ValueError):
        pk.matmul2_probe(torch.eye(4), torch.zeros(4, 4), -1)


# the card tests' P4 shapes (tests/test_torch_probe_kernels.py) and the
# tools' (a, m, w)
CARD_DOT3D = [(a, m, w) for a in (1, 3, 128) for m in (8, 64, 128)
              for w in (4, 64, 128)] + [
                  (4, 16, 8), (3, 24, 8), (2, 96, 32), (2, 200, 8)]
PLANNED = [s for s in CARD_DOT3D + [(128, 128, 64), (2, 24, 8), (5, 72, 12)]
           if (s[1] // 8) * (s[2] // 4) <= 256]


@pytest.mark.parametrize("a,m,w", PLANNED)
def test_dot3d_plan_tiles_every_output_once(a, m, w):
    grid, threads, smem = pk.dot3d_plan(a, m, w)
    assert grid == a
    assert threads == (m // 8) * (w // 4) <= pk.SLAB_MAX_THREADS
    assert smem == 4 * (m + w) * m <= _gk._MAX_SMEM_BYTES
    # each block's threads own 8 x 4 tiles of its slice
    seen = torch.zeros((a, m, w), dtype=torch.int32)
    for b in range(grid):
        for t in range(threads):
            r0 = 8 * (t // (w // 4))
            c0 = 4 * (t % (w // 4))
            seen[b, r0:r0 + 8, c0:c0 + 4] += 1
    assert torch.equal(seen, torch.ones_like(seen))


def test_dot3d_plan_at_the_tools_shape():
    # one block a slice: 128 blocks of 256 threads and 96 KB
    assert pk.dot3d_plan(128, 128, 64) == (128, 256, 98304)
    # above 128 rows too: g and the slab of 200 rows in one block
    assert pk.dot3d_plan(2, 200, 8) == (2, 50, 4 * 208 * 200)


@pytest.mark.parametrize("a,m,w", [
    (1, 128, 128),   # 512 threads of 8 x 4
    (3, 12, 8),      # rows not a multiple of 8
    (3, 16, 6),      # columns not a multiple of 4
    (1, 8, 0),
    (1, 224, 32),    # m (m + 4) + m w floats above the opt-in
    (0, 16, 8),      # no slice
])
def test_dot3d_plan_rejects_what_the_probes_never_took(a, m, w):
    with pytest.raises(ValueError):
        pk.dot3d_plan(a, m, w)


# P2's plan: the tools' plane, the card tests' shapes and more
P2_SHAPES = [(128, 8192), (32, 64), (64, 32), (96, 96), (256, 1024),
             (32, 32 * 264), (864, 64)]


@pytest.mark.parametrize("rows,cols", P2_SHAPES)
def test_transpose_plan_owns_every_element_once(rows, cols):
    """A block a strip of w columns: the strips own every element of the
    plane once; w is 32 times a power of two and the narrowest whose
    blocks all find one of 132 SMs, among those whose strip and transpose
    fit a block's shared memory."""
    w, blocks, smem = pk.transpose_plan(rows, cols)
    assert w % 32 == 0 and (w // 32) & (w // 32 - 1) == 0
    assert smem == 4 * (rows * (w + 1) + w * (rows + 1))
    assert smem <= _gk._MAX_SMEM_BYTES
    owner = torch.full((rows, cols), -1)
    for b in range(blocks):
        strip = owner[:, b * w:(b + 1) * w]
        assert strip.shape == (rows, w) and (strip == -1).all()
        strip.fill_(b)
    assert (owner >= 0).all()
    narrower = w // 2
    assert (narrower < 32 or cols // narrower > 132
            or 4 * (rows * (narrower + 1) + narrower * (rows + 1))
            > _gk._MAX_SMEM_BYTES)


def test_transpose_plan_at_the_tools_shape():
    # 128 blocks of 64 columns: 32 KB of strip and 32 KB of its transpose
    assert pk.transpose_plan(128, 8192) == (64, 128, 66304)
    # more strips than SMs: the widest that fits, 3 x 132 blocks of 64
    assert pk.transpose_plan(256, 64 * 396) == (64, 396, 4 * (256 * 65
                                                              + 64 * 257))


@pytest.mark.parametrize("rows,cols,n", [(128, 8192, 3), (32, 64, 3),
                                         (64, 32, 1), (96, 96, 2)])
def test_strip_transposes_compose_to_the_plain_bits(rows, cols, n):
    """Each block's n iterations of t = s^T * 1.000001, s = t^T on its own
    strip, put side by side, are the plain version's bits: a strip never
    needs another strip."""
    x = torch.as_tensor(np.random.default_rng(9).random((rows, cols)),
                        dtype=torch.float32)
    w, blocks, _ = pk.transpose_plan(rows, cols)
    out = torch.empty_like(x)
    for b in range(blocks):
        s = x[:, b * w:(b + 1) * w].contiguous()
        for _ in range(n):
            t = torch.empty((w, rows))
            for c in range(w):  # column c of the strip is row c of t
                t[c] = s[:, c] * 1.000001
            s = torch.empty((rows, w))
            for c in range(w):
                s[:, c] = t[c]
        out[:, b * w:(b + 1) * w] = s
    assert torch.equal(out, pk.transpose_probe_plain(x, n))


@pytest.mark.parametrize("rows,cols,match", [
    (48, 32, "multiples of 32"), (32, 40, "multiples of 32"),
    (16, 64, "multiples of 32"), (1024, 64, "shared memory")])
def test_transpose_plan_refusals(rows, cols, match):
    with pytest.raises(ValueError, match=match):
        pk.transpose_plan(rows, cols)


# P5's plan at the tools' shape, the card tests' shapes and the row counts
# on either side of a 64-row tile: (m, n)
P5_PLANNED = [(128, 8192), (64, 1024), (16, 64), (8, 64), (100, 128),
              (1, 64), (128, 128), (64, 64), (65, 192), (63, 320)]


@pytest.mark.parametrize("m,n", P5_PLANNED)
def test_matmul2_plan_owns_every_column_once(m, n):
    """A block a strip of w columns across all rows: the strips own every
    column once; a warpgroup of 128 threads a 64-row tile of g, rows and
    k zero-padded to the tiles; two buffers of the strip's hi and lo
    planes within a block's shared memory."""
    w, blocks, threads, smem = pk.matmul2_plan(m, n)
    assert w == pk.MATMUL2_COLS and blocks * w == n
    tiles = -(-m // 64)
    assert threads == 128 * tiles and tiles * 64 >= m > (tiles - 1) * 64
    assert smem == 2 * 2 * w * 64 * tiles * 4 <= _gk._MAX_SMEM_BYTES
    owner = torch.full((n,), -1)
    for b in range(blocks):
        assert (owner[b * w:(b + 1) * w] == -1).all()
        owner[b * w:(b + 1) * w] = b
    assert (owner >= 0).all()


def test_matmul2_plan_at_the_tools_shape():
    # 128 blocks of two warpgroups on 64 columns: 128 KB of strip planes
    assert pk.matmul2_plan(128, 8192) == (64, 128, 256, 131072)
    # m <= 64: one warpgroup, k padded to 64
    assert pk.matmul2_plan(16, 64) == (64, 1, 128, 65536)


@pytest.mark.parametrize("m,n,match", [
    (129, 64, "rows"), (0, 64, "rows"), (256, 64, "rows"), (-1, 64, "rows"),
    (16, 40, "not a multiple"), (16, 32, "not a multiple"),
    (16, 0, "not a multiple"), (16, 96, "not a multiple"),
    (128, 8160, "not a multiple")])
def test_matmul2_plan_refusals(m, n, match):
    with pytest.raises(ValueError, match=match):
        pk.matmul2_plan(m, n)


# P3's plan: the tools' plane, the card tests' shapes, one past a wave
P3_PLANNED = [(8192, 128), (64, 32), (5, 7), (1001, 13), (3, 1), (1, 1),
              (4, 4), (1024, 1025)]


@pytest.mark.parametrize("rows,cols", P3_PLANNED)
@pytest.mark.parametrize("sms", [132, 7])
def test_reshape_plan_owns_every_element_once(rows, cols, sms):
    """At most 4 blocks an SM (one wave), no block without a float4 to
    take but the one a tail-only plane needs; block b owns the b-th of
    equal contiguous runs of the float4s, a thread every 256th float4 of
    its run; the tail past the last float4 is block 0's first threads'.
    Each element is owned once, and a thread takes at most the plan's
    elements."""
    n = rows * cols
    per_thread, blocks, threads = pk.reshape_plan(n, sms)
    n4 = n // 4
    assert threads == 256 and 1 <= blocks <= 4 * sms
    assert blocks == 1 or (blocks - 1) * 256 < n4
    run = -(-n4 // blocks)
    owned = torch.zeros(n, dtype=torch.int32)
    most = 0
    for b in range(blocks):
        first, end = b * run, min((b + 1) * run, n4)
        # thread t takes first + t, first + t + 256, ...: each float4 of the
        # run once, at most ceil(run / 256) a thread
        most = max(most, -(-max(0, end - first) // threads))
        owned[4 * first:4 * max(first, end)] += 1
    owned[4 * n4:] += 1  # the tail, block 0's threads 0 .. n % 4 - 1
    assert (owned == 1).all()
    assert per_thread == 4 * max(1, most)


def test_reshape_plan_at_the_tools_shape():
    # 4 blocks on each of 132 SMs, 497 float4s a block: 2 a thread
    assert pk.reshape_plan(8192 * 128) == (8, 528, 256)
    assert pk.reshape_plan(8192 * 128, 66) == (16, 264, 256)


@pytest.mark.parametrize("n", [0, -4])
def test_reshape_plan_refuses_an_empty_plane(n):
    with pytest.raises(ValueError, match="non-empty"):
        pk.reshape_plan(n)


@pytest.fixture
def no_library(monkeypatch):
    """Fail on any attempt to build or load the kernels' library."""
    def refuse():
        raise AssertionError("a CPU call reached the CUDA library")
    monkeypatch.setattr(_gk, "_library", refuse)


@pytest.mark.parametrize("a,m,w", [s for s in PLANNED if s[0] < 128])
def test_dot3d_wrapper_on_the_cpu_is_plain(no_library, a, m, w):
    rng = np.random.default_rng(a + m + w)
    g = torch.as_tensor(rng.normal(size=(m, m)).astype(np.float32))
    x = torch.as_tensor(rng.uniform(size=(a, m, w)).astype(np.float32))
    pk.reset_launches()
    assert torch.equal(pk.dot3d_probe(g, x), pk.dot3d_probe_plain(g, x))
    assert not any(pk.PROBE_LAUNCHES.values())


@pytest.mark.parametrize("cluster", [1, 2, 16])
@pytest.mark.parametrize("nbytes", [8 * 1024, 48 * 1024, 227 * 1024])
def test_smem_wrapper_on_the_cpu_is_plain(no_library, nbytes, cluster):
    x = torch.as_tensor(np.random.default_rng(cluster).uniform(
        size=(8, 128)).astype(np.float32))
    pk.reset_launches()
    fits = dict(pk._SMEM_FITS)
    assert torch.equal(pk.smem_probe(x, nbytes, cluster), x + x)
    assert not any(pk.PROBE_LAUNCHES.values()) and pk._SMEM_FITS == fits


# --- the kernels' arithmetic: in order over k, one rounding a term ----------

def _to_f32(q: Fraction) -> np.float32:
    """The rational q rounded to the nearest float32, ties to even."""
    f = np.float32(float(q))
    cands = (f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.array(v).view(np.int32)) & 1))


def test_in_order_matmul_is_the_exact_in_order_fma_sum():
    rng = np.random.default_rng(9)
    g = rng.normal(size=(16, 16)).astype(np.float32)
    x = rng.uniform(-1, 1, size=(2, 16, 8)).astype(np.float32)
    want = np.zeros((2, 16, 8), np.float32)
    for idx in np.ndindex(want.shape):
        acc = np.float32(0)
        for k in range(16):
            acc = _to_f32(Fraction(float(g[idx[1], k]))
                          * Fraction(float(x[idx[0], k, idx[2]]))
                          + Fraction(float(acc)))
        want[idx] = acc
    got = pk.in_order_matmul(torch.as_tensor(g), torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    got2 = pk.in_order_matmul(torch.as_tensor(g), torch.as_tensor(x[1]))
    np.testing.assert_array_equal(got2.numpy(), want[1])


def test_in_order_matmul_rounds_once_where_float64_rounds_twice():
    # fmaf(a, b, c) with a b = 2^-24 - 2^-70 and c = 1 + 2^-23: the float64
    # sum lands on the midpoint 1 + 2^-23 + 2^-24 and rounds to even,
    # 1 + 2^-22; the exact sum lies below it and rounds to 1 + 2^-23
    a, b = 1 + 2.0**-23, 2.0**-24 * (1 - 2.0**-23)
    c = 1 + 2.0**-23
    g = torch.tensor([[1.0, a], [0.0, 0.0]])
    x = torch.tensor([[c], [b]])
    assert pk.in_order_matmul(g, x)[0, 0].item() == 1 + 2.0**-23
    twice = (torch.tensor(a).double() * b + c).float().item()
    assert twice == 1 + 2.0**-22


def test_in_order_matmul_matches_plain_within_the_slab_tolerance():
    rng = np.random.default_rng(10)
    g = torch.as_tensor(rng.normal(size=(128, 128)).astype(np.float32))
    x = torch.as_tensor(rng.uniform(size=(4, 128, 64)).astype(np.float32))
    _assert_rel(pk.in_order_matmul(g, x).numpy(),
                pk.dot3d_probe_plain(g, x).numpy(), SLAB_TOL)


def test_counters_cover_every_probe():
    assert set(pk.PROBE_LAUNCHES) == {"smem", "transpose", "reshape",
                                      "matmul2", "dot3d", "fma"}
    pk.PROBE_LAUNCHES["fma"] = 3
    pk.reset_launches()
    assert not any(pk.PROBE_LAUNCHES.values())


# --- the tools' entry points -------------------------------------------------

def test_vpu_ceiling_main_on_the_cpu(capsys):
    recs = vpu_ceiling.main(["--device", "cpu", "--d", "16", "--batch", "8",
                             "--iters", "64"])
    assert [(r["batch"], r["chains"]) for r in recs] == [
        (b, c) for b in (8, 128) for c in (1, 4, 8)]
    for r in recs:
        assert r["device"] == "cpu" and r["card"] is None
        assert r["wall_us"] > 0 and r["gflops"] > 0
    assert capsys.readouterr().out.count('"gflops"') == 6


def test_wide_probe_main_on_the_cpu(capsys):
    res = wide_probe.main(["--device", "cpu", "--n-iters", "2"])
    out = capsys.readouterr().out
    assert "not probed on the CPU" in out and "us/transpose" in out
    assert res["dot3d_ok"] and "smem_kb" not in res
    for key in ("transpose_us", "reshape_us", "matmul_us", "dot3d_us",
                "library_matmul_us"):
        assert res[key] > 0


@pytest.mark.parametrize("tool", [vpu_ceiling, wide_probe])
def test_tools_default_to_the_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main([])


def test_wgmma_rate_counts_the_plans_instructions():
    # the tools' shape: 128 blocks of two warpgroups, each 3 wgmma
    # m64n64k8 for each of 16 k-steps: 12,288 a product, one block an SM
    t = 12288 / (1980e6 * 128)
    rate, mma = wide_probe.wgmma_rate(t, clock_mhz=1980.0, sms=132)
    assert rate == pytest.approx(1.0) and mma == pytest.approx(32.0)
    # on fewer SMs than blocks the blocks share them
    rate, _ = wide_probe.wgmma_rate(t, clock_mhz=1980.0, sms=64)
    assert rate == pytest.approx(2.0)


def test_wide_probe_helpers_on_the_cpu():
    assert wide_probe.probe_smem(227, 16, device="cpu")
    q = wide_probe.orthogonal(16, "cpu").double()
    torch.testing.assert_close(q @ q.T, torch.eye(16, dtype=torch.float64)
                               * 0.9999**2, atol=1e-6, rtol=0)
    g, x, out, t = wide_probe.probe_dot3d(reps=1, device="cpu")
    assert out.shape == (128, 128, 64) and t > 0
    torch.testing.assert_close(out, pk.dot3d_probe_plain(g, x))
