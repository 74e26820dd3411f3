"""The arithmetic of P5's tensor-core kernel (``probe_matmul2_kernel`` of
``qiddm_tpu_torch/csrc/probes.cu``) emulated on the CPU in plain torch, and
held to the plain version and to the JAX probe body.

The kernel splits every operand v into TF32 hi = tf32(v) and
lo = tf32(v - hi) (round to nearest, ties away from zero) and forms g x
from three wgmma products a k-step of 8: the small terms g_lo x_hi and
g_hi x_lo chained in one accumulator over all of k, and the large term
g_hi x_hi chained over runs of ``probe_kernels.MATMUL2_RUN`` k-steps, each
run from zero in an accumulator of its own; the runs are added in order in
float32, then the small terms. Rows and k past m are zero up to 64 ceil(m /
64). The tensor cores round a step's sum toward zero; the emulation models
a k-step as the exact sum of the accumulator and its 8 products (float64:
products of TF32 values and their sums are exact there at these sizes)
rounded once toward zero to float32. The card may round each step a little
worse than that model, so the run is the longest whose emulated error at
the tools' shape stays within a quarter of P5's tolerance, ``TF32_TOL`` =
5e-5 relative to max(1, max|plain|) (the card's, in ``chip_smoke.py`` and
``tests/test_torch_probe_kernels.py``; the reference holds its kernels to
2e-4): the whole product chained (16 steps) lies 1.8e-5 from the plain
version, runs of 8 lie 9.7e-6.

The emulation runs at (128, 128) @ (128, 512) x 50 (the tools' shape cut
to 512 columns: columns are independent) and at (16, 64) x 3, against
``matmul2_probe_plain`` and against the JAX body of
``tools/bench_pallas_wide_probe.py::probe_matmul2`` in Pallas interpret
mode, recorded as ``tests/test_torch_probes.py`` records it.
"""

import importlib.util
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from qiddm_tpu_torch.tools import probe_kernels as pk

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
TF32_TOL = 5e-5
SHAPES = [(128, 512, 50), (16, 64, 3)]  # (m, n, n_iters)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: the kernel's ``tf32_bits``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _toward_zero(s: torch.Tensor) -> torch.Tensor:
    """float64 sums rounded toward zero to float32."""
    f = s.float()
    away = f.double().abs() > s.abs()
    return torch.where(away, torch.nextafter(f, torch.zeros_like(f)), f)


SMALL_TERMS = ("g_lo x_hi", "g_hi x_lo")


def emulated_product(g: torch.Tensor, x: torch.Tensor,
                     run: int = pk.MATMUL2_RUN,
                     small_terms=SMALL_TERMS) -> torch.Tensor:
    """One g @ x as the kernel forms it, with large-term runs of ``run``
    8-deep k-steps and the small terms named in ``small_terms``."""
    m, n = x.shape
    k = pk.MATMUL2_ROW_TILE * -(-m // pk.MATMUL2_ROW_TILE)
    gp = torch.zeros((k, k), dtype=torch.float32)
    gp[:m, :m] = g
    xp = torch.zeros((k, n), dtype=torch.float32)
    xp[:m] = x
    g_hi, g_lo = (t.double() for t in _split(gp))
    x_hi, x_lo = (t.double() for t in _split(xp))
    small = torch.zeros((k, n), dtype=torch.float32)
    runs = []
    for s in range(k // 8):
        ks = slice(8 * s, 8 * s + 8)
        if "g_lo x_hi" in small_terms:
            small = _toward_zero(small.double() + g_lo[:, ks] @ x_hi[ks])
        if "g_hi x_lo" in small_terms:
            small = _toward_zero(small.double() + g_hi[:, ks] @ x_lo[ks])
        if s % run == 0:
            runs.append(torch.zeros((k, n), dtype=torch.float32))
        runs[-1] = _toward_zero(runs[-1].double() + g_hi[:, ks] @ x_hi[ks])
    out = runs[0]
    for r in runs[1:]:
        out = out + r
    return (out + small)[:m]


def emulated_probe(g, x, n_iters: int, run: int = pk.MATMUL2_RUN,
                   small_terms=SMALL_TERMS):
    for _ in range(n_iters):
        x = emulated_product(g, x, run, small_terms)
    return x


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _inputs(m, n, seed=2):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(m, m)))
    g = (q * 0.9999).astype(np.float32)
    x = np.random.default_rng(seed + 1).uniform(size=(m, n)).astype(
        np.float32)
    return torch.as_tensor(g), torch.as_tensor(x)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The emulation is thousands of small float64 ops: run them on one
    thread. Beside other test processes, a thread pool in each
    oversubscribes the cores and slows them a hundredfold. Their sums are
    exact, so the thread count does not change a result."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def emulated():
    """{(m, n, n_iters): (g, x, the emulated probe)} at ``SHAPES``."""
    out = {}
    for m, n, iters in SHAPES:
        g, x = _inputs(m, n)
        out[m, n, iters] = g, x, emulated_probe(g, x, iters)
    return out


# --- the split and the model's rounding -------------------------------------

def test_split_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0**-11  # halfway between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 2.0**-12, 3.0, 1.0 - 2.0**-12],
                     dtype=torch.float32)
    hi, lo = _split(x)
    assert hi.tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 3.0, 1.0]
    assert lo.tolist() == [-2.0**-11, 2.0**-11, 2.0**-12, 0.0, -2.0**-12]
    # a tie in the low half too: x - hi = 2^-12 (1 + 2^-11) rounds away
    y = torch.tensor([1.0 + 2.0**-12 + 2.0**-23, -1.0 - 2.0**-12 - 2.0**-23],
                     dtype=torch.float32)
    hi, lo = _split(y)
    assert hi.tolist() == [1.0, -1.0]
    assert lo.tolist() == [2.0**-12 * (1 + 2.0**-10),
                           -(2.0**-12) * (1 + 2.0**-10)]


def test_split_halves_are_tf32_and_sum_to_x():
    y = torch.as_tensor(np.random.default_rng(0).normal(size=4096),
                        dtype=torch.float32)
    hi, lo = _split(y)
    for half in (hi, lo):
        assert ((half.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi.double() + lo.double() - y.double()).abs()
            <= 2.0**-22 * y.double().abs()).all()


def test_step_rounding_is_toward_zero():
    s = torch.tensor([1.0 + 2.0**-30, -(1.0 + 2.0**-30), 1.0 - 2.0**-30,
                      0.5], dtype=torch.float64)
    assert _toward_zero(s).tolist() == [1.0, -1.0, 1.0 - 2.0**-24, 0.5]


def test_emulated_product_pads_rows_and_k_with_zeros():
    g, x = _inputs(16, 64)
    got = emulated_product(g, x)
    assert got.shape == (16, 64)
    # a product of TF32 values needs no split: the large term alone
    gt, xt = _tf32(g), _tf32(x)
    want = (gt.double() @ xt.double()).float()
    assert _rel(emulated_product(gt, xt), want) <= 2.0**-22


# --- the emulation against the plain version and the JAX body --------------

@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_holds_the_plain_version(emulated, shape):
    g, x, got = emulated[shape]
    assert _rel(got, pk.matmul2_probe_plain(g, x, shape[2])) <= TF32_TOL


def _jax_body(monkeypatch, m, n, iters):
    spec = importlib.util.spec_from_file_location(
        "_tpu_bench_pallas_wide_probe", TOOLS / "bench_pallas_wide_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}

    def pallas_call(kernel, out_shape, **_):
        seen.update(kernel=kernel, out_shape=out_shape)
        return lambda *a: jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        pallas_call=pallas_call, BlockSpec=lambda *a, **k: None))
    mod.probe_matmul2(n_iters=iters, m=m, n=n)
    return seen


@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_holds_the_jax_body(monkeypatch, emulated, shape):
    g, x, got = emulated[shape]
    seen = _jax_body(monkeypatch, *shape)
    assert seen["out_shape"].shape == shape[:2]
    want = np.asarray(pl.pallas_call(seen["kernel"],
                                     out_shape=seen["out_shape"],
                                     interpret=True)(g.numpy(), x.numpy()))
    assert _rel(got, want) <= TF32_TOL


def test_run_is_the_longest_within_a_quarter_of_the_tolerance(emulated):
    """The run length the kernel chains: its emulated error at the tools'
    shape within TF32_TOL / 4, the whole product chained (twice the run,
    all 16 steps) not."""
    m, n, iters = SHAPES[0]
    g, x, got = emulated[m, n, iters]
    plain = pk.matmul2_probe_plain(g, x, iters)
    assert _rel(got, plain) <= TF32_TOL / 4
    whole = emulated_probe(g, x, iters, run=2 * pk.MATMUL2_RUN)
    assert 2 * pk.MATMUL2_RUN == m // 8
    assert _rel(whole, plain) > TF32_TOL / 4


@pytest.mark.parametrize("small_terms", [(), SMALL_TERMS[:1],
                                         SMALL_TERMS[1:]])
def test_tolerance_fails_a_kernel_of_less_precision(emulated, small_terms):
    """TF32_TOL tells 3xTF32 from less: at the tools' shape, the product
    as 1xTF32 (the large term alone) and as 3xTF32 with either small term
    dropped each lie more than TF32_TOL from the plain version."""
    m, n, iters = SHAPES[0]
    g, x, _ = emulated[m, n, iters]
    less = emulated_probe(g, x, iters, small_terms=small_terms)
    assert _rel(less, pk.matmul2_probe_plain(g, x, iters)) > TF32_TOL


def test_kernel_constants_match_the_emulation():
    src = (pathlib.Path(pk.__file__).resolve().parents[1] / "csrc"
           / "probes.cu").read_text()
    assert f"constexpr int kRun = {pk.MATMUL2_RUN};" in src
    assert f"constexpr int kRowTile = {pk.MATMUL2_ROW_TILE};" in src
    assert f"constexpr int kCols = {pk.MATMUL2_COLS};" in src
