"""The ceiling probes' CUDA kernels (``csrc/probes.cu``) against their plain
PyTorch versions on the card, at the tools' default shapes and at small
ones; P4 at every (a, m, w) of a in {1, 3, 128}, m in {8, 64, 128}, w in
{4, 64, 128} (m = w = 128 is refused: 512 threads of 8 x 4) and where k is
staged in 3 and 25 chunks; P4 against ``probe_kernels.in_order_matmul``
bit for bit, call after call; P5 (3xTF32 on the tensor cores) at the tools'
shape, at m in {1, 8, 16, 64, 100} and at its plan's 32-column strip,
within its tolerance and the same bits call after call; P3 bit for bit,
with and without a tail;
P1 at 8 KB, 48 KB and the opt-in, alone and in clusters of 2 and 16, and
its boundary at the card's opt-in shared memory; the launch counters.

Every test here carries the ``cuda`` marker and skips without a card.
This file does not import JAX, so on the card's machine it runs with
``python -m pytest tests/test_torch_probe_kernels.py -m cuda
--noconftest``.

Tolerances, relative to max(1, max|plain|): P2 and P3 exactly the plain
version's bits (the same __fmul_rn roundings in the same order, nothing
else rounds), P4 1e-5 (128-term float32 sums in another order), P5 5e-5
(3xTF32 products whose large terms the tensor cores sum toward zero; the
CPU emulation of its arithmetic, tests/test_torch_probe_tf32.py, lies
9.7e-6 from plain at the tools' shape cut to 512 columns), the FMA probe
1e-5 (the plain version rounds once a step, as the FMA does, through
float64); P1 exactly 2 x; P4 exactly the in-order FMA sum.
"""

import pytest
import torch

from qiddm_tpu_torch.tools import probe_kernels as pk
from qiddm_tpu_torch.tools import wide_probe

SLAB_TOL = 1e-5
TF32_TOL = 5e-5
FMA_TOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _rand(dev, *shape, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=dev)


def _assert_rel(got, want, tol):
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


def _optin(dev) -> int:
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


@pytest.mark.parametrize("kb,cluster", [
    (8, 1), (48, 1), (48, 4), (100, 2), (8, 2), (8, 16), (48, 2), (48, 16),
    ("optin", 1), ("optin", 2), ("optin", 16)])
def test_smem_kernel_gives_2x(cuda, kb, cluster):
    # cluster 1 is a plain launch, above it a cluster launch
    nbytes = (_optin(cuda) // pk.ROW_BYTES * pk.ROW_BYTES if kb == "optin"
              else kb * 1024)
    x = _rand(cuda, 8, 128, seed=cluster)
    for _ in range(2):  # the second call reuses the shape's capacity answer
        out = pk.smem_probe(x, nbytes, cluster)
        assert out is not None and torch.equal(out, x + x)


@pytest.mark.parametrize("cluster", [1, 2, 16])
def test_smem_boundary_is_the_cards_optin(cuda, cluster):
    top = _optin(cuda) // pk.ROW_BYTES * pk.ROW_BYTES
    x = _rand(cuda, 8, 128)
    out = pk.smem_probe(x, top, cluster)
    assert out is not None and torch.equal(out, x + x)
    assert pk.smem_probe(x, top + pk.ROW_BYTES, cluster) is None


def test_smem_sweep_stops_at_the_optin(cuda):
    fits = [kb * 1024 for kb in wide_probe.SMEM_KB
            if wide_probe.probe_smem(kb, 1, cuda)]
    assert max(fits) == _optin(cuda)
    assert fits == [kb * 1024 for kb in wide_probe.SMEM_KB
                    if kb * 1024 <= _optin(cuda)]


@pytest.mark.parametrize("shape,n", [((128, 8192), 50), ((32, 64), 3),
                                     ((64, 32), 1), ((96, 96), 2),
                                     ((864, 64), 2), ((32, 32 * 264), 3),
                                     ((256, 64 * 396), 2)])
def test_transpose_kernel_matches_plain(cuda, shape, n):
    """P2 at the tools' shape and at its plan's edges (the tallest strip
    that fits, exactly 132 strips, more strips than SMs): the plain
    version's bits."""
    x = _rand(cuda, *shape)
    got = pk.transpose_probe(x, n)
    torch.cuda.synchronize()
    assert torch.equal(got, pk.transpose_probe_plain(x, n))


@pytest.mark.parametrize("shape,n", [((8192, 128), 50), ((64, 32), 3),
                                     ((5, 7), 0), ((5, 7), 4),
                                     ((1001, 13), 7), ((3, 1), 2)])
def test_reshape_kernel_matches_plain(cuda, shape, n):
    """P3 at the tools' shape and at small ones, (5, 7), (1001, 13) and
    (3, 1) with a tail past the last float4: the plain version's bits."""
    x = _rand(cuda, *shape)
    got = pk.reshape_probe(x, n)
    torch.cuda.synchronize()
    assert torch.equal(got, pk.reshape_probe_plain(x, n))


@pytest.mark.parametrize("m,n,iters", [(128, 8192, 50), (64, 1024, 10),
                                       (16, 64, 3), (8, 64, 2),
                                       (100, 128, 5), (1, 64, 2),
                                       (128, 128, 0)])
def test_matmul2_kernel_matches_plain(cuda, m, n, iters):
    g = wide_probe.orthogonal(m, cuda, seed=1)
    x = _rand(cuda, m, n, seed=2)
    got = pk.matmul2_probe(g, x, iters)
    _assert_rel(got, pk.matmul2_probe_plain(g, x, iters), TF32_TOL)
    # no atomics, a fixed order: the same bits on every call
    assert torch.equal(pk.matmul2_probe(g, x, iters), got)


# small shapes whose k is staged in 2, 3, 3 and 25 chunks, and every
# (a, m, w) of the card's grid, the tools' among them
@pytest.mark.parametrize("a,m,w", [
    (4, 16, 8), (3, 24, 8), (2, 96, 32), (2, 200, 8)] + [
    (a, m, w) for a in (1, 3, 128) for m in (8, 64, 128) for w in (4, 64, 128)])
def test_dot3d_kernel_matches_plain(cuda, a, m, w):
    g = torch.randn((m, m), generator=torch.Generator().manual_seed(m + w))
    g, x = g.to(cuda), _rand(cuda, a, m, w, seed=a)
    if (m // pk.SLAB_ROWS) * (w // pk.SLAB_COLS) > pk.SLAB_MAX_THREADS:
        with pytest.raises(ValueError, match="at most"):
            pk.dot3d_probe(g, x)
        return
    got = pk.dot3d_probe(g, x)
    _assert_rel(got, pk.dot3d_probe_plain(g, x), SLAB_TOL)
    # the sum over k in order from zero, one FMA a term, on every call
    assert torch.equal(got, pk.in_order_matmul(g, x))
    assert torch.equal(pk.dot3d_probe(g, x), got)


@pytest.mark.parametrize("chains", [1, 4, 8])
@pytest.mark.parametrize("d,b,iters", [(1024, 80, 4096), (1024, 128, 4096),
                                       (16, 8, 64)])
def test_fma_kernel_matches_plain(cuda, d, b, iters, chains):
    x, y = _rand(cuda, d, b, seed=5), _rand(cuda, d, b, seed=6)
    _assert_rel(pk.fma_ceiling(x, y, iters, chains),
                pk.fma_ceiling_plain(x, y, iters, chains), FMA_TOL)


def test_each_launch_counts_once(cuda):
    x8 = _rand(cuda, 8, 128)
    x = _rand(cuda, 64, 32)
    g = wide_probe.orthogonal(16, cuda)
    calls = {
        "smem": lambda: pk.smem_probe(x8, 48 * 1024),
        "transpose": lambda: pk.transpose_probe(x, 2),
        "reshape": lambda: pk.reshape_probe(x, 2),
        "matmul2": lambda: pk.matmul2_probe(g, _rand(cuda, 16, 64), 2),
        "dot3d": lambda: pk.dot3d_probe(g, _rand(cuda, 2, 16, 8)),
        "fma": lambda: pk.fma_ceiling(x, x, 8, 4),
    }
    for key, call in calls.items():
        before = dict(pk.PROBE_LAUNCHES)
        call()
        after = dict(pk.PROBE_LAUNCHES)
        assert after[key] == before[key] + 1
        assert all(after[k] == before[k] for k in after if k != key)
    before = pk.PROBE_LAUNCHES["smem"]
    assert pk.smem_probe(x8, 1024 * 1024) is None  # refused: not launched
    assert pk.PROBE_LAUNCHES["smem"] == before


def test_kernels_raise_on_bad_cuda_inputs(cuda):
    x = _rand(cuda, 64, 32)
    with pytest.raises(ValueError, match="multiples of 32"):
        pk.transpose_probe(_rand(cuda, 48, 32), 1)
    with pytest.raises(ValueError, match="shared memory"):
        pk.transpose_probe(_rand(cuda, 1024, 64), 1)
    with pytest.raises(ValueError, match="contiguous float32"):
        pk.reshape_probe(x.t(), 1)
    with pytest.raises(ValueError, match="same CUDA device"):
        pk.fma_ceiling(x, x.cpu(), 4, 1)
    with pytest.raises(ValueError, match="not a multiple"):
        pk.matmul2_probe(wide_probe.orthogonal(16, cuda), _rand(cuda, 16, 40),
                         1)
    with pytest.raises(ValueError, match="rows"):
        pk.matmul2_probe(wide_probe.orthogonal(136, cuda),
                         _rand(cuda, 136, 64), 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.reshape_probe(torch.empty(1 + 64, device=cuda)[1:].view(8, 8), 1)
    shifted = torch.empty(1 + 2 * 16 * 8, device=cuda)[1:].view(2, 16, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.dot3d_probe(wide_probe.orthogonal(16, cuda), shifted)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.smem_probe(torch.empty(1 + 8 * 128, device=cuda)[1:].view(8, 128),
                      48 * 1024)
    with pytest.raises(ValueError, match="shared memory a block"):
        pk.dot3d_probe(wide_probe.orthogonal(256, cuda),
                       _rand(cuda, 1, 256, 4))
