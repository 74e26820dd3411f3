"""Ceiling probes on the card for the wide-regime kernels (counterpart of
the TPU's ``tools/bench_pallas_wide_probe.py``).

Answers, on the card, the questions the redesigns of the wide-chain and
per-sample kernels depend on:

  P1. How much shared memory can one block hold, and one thread-block
      cluster (distributed shared memory)? The TPU asked the same of VMEM.
  P2. What does a transpose of a (128, 8192) float32 plane cost? No SM
      holds the 4 MiB plane, but the grid's shared memory does: each block
      holds a column strip and its transpose and runs every transpose of
      the loop in its own shared memory (one plain launch, no grid-wide
      barrier), as the TPU runs them in VMEM.
  P3. What does a relayout reshape (8192, 128) -> (128, 8192) cost? On the
      card a row-major reshape of a contiguous plane is free (the flat index
      does not change), so the kernel does what remains, the two scales a
      step; "per reshape" is half a step of that, as the TPU tool counts.
  P4. Does a contraction on the middle axis of a 3-D operand run (on the
      TPU a question of Mosaic's lowering)? Here it always runs; ``ok``
      means its output matched the plain version.
  P5. The group product of a 20-wire state: (128, 128) @ (128, 8192) to
      float32 accuracy as 3xTF32 on the tensor cores (wgmma), beside cuBLAS
      (``torch.matmul``, TF32 off) on the same inputs; on the card also the
      rate at which the kernel issues its TF32 wgmma instructions, a clock
      an SM, and that rate in mma.sync m16n8k8 instructions of the same
      work (the unit of ``csrc/wide_chain.cu``'s measured 0.25).

Times are medians of CUDA-event times of one call over 20 calls, after a
warm-up, each behind a spin kernel that hides the host's enqueue
(``common.median_ms``), with the card's name and power limit. ``--device cpu``
runs the plain versions on the host clock (for the tests; no device
figure) and skips P1, which is a property of the card.

Usage: python -m qiddm_tpu_torch.tools.wide_probe [--n-iters 50]
    [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from .. import config
from . import common
from . import probe_kernels as pk

KB = 1024
MiB = 1024 * 1024
# P1's sweep of scratch sizes a block, KB, around the H100's 227 KB opt-in
SMEM_KB = (48, 96, 160, 200, 224, 227, 228, 232)
CLUSTERS = (1, 2, 4, 8, 16)
SHAPE = (128, 8192)        # P2's plane, P5's x: one 7-bit group of 2^20
DOT3D_SHAPE = (128, 128, 64)
DOT3D_TOL = 1e-5           # relative: 128-term float32 sums in two orders
SEED = 0


def _device(device) -> torch.device:
    return config.resolve_device("cuda" if device is None else device)


def _uniform(shape, dev, seed=SEED):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=dev)


def orthogonal(m: int, dev, seed=SEED) -> torch.Tensor:
    """A seeded (m, m) orthogonal matrix times 0.9999 (QR on the CPU), so
    that repeated products stay bounded."""
    gen = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((m, m), generator=gen,
                                       dtype=torch.float64))
    return (q * 0.9999).to(torch.float32).contiguous().to(dev)


def probe_smem(size_kb: int, cluster: int = 1, device=None) -> bool:
    """P1: whether a scratch of ``size_kb`` KB a block, in a cluster of
    ``cluster`` blocks, runs. False only when the card refuses the shape;
    an error, or an output other than 2 x, raises."""
    dev = _device(device)
    x = _uniform((8, 128), dev)
    out = pk.smem_probe(x, size_kb * KB, cluster)
    if out is None:
        return False
    if not torch.equal(out, x + x):
        raise RuntimeError(f"P1 at {size_kb} KB x {cluster}: the scratch "
                           f"gave back {out.flatten()[:4].tolist()}, not "
                           f"2 x")
    return True


def probe_transpose(n_iters: int = 50, reps: int = 20, device=None) -> float:
    """P2: seconds a transpose (two a step)."""
    dev = _device(device)
    x = _uniform(SHAPE, dev)
    ms = common.median_ms(lambda: pk.transpose_probe(x, n_iters), dev, reps)
    return 1e-3 * ms / (2 * n_iters)


def probe_reshape(n_iters: int = 50, reps: int = 20, device=None) -> float:
    """P3: seconds a reshape (two a step)."""
    dev = _device(device)
    x = _uniform(SHAPE[::-1], dev)
    ms = common.median_ms(lambda: pk.reshape_probe(x, n_iters), dev, reps)
    return 1e-3 * ms / (2 * n_iters)


def probe_matmul2(n_iters: int = 50, m: int = 128, n: int = 8192,
                  reps: int = 20, device=None) -> tuple[float, float]:
    """P5: seconds a product on the kernel, and with n_iters torch.matmul
    calls (cuBLAS on the card, TF32 off) on the same inputs."""
    dev = _device(device)
    g, x = orthogonal(m, dev), _uniform((m, n), dev)
    ms = common.median_ms(lambda: pk.matmul2_probe(g, x, n_iters), dev, reps)
    lib_ms = common.median_ms(
        lambda: pk.matmul2_probe_plain(g, x, n_iters), dev, reps)
    return 1e-3 * ms / n_iters, 1e-3 * lib_ms / n_iters


def wgmma_rate(seconds: float, m: int = 128, n: int = 8192,
               clock_mhz: float = 1980.0, sms: int = 132) -> tuple[float,
                                                                   float]:
    """P5's TF32 wgmma instructions issued a clock an SM at ``seconds`` a
    product, over the SMs that run a block (one block an SM), and the
    same work in mma.sync m16n8k8 instructions a clock an SM. Each
    warpgroup issues 3 wgmma m64nWk8 an 8-deep k-step of its 64
    ceil(m / 64) k (``probe_kernels.matmul2_plan``)."""
    w, blocks, threads, _ = pk.matmul2_plan(m, n)
    k = pk.MATMUL2_ROW_TILE * (threads // 128)
    issued = blocks * (threads // 128) * 3 * (k // 8)
    rate = issued / (seconds * clock_mhz * 1e6 * min(blocks, sms))
    return rate, rate * (64 * w) / (16 * 8)


def probe_dot3d(reps: int = 20, device=None):
    """P4: (g, x, out, seconds of one call) on seeded inputs."""
    dev = _device(device)
    m = DOT3D_SHAPE[1]
    g = torch.randn((m, m), generator=torch.Generator().manual_seed(SEED))
    g, x = g.to(dev), _uniform(DOT3D_SHAPE, dev)
    out = pk.dot3d_probe(g, x)
    ms = common.median_ms(lambda: pk.dot3d_probe(g, x), dev, reps)
    return g, x, out, 1e-3 * ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-iters", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    res = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"), "card": common.card(dev)}
    print(f"device: {res['device']} ({res['card']})")
    if dev.type == "cuda":
        print("P1: shared memory a block (dynamic scratch)")
        res["smem_kb"] = {}
        for kb in SMEM_KB:
            ok = probe_smem(kb, 1, dev)
            res["smem_kb"][kb] = ok
            print(f"    {kb:4d} KB: {'ok' if ok else 'FAIL'}")
        fits = [kb for kb, ok in res["smem_kb"].items() if ok]
        top = max(fits) if fits else None
        res["smem_max_kb"] = top
        res["cluster"] = {}
        if top is not None:
            print(f"P1: thread-block clusters of {top} KB blocks "
                  f"(distributed shared memory)")
            for c in CLUSTERS:
                ok = probe_smem(top, c, dev)
                res["cluster"][c] = ok
                print(f"    {c:2d} x {top} KB = {c * top:5d} KB: "
                      f"{'ok' if ok else 'FAIL'}")
    else:
        print("P1: a property of the card; not probed on the CPU")
    print(f"P2: in-kernel transpose {SHAPE} f32")
    t = probe_transpose(args.n_iters, device=dev)
    res["transpose_us"] = 1e6 * t
    print(f"    {t * 1e6:8.1f} us/transpose ({4 * MiB / t / 1e9:.0f} GB/s eff)")
    print(f"P3: relayout reshape {SHAPE[::-1]}->{SHAPE} (free on the card: "
          f"the two scales a step remain)")
    t = probe_reshape(args.n_iters, device=dev)
    res["reshape_us"] = 1e6 * t
    print(f"    {t * 1e6:8.1f} us/reshape ({4 * MiB / t / 1e9:.0f} GB/s eff)")
    print(f"P5: in-kernel matmul (128,128)@{SHAPE} f32 highest, 3xTF32 on "
          f"the tensor cores (wgmma)")
    t, t_lib = probe_matmul2(args.n_iters, device=dev)
    flops = 2 * 128 * 128 * 8192
    res.update(matmul_us=1e6 * t, matmul_gflops=flops / t / 1e9,
               library_matmul_us=1e6 * t_lib,
               library_matmul_gflops=flops / t_lib / 1e9)
    print(f"    {t * 1e6:8.1f} us/matmul ({flops / t / 1e9:.0f} GFLOP/s of "
          f"float32-accurate product, {3 * flops / t / 1e9:.0f} of TF32); "
          f"torch.matmul {t_lib * 1e6:8.1f} us/matmul "
          f"({flops / t_lib / 1e9:.0f} GFLOP/s)")
    if dev.type == "cuda":
        clock = common.max_sm_clock_mhz(dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rate, mma = wgmma_rate(t, clock_mhz=clock, sms=sms)
        res.update(wgmma_per_clock_sm=rate, mma_sync_equiv_per_clock_sm=mma)
        print(f"    {rate:.4f} TF32 wgmma m64n{pk.MATMUL2_COLS}k8 "
              f"instructions a clock an SM ({mma:.2f} mma.sync m16n8k8 of "
              f"the same work; {clock:.0f} MHz clocks.max.sm)")
    print("P4: batched 3D contraction (middle axis)")
    g, x, out, t = probe_dot3d(device=dev)
    want = pk.dot3d_probe_plain(g, x)
    err = (out - want).abs().max().item()
    ok = err <= DOT3D_TOL * max(1.0, want.abs().max().item())
    res.update(dot3d_ok=ok, dot3d_us=1e6 * t, dot3d_err=err)
    print(f"    {'ok' if ok else 'FAIL'} ({t * 1e6:.1f} us; max |diff| from "
          f"plain {err:.3e})")
    return res


if __name__ == "__main__":
    main()
