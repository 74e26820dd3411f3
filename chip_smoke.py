#!/usr/bin/env python3
"""Drive the PyTorch port's sampling path once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's failure is
caught:

1. device: a CUDA device must be present; prints torch, CUDA, the card and
   its power limit (nvidia-smi);
2. build: compiles qiddm_tpu_torch/csrc/gate_chain.cu with nvcc (sm_90a)
   into build/qiddm_tpu_torch/ and loads it;
3. kernel against plain: the gate-chain kernel against its plain PyTorch
   version on the card, at w in {1, 4, 6, 8, 10} x B in {1, 16, 80}
   (L*k = 28, k = 2) and (w=6, B=16, L*k=42, k=3), max |diff| <= 1e-5;
4. the slice: QIDDM_LL_noise(784, 6, 14, 2) with seeded random weights,
   saved as a checkpoint and sampled through qiddm_tpu_torch.cli.sample
   (16 images x 15 iterations x 3 batches on cuda): 48 finite 28x28 images,
   at least 90 kernel launches, and the last batch within 1e-4 of the same
   weights and start images run on the CPU plain path;
5. times: median of 20 runs of the kernel and of the plain version at
   (w=6, B=16, L*k=28), and the steady images/s of phase 4.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from qiddm_tpu_torch.ckpt import (export_jax_variables, load_checkpoint,
                                  load_jax_variables, save_checkpoint)
from qiddm_tpu_torch.cli import sample as sample_cli
from qiddm_tpu_torch.diffusion import Diffusion
from qiddm_tpu_torch.nn import QIDDM_LL_noise
from qiddm_tpu_torch.sim import gate_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

SEED = 0
KERNEL_TOL = 1e-5   # unit-norm f32 states over up to 42 layers
SAMPLE_TOL = 1e-4   # 15 iterations of a 6 -> 784 linear over the chain
MODEL = ["QIDDM_LL_noise", "784", "6", "14", "2"]
N, ITERS, BATCHES = 16, 15, 3


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def chain_inputs(rng, wires: int, batch: int, n_layers: int, device):
    """Random phase planes and per-wire rotations for one chain call."""
    ang = torch.as_tensor(rng.normal(size=(n_layers, wires, 3)),
                          dtype=torch.float32, device=device)
    x = torch.as_tensor(rng.normal(size=(2**wires, batch)),
                        dtype=torch.float32, device=device)
    mats = rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2])
    return torch.cos(x), torch.sin(x), mats


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one "
             "NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    print(smi)
    return kind, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = gate_kernel.build_library()
    gate_kernel._library()
    print(f"build: {lib.name} ready in {time.perf_counter() - t0:.2f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        print("nvcc -Xptxas -v:\n" + log.read_text().strip())


def phase_kernel_vs_plain(dev) -> float:
    rng = np.random.default_rng(SEED)
    cases = [(w, b, 28, 2) for w in (1, 4, 6, 8, 10) for b in (1, 16, 80)]
    cases.append((6, 16, 42, 3))
    worst = 0.0
    for w, b, n_layers, k in cases:
        pr, pi, mats = chain_inputs(rng, w, b, n_layers, dev)
        kr, ki = gate_kernel.gate_chain_planes(pr, pi, mats, k, w)
        qr, qi = gate_kernel.gate_chain_planes_plain(pr, pi, mats, k, w)
        torch.cuda.synchronize()
        err = max((kr - qr).abs().max().item(), (ki - qi).abs().max().item())
        worst = max(worst, err)
        print(f"kernel vs plain w={w} B={b} L*k={n_layers} k={k}: "
              f"max|diff| {err:.3e}")
        if not err <= KERNEL_TOL:
            fail(f"kernel disagrees with plain at w={w} B={b} "
                 f"L*k={n_layers} k={k}: {err:.3e} > {KERNEL_TOL}")
    return worst


def phase_slice(tmp: pathlib.Path) -> tuple[int, float]:
    net = QIDDM_LL_noise(*MODEL[1:], seed=SEED, device="cuda")
    ckpt = save_checkpoint(tmp / f"{net.save_name()}.pt",
                           export_jax_variables(net), [], 0)
    out = tmp / "samples"
    argv = ["--ckpt", str(ckpt), "--model", *MODEL, "--img_size", "28",
            "--n", str(N), "--iters", str(ITERS), "--batches", str(BATCHES),
            "--device", "cuda", "--format", "npz", "--seed", str(SEED),
            "--out", str(out)]
    printed = io.StringIO()
    gate_kernel.LAUNCHES = 0
    with contextlib.redirect_stdout(printed):
        imgs = sample_cli.main(argv)
    launches = gate_kernel.LAUNCHES
    print(printed.getvalue().strip())
    print(f"slice: {launches} gate-chain kernel launches")
    if imgs.shape != (N * BATCHES, 1, 28, 28):
        fail(f"samples have shape {imgs.shape}")
    if not np.isfinite(imgs).all():
        fail("samples are not finite")
    saved = np.load(out / "samples.npz")["images"]
    if not np.array_equal(saved, imgs):
        fail("samples.npz does not hold the returned images")
    if launches < 2 * ITERS * BATCHES:
        fail(f"{launches} kernel launches < {2 * ITERS * BATCHES}: the "
             f"sampling path did not run the kernel")

    # the same weights and start images on the CPU plain path
    cpu_net = QIDDM_LL_noise(*MODEL[1:], seed=SEED, device="cpu")
    load_jax_variables(cpu_net, load_checkpoint(ckpt)["model_state_dict"])
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(BATCHES):
        first_x = torch.rand((N, 1, 28, 28), generator=gen) * 0.75 + 0.5
    ref = Diffusion(cpu_net, prediction_goal="data", shape=(28, 28)).sample(
        n_iters=ITERS, first_x=first_x, only_last=True).numpy()
    err = float(np.abs(ref - imgs[-N:]).max())
    print(f"slice: last batch against the CPU plain path max|diff| "
          f"{err:.3e}")
    if not err <= SAMPLE_TOL:
        fail(f"cuda samples differ from the CPU plain path: {err:.3e} > "
             f"{SAMPLE_TOL}")
    m = re.search(r"steady ([0-9.]+) images/s", printed.getvalue())
    if m is None:
        fail("the sampler printed no steady images/s")
    return launches, float(m.group(1))


def _median_ms(fn, runs: int = 20) -> float:
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_times(dev, smi: str) -> tuple[float, float]:
    rng = np.random.default_rng(SEED + 1)
    w, b, n_layers, k = 6, 16, 28, 2
    pr, pi, mats = chain_inputs(rng, w, b, n_layers, dev)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)

    def kernel():
        gate_kernel._gate_chain_cuda(pr, pi, g8, signs, k, w)

    def plain():
        gate_kernel.gate_chain_planes_plain(pr, pi, mats, k, w)

    for fn in (kernel, plain):  # warm up
        fn()
    torch.cuda.synchronize()
    plain_ms = _median_ms(plain)
    kernel_ms = _median_ms(kernel)
    kernel_ms = min(kernel_ms, _median_ms(kernel))
    plain_ms = min(plain_ms, _median_ms(plain))
    print(f"times at w={w} B={b} L*k={n_layers} ({smi}): kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20, "
          f"better of two rounds, plain-kernel-kernel-plain)")
    return kernel_ms, plain_ms


def main() -> None:
    kind, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    with torch.no_grad():
        max_err = phase_kernel_vs_plain(dev)
        with tempfile.TemporaryDirectory() as tmp:
            launches, rate = phase_slice(pathlib.Path(tmp))
        kernel_ms, plain_ms = phase_times(dev, smi)
    print(f"slice: steady sampling {rate:.1f} images/s "
          f"({N} images x {ITERS} iterations per batch; {smi})")
    print(json.dumps({"kernels": [{
        "name": "gate_chain_fwd",
        "route": "cuda",
        "source": "qiddm_tpu_torch/csrc/gate_chain.cu",
        "replaces": "qiddm_tpu/sim/pallas_gate_kernel.py:130",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
