#!/usr/bin/env python3
"""Drive the PyTorch port's sampling and training paths once on one NVIDIA
GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's failure is
caught:

1. device: a CUDA device must be present; prints torch, CUDA, the card and
   its power limit (nvidia-smi);
2. build: compiles qiddm_tpu_torch/csrc/gate_chain.cu (both kernels) with
   nvcc (sm_90a) into build/qiddm_tpu_torch/ and loads it;
3. forward kernel against plain: the gate-chain kernel against its plain
   PyTorch version on the card, at w in {1, 4, 6, 8, 10} x B in {1, 16, 80}
   (L*k = 28, k = 2) and (w=6, B=16, L*k=42, k=3), max |diff| <= 1e-5;
4. backward kernel against plain: the adjoint kernel against its plain
   version at the same shapes with N(0, 1) cotangents, dpr, dpi and dg each
   within 1e-5 * max(1, max|plain|); at one shape also dg against torch
   autograd through the plain forward;
5. the sampling slice: QIDDM_LL_noise(784, 6, 14, 2) with seeded random
   weights, saved as a checkpoint and sampled through
   qiddm_tpu_torch.cli.sample (16 images x 15 iterations x 3 batches on
   cuda): 48 finite 28x28 images, at least 90 forward launches, and the
   last batch within 1e-4 of the same weights and start images run on the
   CPU plain path;
6. the training slice: a seeded mnist_28.npz (500 images, 50 per label) in
   a temporary data directory, then qiddm_tpu_torch.cli.mnist_exm with
   --model QIDDM_LL_noise 784 6 14 2 --epochs 2 --checkpoint-every 1
   --device cuda and mnist_exm's defaults otherwise (batch 1, tau 10,
   label 4): finite epoch losses, at least 2 forward and 2 backward
   launches per step, and a checkpoint that the sampling CLI serves; then
   3 training steps on the card from seeded weights, each step's loss and
   gradients within 1e-4 (relative) of the CPU plain path at the same
   weights, batch and noise;
7. times: median of 20 runs of each kernel and of its plain version (the
   forward at w=6, B=16, L*k=28; the backward at B=10 and B=16), the
   sampling slice's steady images/s and the training slice's images/s in
   its second epoch.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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
from qiddm_tpu_torch import data as data_mod
from qiddm_tpu_torch.cli import mnist_exm
from qiddm_tpu_torch.cli import sample as sample_cli
from qiddm_tpu_torch.diffusion import Diffusion
from qiddm_tpu_torch.nn import QIDDM_LL_noise
from qiddm_tpu_torch.sim import gate_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

SEED = 0
KERNEL_TOL = 1e-5   # unit-norm f32 states over up to 42 layers
BWD_TOL = 1e-5      # relative to max(1, max|plain|): dg sums over rows and B
SAMPLE_TOL = 1e-4   # 15 iterations of a 6 -> 784 linear over the chain
TRAIN_TOL = 1e-4    # relative; one float32 step's loss and gradients
MODEL = ["QIDDM_LL_noise", "784", "6", "14", "2"]
N, ITERS, BATCHES = 16, 15, 3
EPOCHS, TAU, LR, LABEL = 2, 10, 0.0255, 4  # mnist_exm's defaults but epochs
CASES = ([(w, b, 28, 2) for w in (1, 4, 6, 8, 10) for b in (1, 16, 80)]
         + [(6, 16, 42, 3)])


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
    worst = 0.0
    for w, b, n_layers, k in CASES:
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


def bwd_inputs(rng, wires: int, batch: int, n_layers: int, k: int, dev):
    """Forward inputs, forward output and N(0, 1) cotangents for one
    backward call: (pr, pi, g8, signs, fr, fi, gr, gi)."""
    pr, pi, mats = chain_inputs(rng, wires, batch, n_layers, dev)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(k, wires, dev)
    fr, fi = gate_kernel._chain_plain(pr, pi, g8, signs, k, wires)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**wires, batch)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    return pr, pi, g8, signs, fr, fi, gr, gi


def _rel(got, want) -> float:
    return ((got - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


def phase_bwd_vs_plain(dev) -> float:
    """Returns the worst max |kernel - plain| over the shapes."""
    rng = np.random.default_rng(SEED + 2)
    worst = 0.0
    for w, b, n_layers, k in CASES:
        args = bwd_inputs(rng, w, b, n_layers, k, dev)
        with torch.no_grad():
            got = gate_kernel._gate_chain_bwd_cuda(*args, k, w)
            want = gate_kernel.gate_chain_bwd_plain(*args, k, w)
        torch.cuda.synchronize()
        errs = [_rel(g, p) for g, p in zip(got, want)]
        worst = max(worst, *((g - p).abs().max().item()
                             for g, p in zip(got, want)))
        print(f"backward kernel vs plain w={w} B={b} L*k={n_layers} k={k}: "
              f"dpr, dpi, dg max|diff| / max(1, max|plain|) "
              + ", ".join(f"{e:.3e}" for e in errs))
        if not max(errs) <= BWD_TOL:
            fail(f"backward kernel disagrees with plain at w={w} B={b} "
                 f"L*k={n_layers} k={k}: {max(errs):.3e} > {BWD_TOL}")
    # a third formulation: autograd through the plain forward
    pr, pi, g8, signs, _, _, gr, gi = bwd_inputs(rng, 6, 16, 28, 2, dev)
    g8 = g8.requires_grad_(True)
    sr, si = gate_kernel._chain_plain(pr, pi, g8, signs, 2, 6)
    (sr * gr + si * gi).sum().backward()
    with torch.no_grad():
        fr, fi = gate_kernel._gate_chain_cuda(pr, pi, g8, signs, 2, 6)
        _, _, dg = gate_kernel._gate_chain_bwd_cuda(
            pr, pi, g8.detach(), signs, fr, fi, gr, gi, 2, 6)
    err = _rel(dg, g8.grad)
    print(f"backward kernel dg vs autograd of the plain forward w=6 B=16 "
          f"L*k=28: {err:.3e}")
    if not err <= BWD_TOL:
        fail(f"backward kernel dg disagrees with autograd: {err:.3e} > "
             f"{BWD_TOL}")
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


def write_dataset(data_dir: pathlib.Path) -> int:
    """A seeded stand-in for MNIST: 500 28x28 uint8 images, labels 0-9 in
    turn, as ``mnist_28.npz``; returns mnist_exm's training-image count
    for LABEL (80% of its 50)."""
    rng = np.random.default_rng(SEED)
    x = (rng.uniform(size=(500, 28, 28)) ** 3 * 255).astype(np.uint8)
    y = np.arange(500) % 10
    data_dir.mkdir(parents=True, exist_ok=True)
    np.savez(data_dir / "mnist_28.npz", x=x, y=y)
    data_mod.DATA_DIR = data_dir
    return int((y == LABEL).sum() * 0.8)


def phase_train(tmp: pathlib.Path) -> tuple[int, int, float]:
    n_train = write_dataset(tmp / "data")
    argv = ["--model", *MODEL, "--epochs", str(EPOCHS), "--checkpoint-every",
            "1", "--device", "cuda", "--save-path", f"{tmp}/",
            "--load-path", f"{tmp}/"]
    printed = io.StringIO()
    gate_kernel.LAUNCHES = gate_kernel.BWD_LAUNCHES = 0
    with contextlib.redirect_stdout(printed), contextlib.chdir(tmp):
        results = mnist_exm.main(argv)
    fwd, bwd = gate_kernel.LAUNCHES, gate_kernel.BWD_LAUNCHES
    print(printed.getvalue().strip())
    steps = EPOCHS * n_train
    print(f"train: {steps} steps, {fwd} forward and {bwd} backward "
          f"gate-chain kernel launches")
    losses = results[MODEL[0]]["loss"][0]
    print(f"train: epoch losses {losses}")
    if len(losses) != EPOCHS or not all(math.isfinite(v) for v in losses):
        fail(f"epoch losses {losses} are not {EPOCHS} finite values")
    if fwd < 2 * steps or bwd < 2 * steps:
        fail(f"{fwd} forward / {bwd} backward launches < {2 * steps}: the "
             f"training path did not run the kernels")
    ckpt = tmp / f"{LABEL}/noise_0/QIDDM_LL_noise=6_L=14_N=2_{LABEL}.pt"
    if not ckpt.exists():
        fail(f"no checkpoint at {ckpt}")
    with contextlib.redirect_stdout(io.StringIO()):
        imgs = sample_cli.main(["--ckpt", str(ckpt), "--model", *MODEL,
                                "--n", "4", "--iters", "3", "--device",
                                "cuda", "--out", str(tmp / "served")])
    if imgs.shape != (4, 1, 28, 28) or not np.isfinite(imgs).all():
        fail("the trained checkpoint did not serve 4 finite images")
    walls = re.findall(r"trained 1 epochs in ([0-9.]+)s", printed.getvalue())
    if len(walls) != EPOCHS:
        fail(f"mnist_exm printed {len(walls)} epoch times, not {EPOCHS}")
    return fwd, bwd, n_train / float(walls[-1])


def _grads(net) -> dict:
    return {n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()}


def phase_train_parity(tmp: pathlib.Path) -> None:
    """Three Adam steps of the slice's model on the card, one image per
    step, from seeded weights and noise. Before each step the CPU plain
    path takes the card's current weights and evaluates the same batch
    with the same noise; the loss and every gradient must agree.

    Two independent trajectories are not compared: Adam's first steps
    move each weight by about lr * sign(g), so a gradient entry within
    float noise of zero takes a different step on each device."""
    z = np.load(tmp / "data" / "mnist_28.npz")
    x = torch.as_tensor(z["x"][z["y"] == LABEL][:3] / 255.0,
                        dtype=torch.float32).reshape(3, -1)
    nets = {d: QIDDM_LL_noise(*MODEL[1:], seed=SEED, device=d)
            for d in ("cuda", "cpu")}
    diffs = {d: Diffusion(net).train() for d, net in nets.items()}
    gens = {d: torch.Generator().manual_seed(SEED) for d in nets}
    step = diffs["cuda"].make_train_step(
        torch.optim.Adam(diffs["cuda"].parameters(), lr=LR), TAU)
    loss_err = grad_err = 0.0
    for i in range(3):
        nets["cpu"].load_state_dict(nets["cuda"].state_dict())
        nets["cpu"].zero_grad()
        want, _ = diffs["cpu"].loss_fn(x[i:i + 1], TAU, generator=gens["cpu"])
        want.backward()
        got = step(x[i:i + 1].to("cuda"), gens["cuda"]).item()
        got_g, want_g = _grads(nets["cuda"]), _grads(nets["cpu"])
        loss_err = max(loss_err, abs(got - want.item()) / abs(want.item()))
        grad_err = max(grad_err, *(((got_g[n] - want_g[n]).abs().max()
                                    / want_g[n].abs().max()).item()
                                   for n in want_g))
        print(f"train: step {i + 1} loss on cuda {got:.8f}, on the CPU "
              f"plain path {want.item():.8f}")
    print(f"train: 3 steps, cuda against the CPU plain path at the same "
          f"weights: losses max relative {loss_err:.3e}; gradients max "
          f"relative (max norm, per parameter) {grad_err:.3e}")
    if not (loss_err <= TRAIN_TOL and grad_err <= TRAIN_TOL):
        fail(f"training on cuda differs from the CPU plain path: losses "
             f"{loss_err:.3e}, gradients {grad_err:.3e} > {TRAIN_TOL}")


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


def _paired_ms(kernel, plain) -> tuple[float, float]:
    """Median-of-20 ms of each, plain-kernel-kernel-plain, better of two
    rounds."""
    for fn in (kernel, plain):  # warm up
        fn()
    torch.cuda.synchronize()
    plain_ms = _median_ms(plain)
    kernel_ms = _median_ms(kernel)
    kernel_ms = min(kernel_ms, _median_ms(kernel))
    plain_ms = min(plain_ms, _median_ms(plain))
    return kernel_ms, plain_ms


def phase_times(dev, smi: str) -> dict:
    rng = np.random.default_rng(SEED + 1)
    w, b, n_layers, k = 6, 16, 28, 2
    pr, pi, mats = chain_inputs(rng, w, b, n_layers, dev)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    times = {"fwd": _paired_ms(
        lambda: gate_kernel._gate_chain_cuda(pr, pi, g8, signs, k, w),
        lambda: gate_kernel.gate_chain_planes_plain(pr, pi, mats, k, w))}
    print(f"times at w={w} B={b} L*k={n_layers} ({smi}): forward kernel "
          f"{times['fwd'][0]:.4f} ms, plain {times['fwd'][1]:.4f} ms "
          f"(median of 20, better of two rounds, plain-kernel-kernel-plain)")
    for b in (10, 16):
        args = bwd_inputs(rng, w, b, n_layers, k, dev)
        times[f"bwd{b}"] = _paired_ms(
            lambda: gate_kernel._gate_chain_bwd_cuda(*args, k, w),
            lambda: gate_kernel.gate_chain_bwd_plain(*args, k, w))
        print(f"times at w={w} B={b} L*k={n_layers} ({smi}): backward "
              f"kernel {times[f'bwd{b}'][0]:.4f} ms, plain "
              f"{times[f'bwd{b}'][1]:.4f} ms (median of 20, better of two "
              f"rounds, plain-kernel-kernel-plain)")
    return times


def main() -> None:
    kind, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    with torch.no_grad():
        max_err = phase_kernel_vs_plain(dev)
    bwd_err = phase_bwd_vs_plain(dev)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.no_grad():
            sample_launches, rate = phase_slice(pathlib.Path(tmp))
        fwd, bwd, train_rate = phase_train(pathlib.Path(tmp))
        phase_train_parity(pathlib.Path(tmp))
    with torch.no_grad():
        times = phase_times(dev, smi)
    print(f"slice: steady sampling {rate:.1f} images/s "
          f"({N} images x {ITERS} iterations per batch; {smi})")
    print(f"train: {train_rate:.1f} training images/s in epoch 2 "
          f"(batch 1, tau {TAU}; {smi})")
    print(f"launches: forward {sample_launches} (sampling) + {fwd} "
          f"(training), backward {bwd} (training)")
    print(json.dumps({"kernels": [{
        "name": "gate_chain_fwd",
        "route": "cuda",
        "source": "qiddm_tpu_torch/csrc/gate_chain.cu",
        "replaces": "qiddm_tpu/sim/pallas_gate_kernel.py:130",
        "launches": sample_launches + fwd,
        "max_abs_err": max_err,
        "ms": times["fwd"][0],
        "plain_ms": times["fwd"][1],
    }, {
        "name": "gate_chain_bwd",
        "route": "cuda",
        "source": "qiddm_tpu_torch/csrc/gate_chain.cu",
        "replaces": "qiddm_tpu/sim/pallas_gate_kernel.py:197",
        "launches": bwd,
        "max_abs_err": bwd_err,
        "ms": times["bwd10"][0],
        "plain_ms": times["bwd10"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
