#!/usr/bin/env python3
"""Drive the PyTorch port's sampling and training paths once on one NVIDIA
GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's failure is
caught:

1. device: a CUDA device must be present; prints torch, CUDA, the card and
   its power limit (nvidia-smi);
2. build: compiles qiddm_tpu_torch/csrc/*.cu (all six kernels; one nvcc
   per source, started together, then one link) for sm_90a into
   build/qiddm_tpu_torch/ and loads the library;
3. gate-chain forward kernel against plain: kernel #1 against its plain
   PyTorch version on the card, at w in {1, 4, 6, 8, 10} x B in
   {1, 16, 80} (L*k = 28, k = 2) and (w=6, B=16, L*k=42, k=3),
   max |diff| <= 1e-5;
4. gate-chain backward kernel against plain: kernel #2 against its plain
   version at the same shapes with N(0, 1) cotangents, dpr, dpi and dg each
   within 1e-5 * max(1, max|plain|); at one shape also dg against torch
   autograd through the plain forward;
5. SEL-chain forward kernel against plain: kernel #5 at w in
   {1, 2, 4, 6, 8, 10} x B in {1, 10, 16, 80} x ring in {cz, cnot}, depth
   14, and (w=6, B=16, depth 60, cnot), from random normalized start
   states, max |diff| <= 1e-5;
6. SEL-chain backward kernel against plain: kernel #6 at the same shapes
   with N(0, 1) cotangents, dsr, dsi and dg each within
   1e-5 * max(1, max|plain|); at one shape per ring also against torch
   autograd through the plain forward;
7. RY-chain forward kernel against plain: kernel #3 at w in {1, 3, 6} x
   B in {1, 5} x (L*k, k) in {(4, 2), (12, 3), (12, 2)}, QIDDM_PL_noise1's
   (w=8, L*k=12) at B=10 and 16, (w=10, B=80, L*k=28) and the JAX package's
   A/B shape (w=6, B=11, L*k=28), max |diff| <= 1e-5;
8. RY-chain backward kernel against plain: kernel #4 at the same shapes
   with N(0, 1) cotangents, dcs and dg each within
   1e-5 * max(1, max|plain|); at (w=8, B=10, L*k=12) also against torch
   autograd through the plain forward;
9. sampling: QIDDM_LL_noise(784, 6, 14, 2), QNN_noise(784, 8, 14),
   QDenseUndirected_old_noise(60, 8) and QIDDM_PL_noise1(784, 8, 6, 2)
   with seeded random weights, each saved as a checkpoint and sampled
   through qiddm_tpu_torch.cli.sample (16 images x 15 iterations x 3
   batches on cuda): finite images, at least 90 gate-chain launches (QIDDM,
   two blocks), 45 SEL-chain launches (QNN, Qdense) or 90 RY-chain
   launches (QIDDM_PL_noise1, two blocks), and the last batch within 1e-4
   of the same weights and start images run on the CPU plain path. For
   QIDDM_PL_noise1, which refits a PCA on every batch, first the PCA
   projection of the first start batch, fitted on the card (cuSOLVER) and
   on the CPU, within 1e-4; then its sampling is held step by step: the
   last batch's 15 iterations rerun on the card give the CLI's batch, and
   at every iteration the CPU plain path maps the card's batch to the
   card's next within 1e-4. Its free-running drift is printed, not held:
   each PCA refit carries the last step's float32 rounding into the next
   fit, so two float32 implementations part after a few iterations
   (ROADMAP Queue 3);
10. training: a seeded mnist_28.npz (500 images, 50 per label) in a
   temporary data directory, then qiddm_tpu_torch.cli.mnist_exm with no
   --model, so both default models, QIDDM_LL_noise 784 6 14 2 and
   QNN_noise 784 8 14, train in turn, and again with --model
   QIDDM_PL_noise1 784 8 6 2, each run with --epochs 2 --checkpoint-every 1
   --device cuda and mnist_exm's defaults otherwise (batch 1, tau 10,
   label 4): finite epoch losses, at least 2 forward and 2 backward
   gate-chain launches per QIDDM step, 1 forward and 1 backward SEL-chain
   launch per QNN step and 2 forward and 2 backward RY-chain launches per
   QIDDM_PL_noise1 step, and every checkpoint served by the sampling CLI;
   then, for each of the three models, 3 training steps on the card from
   seeded weights, each step's loss and gradients (each block of qweights
   on its own) within 1e-4 of the CPU plain path at the same weights,
   batch and noise (gradients relative to their own max norm, or to the
   model's largest where a gradient is zero up to rounding, as QNN's
   linear_down);
11. profile: 10 steady QIDDM_PL_noise1 training steps (batch 1, tau 10)
   under torch.profiler: device events, busy time and idle share per step,
   the RY kernels' share; the step, the PCA fit and eigh alone on the host
   clock;
12. times: median of 20 runs of each kernel and of its plain version (the
   gate-chain forward at w=6, B=16, L*k=28 and its backward at B=10 and
   B=16; the SEL chain forward and backward at w=8, depth 14, B=10 and 16,
   CZ, and at w=6, depth 60, B=10, CNOT; the RY chain forward and backward
   at w=8, B=10, L*k=12 and at w=6, B=11, L*k=28), each beside its bound
   (the larger of its arithmetic over 67 TFLOP/s and its bytes, each input
   read once and each output written once, over 3.35 TB/s), the sampling
   images/s of each model and the training images/s of each trained model
   in its second epoch.

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
from qiddm_tpu_torch.cli import common
from qiddm_tpu_torch.cli import mnist_exm
from qiddm_tpu_torch.cli import sample as sample_cli
from qiddm_tpu_torch.diffusion import Diffusion
from qiddm_tpu_torch.pca import pca_fit_transform
from qiddm_tpu_torch.sim import gate_kernel, ry_kernel, sel_kernel
from qiddm_tpu_torch.sim.gates import rot_matrix

SEED = 0
KERNEL_TOL = 1e-5   # unit-norm f32 states over up to 60 layers
BWD_TOL = 1e-5      # relative to max(1, max|plain|): dg sums over rows and B
SAMPLE_TOL = 1e-4   # 15 iterations of a linear or pixel scaling over a chain
TRAIN_TOL = 1e-4    # relative; one float32 step's loss and gradients
GRAD_FLOOR = 1e-6   # below this share of the largest, a gradient is ~zero
MODEL = ["QIDDM_LL_noise", "784", "6", "14", "2"]
QNN_MODEL = ["QNN_noise", "784", "8", "14"]
QDENSE_MODEL = ["QDenseUndirected_old_noise", "60", "8"]
PL_MODEL = ["QIDDM_PL_noise1", "784", "8", "6", "2"]
# (model, image side, launch counter, launches per denoise iteration,
# held step by step)
SAMPLED = [(MODEL, 28, "gate", 2, False), (QNN_MODEL, 28, "sel", 1, False),
           (QDENSE_MODEL, 8, "sel", 1, False), (PL_MODEL, 28, "ry", 2, True)]
N, ITERS, BATCHES = 16, 15, 3
EPOCHS, TAU, LABEL = 2, 10, 4  # mnist_exm's defaults but epochs
CASES = ([(w, b, 28, 2) for w in (1, 4, 6, 8, 10) for b in (1, 16, 80)]
         + [(6, 16, 42, 3)])
SEL_CASES = ([(w, b, 14, ring) for w in (1, 2, 4, 6, 8, 10)
              for b in (1, 10, 16, 80) for ring in ("cz", "cnot")]
             + [(6, 16, 60, "cnot")])
RY_CASES = ([(w, b, n, k) for w in (1, 3, 6) for b in (1, 5)
             for n, k in ((4, 2), (12, 3), (12, 2))]
            + [(8, 10, 12, 2), (8, 16, 12, 2), (10, 80, 28, 2),
               (6, 11, 28, 2)])
# the card's published peaks (H100 SXM, 700 W): float32 outside the tensor
# cores, and device memory
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def reset_counts() -> None:
    gate_kernel.LAUNCHES = gate_kernel.BWD_LAUNCHES = 0
    sel_kernel.SEL_LAUNCHES = sel_kernel.SEL_BWD_LAUNCHES = 0
    ry_kernel.RY_LAUNCHES = ry_kernel.RY_BWD_LAUNCHES = 0


def read_counts() -> dict:
    return {"gate": gate_kernel.LAUNCHES, "gate_bwd": gate_kernel.BWD_LAUNCHES,
            "sel": sel_kernel.SEL_LAUNCHES,
            "sel_bwd": sel_kernel.SEL_BWD_LAUNCHES,
            "ry": ry_kernel.RY_LAUNCHES, "ry_bwd": ry_kernel.RY_BWD_LAUNCHES}


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


def sel_inputs(rng, wires: int, batch: int, depth: int, dev):
    """Random normalized start-state planes (d, B) and per-wire rotations
    for one SEL-chain call: (sr, si, mats)."""
    st = rng.normal(size=(2, 2**wires, batch))
    st /= np.sqrt((st ** 2).sum(axis=(0, 1), keepdims=True))
    ang = torch.as_tensor(rng.normal(size=(depth, wires, 3)),
                          dtype=torch.float32, device=dev)
    sr, si = (torch.as_tensor(p, dtype=torch.float32, device=dev)
              for p in st)
    return sr, si, rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2])


def sel_bwd_inputs(rng, wires: int, batch: int, depth: int, ring: str, dev):
    """Gates, forward output and N(0, 1) cotangents for one SEL backward
    call, (g8, fr, fi, gr, gi), and the start planes (sr, si)."""
    sr, si, mats = sel_inputs(rng, wires, batch, depth, dev)
    g8 = gate_kernel._to_g8(mats)
    fr, fi = sel_kernel._sel_plain(sr, si, g8, wires, ring)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**wires, batch)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    return (g8, fr, fi, gr, gi), (sr, si)


def phase_sel_vs_plain(dev) -> float:
    rng = np.random.default_rng(SEED + 3)
    worst = 0.0
    for w, b, depth, ring in SEL_CASES:
        sr, si, mats = sel_inputs(rng, w, b, depth, dev)
        kr, ki = sel_kernel.sel_chain_planes(sr, si, mats, w, ring)
        qr, qi = sel_kernel.sel_chain_planes_plain(sr, si, mats, w, ring)
        torch.cuda.synchronize()
        err = max((kr - qr).abs().max().item(), (ki - qi).abs().max().item())
        worst = max(worst, err)
        print(f"SEL kernel vs plain w={w} B={b} depth={depth} {ring}: "
              f"max|diff| {err:.3e}")
        if not err <= KERNEL_TOL:
            fail(f"SEL kernel disagrees with plain at w={w} B={b} "
                 f"depth={depth} {ring}: {err:.3e} > {KERNEL_TOL}")
    return worst


def phase_sel_bwd_vs_plain(dev) -> float:
    """Returns the worst max |kernel - plain| over the shapes."""
    rng = np.random.default_rng(SEED + 4)
    worst = 0.0
    for w, b, depth, ring in SEL_CASES:
        args, _ = sel_bwd_inputs(rng, w, b, depth, ring, dev)
        with torch.no_grad():
            got = sel_kernel._sel_chain_bwd_cuda(*args, w, ring)
            want = sel_kernel.sel_chain_bwd_plain(*args, w, ring)
        torch.cuda.synchronize()
        errs = [_rel(g, p) for g, p in zip(got, want)]
        worst = max(worst, *((g - p).abs().max().item()
                             for g, p in zip(got, want)))
        print(f"SEL backward kernel vs plain w={w} B={b} depth={depth} "
              f"{ring}: dsr, dsi, dg max|diff| / max(1, max|plain|) "
              + ", ".join(f"{e:.3e}" for e in errs))
        if not max(errs) <= BWD_TOL:
            fail(f"SEL backward kernel disagrees with plain at w={w} B={b} "
                 f"depth={depth} {ring}: {max(errs):.3e} > {BWD_TOL}")
    # a third formulation: autograd through the plain forward
    for ring in ("cz", "cnot"):
        (g8, _, _, gr, gi), (sr, si) = sel_bwd_inputs(rng, 8, 10, 14, ring,
                                                      dev)
        leaves = [t.clone().requires_grad_(True) for t in (sr, si, g8)]
        out_r, out_i = sel_kernel._sel_plain(*leaves, 8, ring)
        (out_r * gr + out_i * gi).sum().backward()
        with torch.no_grad():
            fr, fi = sel_kernel._sel_chain_cuda(sr, si, g8, 8, ring)
            got = sel_kernel._sel_chain_bwd_cuda(g8, fr, fi, gr, gi, 8, ring)
        err = max(_rel(g, leaf.grad) for g, leaf in zip(got, leaves))
        print(f"SEL backward kernel vs autograd of the plain forward w=8 "
              f"B=10 depth=14 {ring}: {err:.3e}")
        if not err <= BWD_TOL:
            fail(f"SEL backward kernel disagrees with autograd ({ring}): "
                 f"{err:.3e} > {BWD_TOL}")
    return worst


def ry_bwd_inputs(rng, wires: int, batch: int, n_layers: int, k: int, dev):
    """Encode columns, gates, sign planes, forward output and N(0, 1)
    cotangents for one RY backward call: (cs, g8, signs, fr, fi, gr, gi)."""
    x = torch.as_tensor(2 * rng.normal(size=(batch, wires)),
                        dtype=torch.float32, device=dev)
    ang = torch.as_tensor(rng.normal(size=(n_layers, wires, 3)),
                          dtype=torch.float32, device=dev)
    cs = ry_kernel.ry_cs(x)
    g8 = gate_kernel._to_g8(rot_matrix(ang[..., 0], ang[..., 1], ang[..., 2]))
    signs = gate_kernel._sign_planes_on(k, wires, dev)
    fr, fi = ry_kernel._ry_plain(cs, g8, signs, k, wires)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**wires, batch)),
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    return cs, g8, signs, fr, fi, gr, gi


def phase_ry_vs_plain(dev) -> float:
    rng = np.random.default_rng(SEED + 5)
    worst = 0.0
    for w, b, n_layers, k in RY_CASES:
        cs, g8, signs, *_ = ry_bwd_inputs(rng, w, b, n_layers, k, dev)
        kr, ki = ry_kernel._ry_chain_cuda(cs, g8, signs, k, w)
        qr, qi = ry_kernel._ry_plain(cs, g8, signs, k, w)
        torch.cuda.synchronize()
        err = max((kr - qr).abs().max().item(), (ki - qi).abs().max().item())
        worst = max(worst, err)
        print(f"RY kernel vs plain w={w} B={b} L*k={n_layers} k={k}: "
              f"max|diff| {err:.3e}")
        if not err <= KERNEL_TOL:
            fail(f"RY kernel disagrees with plain at w={w} B={b} "
                 f"L*k={n_layers} k={k}: {err:.3e} > {KERNEL_TOL}")
    return worst


def phase_ry_bwd_vs_plain(dev) -> float:
    """Returns the worst max |kernel - plain| over the shapes."""
    rng = np.random.default_rng(SEED + 6)
    worst = 0.0
    for w, b, n_layers, k in RY_CASES:
        args = ry_bwd_inputs(rng, w, b, n_layers, k, dev)
        with torch.no_grad():
            got = ry_kernel._ry_chain_bwd_cuda(*args, k, w)
            want = ry_kernel.ry_chain_bwd_plain(*args, k, w)
        torch.cuda.synchronize()
        errs = [_rel(g, p) for g, p in zip(got, want)]
        worst = max(worst, *((g - p).abs().max().item()
                             for g, p in zip(got, want)))
        print(f"RY backward kernel vs plain w={w} B={b} L*k={n_layers} "
              f"k={k}: dcs, dg max|diff| / max(1, max|plain|) "
              + ", ".join(f"{e:.3e}" for e in errs))
        if not max(errs) <= BWD_TOL:
            fail(f"RY backward kernel disagrees with plain at w={w} B={b} "
                 f"L*k={n_layers} k={k}: {max(errs):.3e} > {BWD_TOL}")
    # a third formulation: autograd through the plain forward
    cs, g8, signs, _, _, gr, gi = ry_bwd_inputs(rng, 8, 10, 12, 2, dev)
    leaves = [t.clone().requires_grad_(True) for t in (cs, g8)]
    sr, si = ry_kernel._ry_plain(*leaves, signs, 2, 8)
    (sr * gr + si * gi).sum().backward()
    with torch.no_grad():
        fr, fi = ry_kernel._ry_chain_cuda(cs, g8, signs, 2, 8)
        got = ry_kernel._ry_chain_bwd_cuda(cs, g8, signs, fr, fi, gr, gi, 2,
                                           8)
    err = max(_rel(g, leaf.grad) for g, leaf in zip(got, leaves))
    print(f"RY backward kernel dcs, dg vs autograd of the plain forward w=8 "
          f"B=10 L*k=12: {err:.3e}")
    if not err <= BWD_TOL:
        fail(f"RY backward kernel disagrees with autograd: {err:.3e} > "
             f"{BWD_TOL}")
    return worst


def phase_pca_on_card(side: int) -> None:
    """QIDDM_PL_noise1 refits a PCA on every forward batch: the projection
    of the sampler's first start batch (16 random images, 8 components),
    fitted by cuSOLVER on the card and by LAPACK on the CPU."""
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.rand((N, side * side), generator=gen) * 0.75 + 0.5)
    _, got = pca_fit_transform(x.to("cuda"), int(PL_MODEL[2]))
    _, want = pca_fit_transform(x, int(PL_MODEL[2]))
    err = (got.cpu() - want).abs().max().item()
    print(f"PCA projection of {N} start images, card against the CPU: "
          f"max|diff| {err:.3e}")
    if not err <= SAMPLE_TOL:
        fail(f"the PCA projection on the card differs from the CPU's: "
             f"{err:.3e} > {SAMPLE_TOL}")


def phase_sample(tmp: pathlib.Path, margs: list, side: int, counter: str,
                 per_iter: int, stepwise: bool) -> tuple[dict, float]:
    """Sample ``margs`` through the sampling CLI on cuda; returns the launch
    counts of the run and the steady images/s. With ``stepwise`` the CPU
    plain path is held to each iteration from the card's batch instead of
    to the last batch from the start images."""
    net = common.build_model(margs, seed=SEED, device="cuda")
    ckpt = save_checkpoint(tmp / f"{net.save_name()}.pt",
                           export_jax_variables(net), [], 0)
    out = tmp / f"samples_{margs[0]}"
    argv = ["--ckpt", str(ckpt), "--model", *margs, "--img_size", str(side),
            "--n", str(N), "--iters", str(ITERS), "--batches", str(BATCHES),
            "--device", "cuda", "--format", "npz", "--seed", str(SEED),
            "--out", str(out)]
    printed = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(printed):
        imgs = sample_cli.main(argv)
    counts = read_counts()
    print(printed.getvalue().strip())
    print(f"sample {margs[0]}: launches {counts}")
    if imgs.shape != (N * BATCHES, 1, side, side):
        fail(f"{margs[0]} samples have shape {imgs.shape}")
    if not np.isfinite(imgs).all():
        fail(f"{margs[0]} samples are not finite")
    saved = np.load(out / "samples.npz")["images"]
    if not np.array_equal(saved, imgs):
        fail("samples.npz does not hold the returned images")
    want = per_iter * ITERS * BATCHES
    if counts[counter] < want:
        fail(f"{margs[0]}: {counts[counter]} {counter} kernel launches < "
             f"{want}: the sampling path did not run the kernel")

    # the same weights and start images on the CPU plain path
    cpu_net = common.build_model(margs, seed=SEED, device="cpu")
    load_jax_variables(cpu_net, load_checkpoint(ckpt)["model_state_dict"])
    gen = torch.Generator().manual_seed(SEED)
    for _ in range(BATCHES):
        first_x = torch.rand((N, 1, side, side), generator=gen) * 0.75 + 0.5
    ref = Diffusion(cpu_net, prediction_goal="data",
                    shape=(side, side)).sample(
        n_iters=ITERS, first_x=first_x, only_last=True).numpy()
    err = float(np.abs(ref - imgs[-N:]).max())
    print(f"sample {margs[0]}: last batch against the CPU plain path "
          f"max|diff| {err:.3e}" + (" (free-running, not held)" if stepwise
                                    else ""))
    if stepwise:
        stack = Diffusion(net, shape=(side, side)).sample_stack_fn(
            first_x.to("cuda"), ITERS).cpu()
        if not np.array_equal(stack[-1].numpy(), imgs[-N:]):
            fail(f"{margs[0]}: rerunning the last batch on the card does not "
                 f"give the CLI's images")
        err = max((cpu_net(stack[t]) - stack[t + 1]).abs().max().item()
                  for t in range(ITERS))
        print(f"sample {margs[0]}: each of {ITERS} iterations from the card's "
              f"batch against the CPU plain path max|diff| {err:.3e}")
    if not err <= SAMPLE_TOL:
        fail(f"{margs[0]} cuda samples differ from the CPU plain path: "
             f"{err:.3e} > {SAMPLE_TOL}")
    m = re.search(r"steady ([0-9.]+) images/s", printed.getvalue())
    if m is None:
        fail("the sampler printed no steady images/s")
    return counts, float(m.group(1))


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


def phase_train(tmp: pathlib.Path, n_train: int, models: list,
                per_step: dict, default: bool) -> tuple[dict, dict]:
    """mnist_exm on ``models`` (its default model list with ``default``,
    else given with --model); returns the launch counts and each model's
    training images/s in its second epoch. ``per_step`` is the least
    number of launches of each counter per training step."""
    argv = ["--epochs", str(EPOCHS), "--checkpoint-every", "1", "--device",
            "cuda", "--save-path", f"{tmp}/", "--load-path", f"{tmp}/"]
    if not default:
        for margs in models:
            argv += ["--model", *margs]
    printed = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(printed), contextlib.chdir(tmp):
        results = mnist_exm.main(argv)
    counts = read_counts()
    print(printed.getvalue().strip())
    steps = EPOCHS * n_train
    print(f"train: {steps} steps per model, launches {counts}")
    names = [margs[0] for margs in models]
    if sorted(results) != sorted(names):
        fail(f"mnist_exm trained {sorted(results)}, not {names}")
    for name in names:
        losses = results[name]["loss"][0]
        print(f"train: {name} epoch losses {losses}")
        if len(losses) != EPOCHS or not all(math.isfinite(v) for v in losses):
            fail(f"{name} epoch losses {losses} are not {EPOCHS} finite "
                 f"values")
    for counter, per in per_step.items():
        if counts[counter] < per * steps:
            fail(f"{counts}: fewer than {per * steps} {counter} launches in "
                 f"{steps} steps: {names} did not train through the kernels")
    for margs in models:
        name = common.build_model(margs).save_name()
        ckpt = tmp / f"{LABEL}/noise_0/{name}_{LABEL}.pt"
        if not ckpt.exists():
            fail(f"no checkpoint at {ckpt}")
        with contextlib.redirect_stdout(io.StringIO()):
            imgs = sample_cli.main(["--ckpt", str(ckpt), "--model", *margs,
                                    "--n", "4", "--iters", "3", "--device",
                                    "cuda", "--out", str(tmp / "served")])
        if imgs.shape != (4, 1, 28, 28) or not np.isfinite(imgs).all():
            fail(f"the trained {margs[0]} checkpoint did not serve 4 finite "
                 f"images")
    walls = re.findall(r"trained 1 epochs in ([0-9.]+)s", printed.getvalue())
    if len(walls) != len(models) * EPOCHS:
        fail(f"mnist_exm printed {len(walls)} epoch times, not "
             f"{len(models) * EPOCHS}")
    # the models train in turn, each for EPOCHS epochs
    rates = {name: n_train / float(walls[(i + 1) * EPOCHS - 1])
             for i, name in enumerate(names)}
    return counts, rates


def _grads(net) -> dict:
    """Each parameter's gradient on the CPU; a re-uploading model's qweights
    (N, L, k, wires, 3) split into its N blocks, each held on its own: the
    first block's gradient reaches it only through the later blocks' encode
    gradients (the chain kernels' dpr, dpi or dcs)."""
    out = {}
    for n, p in net.named_parameters():
        g = p.grad.detach().cpu().clone()
        if n.endswith("qweights") and g.ndim == 5:
            out.update({f"{n}[{b}]": g[b] for b in range(len(g))})
        else:
            out[n] = g
    return out


def _grad_err(got: dict, want: dict) -> float:
    """Max over parameters of |got - want|, relative to the parameter's
    own max norm, or to the model's largest gradient norm where the
    parameter's is below GRAD_FLOOR of it. QNN's linear_down gradient is
    zero up to rounding on both devices (its circuit RZ-encodes |0...0>,
    so the input is a global phase): relative to its own ~1e-9 norm the
    rounding would read as a disagreement."""
    top = max(g.abs().max().item() for g in want.values())
    errs = []
    for n, w in want.items():
        scale = w.abs().max().item()
        errs.append((got[n] - w).abs().max().item()
                    / (scale if scale >= GRAD_FLOOR * top else top))
    return max(errs)


def phase_train_parity(tmp: pathlib.Path, margs: list,
                       images: int = 1) -> None:
    """Three Adam steps of ``margs`` on the card, ``images`` images per
    step, from seeded weights and noise. Before each step the CPU plain
    path takes the card's current weights and evaluates the same batch with
    the same noise; the loss and every gradient must agree.

    Two independent trajectories are not compared: Adam's first steps
    move each weight by about lr * sign(g), so a gradient entry within
    float noise of zero takes a different step on each device. The PCA
    model takes 10 distinct images a step, scaled by 0.7^j: one image's
    noise chain spans fewer directions than the 8 components, and a float32
    fit keeps rounding noise for the rest; independent random images have
    nearly equal singular values, so which ones the 8 components keep would
    be left to rounding on either device (ROADMAP Queue 3)."""
    z = np.load(tmp / "data" / "mnist_28.npz")
    x = torch.as_tensor(z["x"][z["y"] == LABEL][:3 * images] / 255.0,
                        dtype=torch.float32).reshape(3, images, -1)
    x = x * (0.7 ** torch.arange(images, dtype=torch.float32))[:, None]
    nets = {d: common.build_model(margs, seed=SEED, device=d)
            for d in ("cuda", "cpu")}
    diffs = {d: Diffusion(net).train() for d, net in nets.items()}
    gens = {d: torch.Generator().manual_seed(SEED) for d in nets}
    lr = common.DEFAULT_LRS.get(margs[0], common.FALLBACK_LR)
    step = diffs["cuda"].make_train_step(
        torch.optim.Adam(diffs["cuda"].parameters(), lr=lr), TAU)
    loss_err = grad_err = 0.0
    for i in range(3):
        nets["cpu"].load_state_dict(nets["cuda"].state_dict())
        nets["cpu"].zero_grad()
        want, _ = diffs["cpu"].loss_fn(x[i], TAU, generator=gens["cpu"])
        want.backward()
        got = step(x[i].to("cuda"), gens["cuda"]).item()
        loss_err = max(loss_err, abs(got - want.item()) / abs(want.item()))
        grad_err = max(grad_err, _grad_err(_grads(nets["cuda"]),
                                           _grads(nets["cpu"])))
        print(f"train {margs[0]}: step {i + 1} loss on cuda {got:.8f}, on "
              f"the CPU plain path {want.item():.8f}")
    print(f"train {margs[0]}: 3 steps of {images} image(s), cuda against the "
          f"CPU plain path at the same weights: losses max relative "
          f"{loss_err:.3e}; gradients max relative (max norm, per parameter "
          f"and per qweights block; floored at {GRAD_FLOOR} of the largest) "
          f"{grad_err:.3e}")
    if not (loss_err <= TRAIN_TOL and grad_err <= TRAIN_TOL):
        fail(f"training {margs[0]} on cuda differs from the CPU plain path: "
             f"losses {loss_err:.3e}, gradients {grad_err:.3e} > "
             f"{TRAIN_TOL}")


def _host_ms(fn, runs: int = 20) -> float:
    """Median host-clock ms of ``fn`` followed by a synchronise."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def phase_profile_pl(tmp: pathlib.Path, smi: str) -> None:
    """Where a QIDDM_PL_noise1 training step's time goes (batch 1, tau 10,
    the driver's default): 10 steady Adam steps under torch.profiler give
    the device events per step, the device busy time (the union of kernel
    and copy intervals, user annotations dropped), the idle share of the
    profiled wall and the RY kernels' device time; the step, the PCA fit
    and ``eigh`` alone are also timed on the host clock without the
    profiler, each ending in a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    z = np.load(tmp / "data" / "mnist_28.npz")
    x = torch.as_tensor(z["x"][z["y"] == LABEL][:1] / 255.0,
                        dtype=torch.float32, device="cuda").reshape(1, -1)
    net = common.build_model(PL_MODEL, seed=SEED, device="cuda")
    diff = Diffusion(net).train()
    step = diff.make_train_step(
        torch.optim.Adam(diff.parameters(), lr=common.FALLBACK_LR), TAU)
    gen = torch.Generator().manual_seed(SEED)
    step_ms = _host_ms(lambda: step(x, gen))
    steps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(x, gen)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    ry_us = sum(e.time_range.elapsed_us() for e in dev
                if "ry_chain" in e.name)
    top = prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12)
    rows = torch.rand((TAU, 784), generator=gen).to("cuda")
    pca_ms = _host_ms(lambda: pca_fit_transform(rows, int(PL_MODEL[2])))
    gram = rows @ rows.T
    eigh_ms = _host_ms(lambda: torch.linalg.eigh(gram))
    print(f"profile QIDDM_PL_noise1 training ({smi}), {steps} steps: "
          f"{len(dev) / steps:.1f} device events per step, device busy "
          f"{busy / steps / 1e3:.4f} ms per step, idle share "
          f"{1 - busy / wall_us:.3f} of {wall_us / steps / 1e3:.3f} ms per "
          f"profiled step; RY kernels {ry_us / steps:.1f} us per step "
          f"({ry_us / busy:.3f} of busy)")
    print(f"profile QIDDM_PL_noise1 ({smi}): step without the profiler "
          f"{step_ms:.3f} ms; PCA fit and projection of {TAU} rows "
          f"{pca_ms:.3f} ms, eigh of their {TAU}x{TAU} Gram matrix alone "
          f"{eigh_ms:.3f} ms (host clock, median of 20, each ending in a "
          f"synchronise)")
    print(top)


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


_HOW = "median of 20, better of two rounds, plain-kernel-kernel-plain"

# Arithmetic of the chains, counted from the algorithm, per sample and per
# d = 2^w amplitudes: a complex 2x2 gate on all d/2 pairs of one wire is
# 14 d flops (28 a pair), a real RY 6 d (12 a pair), a sign plane 2 d, a
# phase plane 6 d. An adjoint step undoes a gate on the state and on the
# cotangent and forms 8 pair products for dg: 40 d. The RZ un-encode is
# 20 d, the RY un-encode 20 d a wire (two real RYs and the dc, ds sums).
# dg's batch sum adds L*k*w*8 values per sample. Bytes: each input read
# once and each output written once, float32 (4 bytes); scratch is not
# counted.


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound_gate(w, b, n, k, bwd: bool) -> tuple[float, str]:
    d, re = 2**w, n // k  # n = L*k layers, re = L encodes
    g = n * w * 8
    if not bwd:
        return _bound(b * d * (14 * n * w + 2 * n + 6 * re),
                      4 * (2 * d * b + g + k * d + 2 * d * b))
    return _bound(b * (d * (n * (4 + 40 * w) + 20 * re) + g),
                  4 * (6 * d * b + g + k * d + 2 * d * b + g))


def bound_ry(w, b, n, k, bwd: bool) -> tuple[float, str]:
    d, re = 2**w, n // k
    g = n * w * 8
    if not bwd:
        return _bound(b * d * (14 * n * w + 2 * n + 6 * re * w),
                      4 * (2 * w * b + g + k * d + 2 * d * b))
    return _bound(b * (d * (n * (4 + 40 * w) + 20 * re * w) + g),
                  4 * (2 * w * b + g + k * d + 4 * d * b + g + 2 * w * b))


def bound_sel(w, b, depth, ring, bwd: bool) -> tuple[float, str]:
    d, g = 2**w, depth * w * 8
    sign = 2 if ring == "cz" else 0  # a CNOT ring moves, it computes nothing
    table = max(w - 1, 1) * d
    if not bwd:
        return _bound(b * d * depth * (14 * w + sign),
                      4 * (2 * d * b + g + table + 2 * d * b))
    return _bound(b * (d * depth * (40 * w + 2 * sign) + g),
                  4 * (4 * d * b + g + table + 2 * d * b + g))


def phase_times(dev, smi: str) -> dict:
    """{key: (kernel ms, plain ms, bound ms, bound by)}."""
    rng = np.random.default_rng(SEED + 1)
    w, b, n_layers, k = 6, 16, 28, 2
    pr, pi, mats = chain_inputs(rng, w, b, n_layers, dev)
    g8 = gate_kernel._to_g8(mats)
    signs = gate_kernel._sign_planes_on(k, w, pr.device)
    times = {"fwd": _paired_ms(
        lambda: gate_kernel._gate_chain_cuda(pr, pi, g8, signs, k, w),
        lambda: gate_kernel.gate_chain_planes_plain(pr, pi, mats, k, w))
        + bound_gate(w, b, n_layers, k, False)}
    for b in (10, 16):
        args = bwd_inputs(rng, w, b, n_layers, k, dev)
        times[f"bwd{b}"] = _paired_ms(
            lambda: gate_kernel._gate_chain_bwd_cuda(*args, k, w),
            lambda: gate_kernel.gate_chain_bwd_plain(*args, k, w)
        ) + bound_gate(w, b, n_layers, k, True)
    for w, depth, b, ring in ((8, 14, 10, "cz"), (8, 14, 16, "cz"),
                              (6, 60, 10, "cnot")):
        (g8, fr, fi, gr, gi), (sr, si) = sel_bwd_inputs(rng, w, b, depth,
                                                        ring, dev)
        key = f"{w}_{depth}_{b}_{ring}"
        times[f"sel_fwd{key}"] = _paired_ms(
            lambda: sel_kernel._sel_chain_cuda(sr, si, g8, w, ring),
            lambda: sel_kernel._sel_plain(sr, si, g8, w, ring)
        ) + bound_sel(w, b, depth, ring, False)
        times[f"sel_bwd{key}"] = _paired_ms(
            lambda: sel_kernel._sel_chain_bwd_cuda(g8, fr, fi, gr, gi, w,
                                                   ring),
            lambda: sel_kernel.sel_chain_bwd_plain(g8, fr, fi, gr, gi, w,
                                                   ring)
        ) + bound_sel(w, b, depth, ring, True)
    for w, b, n_layers, k in ((8, 10, 12, 2), (6, 11, 28, 2)):
        args = ry_bwd_inputs(rng, w, b, n_layers, k, dev)
        key = f"{w}_{b}_{n_layers}"
        times[f"ry_fwd{key}"] = _paired_ms(
            lambda: ry_kernel._ry_chain_cuda(*args[:3], k, w),
            lambda: ry_kernel._ry_plain(*args[:3], k, w)
        ) + bound_ry(w, b, n_layers, k, False)
        times[f"ry_bwd{key}"] = _paired_ms(
            lambda: ry_kernel._ry_chain_bwd_cuda(*args, k, w),
            lambda: ry_kernel.ry_chain_bwd_plain(*args, k, w)
        ) + bound_ry(w, b, n_layers, k, True)
    for key, (kern, plain, bound, by) in times.items():
        print(f"times {key} ({smi}): kernel {kern:.4f} ms, plain "
              f"{plain:.4f} ms ({_HOW}); bound {bound:.3e} ms ({by}), "
              f"kernel at {bound / kern:.2e} of it")
    return times


def main() -> None:
    t_start = time.perf_counter()
    kind, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    with torch.no_grad():
        max_err = phase_kernel_vs_plain(dev)
    bwd_err = phase_bwd_vs_plain(dev)
    with torch.no_grad():
        sel_err = phase_sel_vs_plain(dev)
    sel_bwd_err = phase_sel_bwd_vs_plain(dev)
    with torch.no_grad():
        ry_err = phase_ry_vs_plain(dev)
    ry_bwd_err = phase_ry_bwd_vs_plain(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        sampled, rates = {}, {}
        with torch.no_grad():
            phase_pca_on_card(28)
            for margs, side, counter, per_iter, stepwise in SAMPLED:
                sampled[margs[0]], rates[margs[0]] = phase_sample(
                    tmp, margs, side, counter, per_iter, stepwise)
        n_train = write_dataset(tmp / "data")
        trained, train_rates = phase_train(
            tmp, n_train, [MODEL, QNN_MODEL],
            {"gate": 2, "gate_bwd": 2, "sel": 1, "sel_bwd": 1}, default=True)
        pl_trained, pl_rates = phase_train(
            tmp, n_train, [PL_MODEL], {"ry": 2, "ry_bwd": 2}, default=False)
        train_rates.update(pl_rates)
        for margs, images in ((MODEL, 1), (QNN_MODEL, 1), (PL_MODEL, 10)):
            phase_train_parity(tmp, margs, images)
        phase_profile_pl(tmp, smi)
    with torch.no_grad():
        times = phase_times(dev, smi)
    for name, rate in rates.items():
        print(f"sample {name}: steady sampling {rate:.1f} images/s ({N} "
              f"images x {ITERS} iterations per batch; {smi})")
    for name, rate in train_rates.items():
        print(f"train {name}: {rate:.1f} training images/s in epoch 2 "
              f"(batch 1, tau {TAU}; {smi})")
    launches = {c: sum(s[c] for s in sampled.values()) + trained[c]
                + pl_trained[c] for c in trained}
    print(f"launches: sampling {sampled}, training {trained}, "
          f"QIDDM_PL_noise1 training {pl_trained}")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s ({smi})")
    csrc = "qiddm_tpu_torch/csrc/"
    tpu = "qiddm_tpu/sim/pallas_gate_kernel.py:"
    rows = [  # name, source, TPU kernel line, counter, error, times key
        ("gate_chain_fwd", "gate_chain.cu", 130, "gate", max_err, "fwd"),
        ("gate_chain_bwd", "gate_chain.cu", 197, "gate_bwd", bwd_err,
         "bwd10"),
        ("sel_chain_fwd", "sel_chain.cu", 365, "sel", sel_err,
         "sel_fwd8_14_10_cz"),
        ("sel_chain_bwd", "sel_chain.cu", 384, "sel_bwd", sel_bwd_err,
         "sel_bwd8_14_10_cz"),
        ("ry_chain_fwd", "ry_chain.cu", 703, "ry", ry_err, "ry_fwd8_10_12"),
        ("ry_chain_bwd", "ry_chain.cu", 732, "ry_bwd", ry_bwd_err,
         "ry_bwd8_10_12"),
    ]
    # no single PyTorch call computes a gate chain: library_ms is null
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": csrc + src,
        "replaces": f"{tpu}{line}", "launches": launches[counter],
        "max_abs_err": err, "ms": times[key][0], "plain_ms": times[key][1],
        "bound_ms": times[key][2], "bound_by": times[key][3],
        "library_ms": None,
    } for name, src, line, counter, err, key in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
