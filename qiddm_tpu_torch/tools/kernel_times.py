"""Device times of the amplitude-damping pass (#7), the unitary-streaming
chain's forward (#13) and its adjoint (#14), the gate chains' forwards
(#1, #3) and their adjoint walks (#2, #4), the SEL chain's forward on
planes (#5) and its adjoint (#6), and the transpose, relayout and
group-product probes (P2, P3, P5) at the shapes their kernels are
measured at, through the entries
``amp_damp_kernel.amp_damp``, ``unitary_kernel.unitary_chain_planes``,
``unitary_kernel._unitary_chain_bwd_cuda``,
``gate_kernel._gate_chain_cuda``, ``ry_kernel._ry_chain_cuda``,
``gate_kernel._gate_chain_bwd_cuda``, ``ry_kernel._ry_chain_bwd_cuda``,
``sel_kernel._sel_chain_cuda``, ``sel_kernel._sel_chain_bwd_cuda``,
``probe_kernels.transpose_probe``, ``probe_kernels.reshape_probe`` and
``probe_kernels.matmul2_probe``; beside #13, its library formulation
(one complex64 ``torch.matmul`` a layer with the phase multiplies, cuBLAS
with TF32 off). On the card it also profiles 10 steady ``QNN_noise(784,
8, 14)`` training steps (#5 and #6's model; ``qnn_step``).

Each time is the median of 20 calls, CUDA events around each call behind a
spin kernel (``common.median_ms``): the device's time, without the host's
enqueue, but with the launch's own latency (~5 us: a kernel that does
nothing reads so). Beside it, each kernel's own duration, the median of
its 20 launches' device records under ``torch.profiler`` (CUPTI), which
holds neither; for #2, #4, #6 and #14 also the device time of all the
kernels of a call (a call may end in a second launch that sums dg over
the batch; #14's ends in its dU product). The
entries and their arguments are the same in earlier checkouts of the port,
so the same script times another checkout's kernels when that checkout
comes first on the path:

    python -m qiddm_tpu_torch.tools.kernel_times
    PYTHONPATH=<other checkout> python3 qiddm_tpu_torch/tools/kernel_times.py

It prints one JSON line: the package it timed, the card and its power
limit, the kernels' launch counts (one a call each), the times, the
kernels' profiled durations and the training step's profile.
``--device cpu`` runs the plain versions on the host clock (a check that
the script runs, not a device time).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

import qiddm_tpu_torch
from qiddm_tpu_torch.cli import common as cli_common
from qiddm_tpu_torch.diffusion import Diffusion
from qiddm_tpu_torch.sim import (amp_damp_kernel, gate_kernel, ry_kernel,
                                 sel_kernel, unitary_kernel)
from qiddm_tpu_torch.sim.gates import rot_matrix
from qiddm_tpu_torch.sim.sel import sel_layer_unitaries
from qiddm_tpu_torch.sim.statevector import rz_phase_planes
from qiddm_tpu_torch.tools import common, probe_kernels

# (wires, states): path A's pass (100 trajectories x 10 images at 12
# wires) and path B's (QIDDM_PL_noise1 at 8 wires)
AMP_SHAPES = ((12, 1000), (8, 1000))
AMP_STRENGTH = 0.05
# (wires, batch, L, k): the CNOT-ring route's widest block and
# QIDDM_LL_noise 784 6 14 2's width, L*k = 28
UNITARY_SHAPES = ((8, 80, 14, 2), (6, 16, 14, 2))
# (wires, batch, L*k, k) of #1: QIDDM_LL_noise 784 6 14 2's training step
# (1 image x tau 10), the sampling batch, and QIDDM-A's 10 wires x 80 rows
GATE_FWD_SHAPES = ((6, 10, 28, 2), (6, 16, 28, 2), (10, 80, 28, 2))
# of #3: QIDDM_PL_noise1 784 8 6 2's training step and the JAX package's
# A/B shape
RY_FWD_SHAPES = ((8, 10, 12, 2), (6, 11, 28, 2))
# (wires, batch, L*k, k) of #2: QIDDM_LL_noise 784 6 14 2's training step
# (1 image x tau 10), the sampling batch, and QIDDM-A's 10 wires x 80 rows
GATE_BWD_SHAPES = ((6, 10, 28, 2), (6, 16, 28, 2), (10, 80, 28, 2))
# of #4: QIDDM_PL_noise1 784 8 6 2's training step and the JAX package's
# A/B shape
RY_BWD_SHAPES = ((8, 10, 12, 2), (6, 11, 28, 2))
# (wires, batch, depth, ring) of #5: QNN_noise 784 8 14's training step (1
# image x tau 10) and sampling batch, QDenseUndirected_old_noise 60 8's
# sampling chain (6 wires, depth 60, CNOT), the dm route's 2,560 columns
# (QNN_noise 784 8 6 on the sweep's 10 images: 256 rows of rho a side), and
# the trajectory route's 12 wires at QNN's depth
SEL_FWD_SHAPES = ((8, 10, 14, "cz"), (8, 16, 14, "cz"), (6, 16, 60, "cnot"),
                  (8, 2560, 6, "cz"), (12, 10, 14, "cnot"))
# of #6: QNN_noise's training step, Qdense's chain at a batch of 10, and 12
# wires past one cluster
SEL_BWD_SHAPES = ((8, 10, 14, "cz"), (6, 10, 60, "cnot"), (12, 10, 14, "cz"))
# (rows, cols, n_iters) of P2: the TPU tool's plane and iterations
TRANSPOSE_SHAPES = ((128, 8192, 50),)
# of P3 and of P5's x (g is (rows, rows)): the TPU tool's
RESHAPE_SHAPES = ((8192, 128, 50),)
MATMUL2_SHAPES = ((128, 8192, 50),)
# the profiled training step: mnist_exm's defaults (batch 1, tau 10, Adam)
QNN_MODEL = ["QNN_noise", "784", "8", "14"]
QNN_TAU = 10
QNN_STEPS = 10


def _library_unitary(p, us, k: int):
    s = torch.zeros_like(p)
    s[0] = 1
    for layer in range(us.shape[0]):
        if layer % k == 0:
            s = s * p
        s = torch.matmul(us[layer], s)
    return s


def profiled_ms(fn, kernel: str, reps: int = 20) -> float | None:
    """The median device duration, in ms, of the launches whose name holds
    ``kernel`` over ``reps`` calls of ``fn`` under torch.profiler; None
    when the profiler kept no record of them (it can lose device records;
    in a process that had profiled before, it once kept none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durations = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
    return float(np.median(durations)) / 1e3 if durations else None


def profiled_call_ms(fn, reps: int = 20) -> float | None:
    """The device time of all the kernels one ``fn()`` launches, in ms:
    their durations under torch.profiler summed over ``reps`` calls, over
    ``reps``; None when the profiler kept no device record."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durations = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(durations) / reps / 1e3 if durations else None


def _bwd_planes(rng, wires: int, batch: int, n_layers: int, k: int,
                device):
    """Gates, sign planes and N(0, 1) cotangents of one backward call:
    (g8, signs, gr, gi)."""
    ang = torch.as_tensor(rng.normal(size=(n_layers, wires, 3)),
                          dtype=torch.float32, device=device)
    g8 = gate_kernel._to_g8(rot_matrix(ang[..., 0], ang[..., 1],
                                       ang[..., 2]))
    signs = gate_kernel._sign_planes_on(k, wires, device)
    gr, gi = (torch.as_tensor(rng.normal(size=(2**wires, batch)),
                              dtype=torch.float32, device=device)
              for _ in range(2))
    return g8, signs, gr, gi


def _sel_inputs(rng, wires: int, batch: int, depth: int, device):
    """Normalized start planes, gates and N(0, 1) cotangents of one SEL
    call: (sr, si, g8, gr, gi)."""
    st = rng.normal(size=(2, 2**wires, batch))
    st /= np.sqrt((st ** 2).sum(axis=(0, 1), keepdims=True))
    sr, si = (torch.as_tensor(p, dtype=torch.float32, device=device)
              for p in st)
    g8, _, gr, gi = _bwd_planes(rng, wires, batch, depth, 1, device)
    return sr, si, g8, gr, gi


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, -float("inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def qnn_step(device: torch.device, seed: int = 0) -> dict:
    """``QNN_STEPS`` steady ``QNN_noise(784, 8, 14)`` training steps
    (seeded weights and image, batch 1 x tau 10, Adam) under
    ``torch.profiler``: device events a step, device busy ms a step (the
    union of kernel and copy intervals), its idle share of the profiled
    wall, #5's and #6's own us a step and their launches a step, and the
    step without the profiler (host clock, median of 20, each ending in a
    synchronise)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    net = cli_common.build_model(QNN_MODEL, seed=seed, device=device.type)
    diff = Diffusion(net).train()
    step = diff.make_train_step(
        torch.optim.Adam(diff.parameters(), lr=cli_common.FALLBACK_LR),
        QNN_TAU)
    x = torch.rand((1, 784), generator=torch.Generator().manual_seed(seed))
    x = x.to(device)
    gen = torch.Generator().manual_seed(seed)
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        step(x, gen)
        torch.cuda.synchronize(device)
        host.append(1e3 * (time.perf_counter() - t0))
    before = (sel_kernel.SEL_LAUNCHES, sel_kernel.SEL_BWD_LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(QNN_STEPS):
            step(x, gen)
        torch.cuda.synchronize(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)

    def own(name):
        return sum(e.time_range.elapsed_us() for e in dev
                   if name in e.name) / QNN_STEPS

    return {"events": len(dev) / QNN_STEPS,
            "busy_ms": busy / QNN_STEPS / 1e3,
            "idle_share": 1 - busy / wall_us,
            "sel_fwd_us": own("sel_chain_fwd"),
            "sel_bwd_us": own("sel_chain_bwd"),
            "dg_batch_sum_us": own("dg_batch_sum"),
            "launches_per_step": [
                (sel_kernel.SEL_LAUNCHES - before[0]) / QNN_STEPS,
                (sel_kernel.SEL_BWD_LAUNCHES - before[1]) / QNN_STEPS],
            "step_ms": float(np.median(host))}


def measure(device: torch.device, seed: int = 0) -> dict:
    """{name: median ms} for every case of ``AMP_SHAPES``,
    ``UNITARY_SHAPES`` (forward and backward), ``GATE_FWD_SHAPES``,
    ``RY_FWD_SHAPES``, ``GATE_BWD_SHAPES``, ``RY_BWD_SHAPES``,
    ``SEL_FWD_SHAPES``, ``SEL_BWD_SHAPES``, ``TRANSPOSE_SHAPES``,
    ``RESHAPE_SHAPES`` and ``MATMUL2_SHAPES``, the
    kernels' profiled durations on the card (for #2, #4, #6 and #14 also a
    call's device time over all its kernels), and the launch counts."""
    rng = np.random.default_rng(seed)
    times, kernels = {}, {}

    calls = {}

    def timed(name, fn, kernel=None, call=False):
        times[name] = common.median_ms(fn, device)
        if kernel is not None and device.type == "cuda":
            kernels[name] = profiled_ms(fn, kernel)
        if call and device.type == "cuda":
            calls[name] = profiled_call_ms(fn)

    cuda = device.type == "cuda"
    amp_damp_kernel.AMP_DAMP_LAUNCHES = 0
    unitary_kernel.UNITARY_LAUNCHES = unitary_kernel.UNITARY_BWD_LAUNCHES = 0
    probe_kernels.reset_launches()
    gate_kernel.LAUNCHES = ry_kernel.RY_LAUNCHES = 0
    gate_kernel.BWD_LAUNCHES = ry_kernel.RY_BWD_LAUNCHES = 0
    sel_kernel.SEL_LAUNCHES = sel_kernel.SEL_BWD_LAUNCHES = 0
    with torch.no_grad():
        for w, n in AMP_SHAPES:
            st = rng.normal(size=(n, 2**w)) + 1j * rng.normal(size=(n, 2**w))
            st /= np.linalg.norm(st, axis=1, keepdims=True)
            states = torch.as_tensor(st, dtype=torch.complex64,
                                     device=device)
            u = torch.as_tensor(rng.uniform(size=(w, n)),
                                dtype=torch.float32, device=device)
            timed(f"amp_damp w={w} N={n}",
                  lambda: amp_damp_kernel.amp_damp(states, u, AMP_STRENGTH),
                  "amp_damp_fwd_kernel")
        for w, b, L, k in UNITARY_SHAPES:
            weights = torch.as_tensor(rng.normal(size=(L, k, w, 3)) * 0.4,
                                      dtype=torch.float32, device=device)
            x = torch.as_tensor(rng.normal(size=(b, w)), dtype=torch.float32,
                                device=device)
            pr, pi = rz_phase_planes(x, w)
            lus = sel_layer_unitaries(weights, "cnot").reshape(
                L * k, 2**w, 2**w)
            ur, ui = lus.real.contiguous(), lus.imag.contiguous()
            key = f"w={w} B={b} L*k={L * k}"
            timed(f"unitary_chain {key}",
                  lambda: unitary_kernel.unitary_chain_planes(pr, pi, ur, ui,
                                                              k),
                  "unitary_chain_fwd_kernel")
            p = torch.complex(pr, pi)
            timed(f"library_unitary {key}",
                  lambda: _library_unitary(p, lus, k))
            fr, fi = unitary_kernel.unitary_chain_planes_plain(pr, pi, ur,
                                                               ui, k)
            gr, gi = (torch.as_tensor(rng.normal(size=(2**w, b)),
                                      dtype=torch.float32, device=device)
                      for _ in range(2))
            bwd = (unitary_kernel._unitary_chain_bwd_cuda if cuda
                   else unitary_kernel.unitary_chain_bwd_plain)
            args = (pr, pi, ur, ui, fr, fi, gr, gi, k)
            timed(f"unitary_chain_bwd {key}", lambda: bwd(*args),
                  "unitary_chain_bwd_kernel", call=True)
        for w, b, n, k in GATE_FWD_SHAPES:
            g8, signs, _, _ = _bwd_planes(rng, w, b, n, k, device)
            x = torch.as_tensor(rng.normal(size=(2**w, b)),
                                dtype=torch.float32, device=device)
            pr, pi = torch.cos(x), torch.sin(x)
            fwd = (gate_kernel._gate_chain_cuda if cuda
                   else gate_kernel._chain_plain)
            args = (pr, pi, g8, signs, k, w)
            timed(f"gate_chain_fwd w={w} B={b} L*k={n}", lambda: fwd(*args),
                  "gate_chain_fwd")
        for w, b, n, k in RY_FWD_SHAPES:
            g8, signs, _, _ = _bwd_planes(rng, w, b, n, k, device)
            cs = ry_kernel.ry_cs(torch.as_tensor(
                2 * rng.normal(size=(b, w)), dtype=torch.float32,
                device=device))
            fwd = ry_kernel._ry_chain_cuda if cuda else ry_kernel._ry_plain
            args = (cs, g8, signs, k, w)
            timed(f"ry_chain_fwd w={w} B={b} L*k={n}", lambda: fwd(*args),
                  "ry_chain_fwd")
        for w, b, n, k in GATE_BWD_SHAPES:
            g8, signs, gr, gi = _bwd_planes(rng, w, b, n, k, device)
            x = torch.as_tensor(rng.normal(size=(2**w, b)),
                                dtype=torch.float32, device=device)
            pr, pi = torch.cos(x), torch.sin(x)
            fr, fi = gate_kernel._chain_plain(pr, pi, g8, signs, k, w)
            args = (pr, pi, g8, signs, fr, fi, gr, gi, k, w)
            bwd = (gate_kernel._gate_chain_bwd_cuda if cuda
                   else gate_kernel.gate_chain_bwd_plain)
            timed(f"gate_chain_bwd w={w} B={b} L*k={n}", lambda: bwd(*args),
                  "gate_chain_bwd", call=True)
        for w, b, n, k in RY_BWD_SHAPES:
            g8, signs, gr, gi = _bwd_planes(rng, w, b, n, k, device)
            cs = ry_kernel.ry_cs(torch.as_tensor(
                2 * rng.normal(size=(b, w)), dtype=torch.float32,
                device=device))
            fr, fi = ry_kernel._ry_plain(cs, g8, signs, k, w)
            args = (cs, g8, signs, fr, fi, gr, gi, k, w)
            bwd = (ry_kernel._ry_chain_bwd_cuda if cuda
                   else ry_kernel.ry_chain_bwd_plain)
            timed(f"ry_chain_bwd w={w} B={b} L*k={n}", lambda: bwd(*args),
                  "ry_chain_bwd", call=True)
        for w, b, depth, ring in SEL_FWD_SHAPES:
            sr, si, g8, _, _ = _sel_inputs(rng, w, b, depth, device)
            fwd = sel_kernel._sel_chain_cuda if cuda else sel_kernel._sel_plain
            args = (sr, si, g8, w, ring)
            timed(f"sel_chain_fwd w={w} B={b} depth={depth} {ring}",
                  lambda: fwd(*args), "sel_chain_fwd")
        for w, b, depth, ring in SEL_BWD_SHAPES:
            sr, si, g8, gr, gi = _sel_inputs(rng, w, b, depth, device)
            fr, fi = sel_kernel._sel_plain(sr, si, g8, w, ring)
            args = (g8, fr, fi, gr, gi, w, ring)
            bwd = (sel_kernel._sel_chain_bwd_cuda if cuda
                   else sel_kernel.sel_chain_bwd_plain)
            timed(f"sel_chain_bwd w={w} B={b} depth={depth} {ring}",
                  lambda: bwd(*args), "sel_chain_bwd", call=True)
        for rows, cols, n in TRANSPOSE_SHAPES:
            x = torch.as_tensor(rng.random((rows, cols)),
                                dtype=torch.float32, device=device)
            timed(f"transpose_probe ({rows}, {cols}) x {n}",
                  lambda: probe_kernels.transpose_probe(x, n),
                  "probe_transpose_kernel")
        for rows, cols, n in RESHAPE_SHAPES:
            xr = torch.as_tensor(rng.random((rows, cols)),
                                 dtype=torch.float32, device=device)
            timed(f"reshape_probe ({rows}, {cols}) x {n}",
                  lambda: probe_kernels.reshape_probe(xr, n),
                  "probe_reshape_kernel")
        for rows, cols, n in MATMUL2_SHAPES:
            q, _ = np.linalg.qr(rng.normal(size=(rows, rows)))
            g = torch.as_tensor(q * 0.9999, dtype=torch.float32,
                                device=device)
            xm = torch.as_tensor(rng.random((rows, cols)),
                                 dtype=torch.float32, device=device)
            timed(f"matmul2_probe ({rows}, {rows}) @ ({rows}, {cols}) x {n}",
                  lambda: probe_kernels.matmul2_probe(g, xm, n),
                  "probe_matmul2_kernel")
    return {"times_ms": times, "kernel_ms": kernels, "call_device_ms": calls,
            "launches": {"amp_damp": amp_damp_kernel.AMP_DAMP_LAUNCHES,
                         "unitary": unitary_kernel.UNITARY_LAUNCHES,
                         "unitary_bwd": unitary_kernel.UNITARY_BWD_LAUNCHES,
                         "transpose": probe_kernels.PROBE_LAUNCHES[
                             "transpose"],
                         "reshape": probe_kernels.PROBE_LAUNCHES["reshape"],
                         "matmul2": probe_kernels.PROBE_LAUNCHES["matmul2"],
                         "gate": gate_kernel.LAUNCHES,
                         "ry": ry_kernel.RY_LAUNCHES,
                         "gate_bwd": gate_kernel.BWD_LAUNCHES,
                         "ry_bwd": ry_kernel.RY_BWD_LAUNCHES,
                         "sel": sel_kernel.SEL_LAUNCHES,
                         "sel_bwd": sel_kernel.SEL_BWD_LAUNCHES}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device (pass --device cpu "
                         "to run the plain versions)")
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
    out = {"package": qiddm_tpu_torch.__file__, "device": str(device),
           "card": common.card(device), **measure(device, args.seed)}
    if device.type == "cuda":
        out["qnn_step"] = qnn_step(device, args.seed)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
