"""Device times of the amplitude-damping pass (#7) and the unitary-streaming
chain's forward (#13) at the shapes their kernels are measured at, through
the public entries ``amp_damp_kernel.amp_damp`` and
``unitary_kernel.unitary_chain_planes``; beside #13, its library
formulation (one complex64 ``torch.matmul`` a layer with the phase
multiplies, cuBLAS with TF32 off).

Each time is the median of 20 calls, CUDA events around each call behind a
spin kernel (``common.median_ms``): the device's time, without the host's
enqueue, but with the launch's own latency (~5 us: a kernel that does
nothing reads so). Beside it, each kernel's own duration, the median of
its 20 launches' device records under ``torch.profiler`` (CUPTI), which
holds neither. The entries and their arguments are the same in earlier
checkouts of the port, so the same script times another checkout's
kernels when that checkout comes first on the path:

    python -m qiddm_tpu_torch.tools.kernel_times
    PYTHONPATH=<other checkout> python3 qiddm_tpu_torch/tools/kernel_times.py

It prints one JSON line: the package it timed, the card and its power
limit, the kernels' launch counts (one a call each), the times and the
kernels' profiled durations.
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
from qiddm_tpu_torch.sim import amp_damp_kernel, unitary_kernel
from qiddm_tpu_torch.sim.sel import sel_layer_unitaries
from qiddm_tpu_torch.sim.statevector import rz_phase_planes
from qiddm_tpu_torch.tools import common

# (wires, states): path A's pass (100 trajectories x 10 images at 12
# wires) and path B's (QIDDM_PL_noise1 at 8 wires)
AMP_SHAPES = ((12, 1000), (8, 1000))
AMP_STRENGTH = 0.05
# (wires, batch, L, k): the CNOT-ring route's widest block and
# QIDDM_LL_noise 784 6 14 2's width, L*k = 28
UNITARY_SHAPES = ((8, 80, 14, 2), (6, 16, 14, 2))


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


def measure(device: torch.device, seed: int = 0) -> dict:
    """{name: median ms} for every case of ``AMP_SHAPES`` and
    ``UNITARY_SHAPES``, the kernels' profiled durations on the card, and
    the launch counts."""
    rng = np.random.default_rng(seed)
    times, kernels = {}, {}

    def timed(name, fn, kernel=None):
        times[name] = common.median_ms(fn, device)
        if kernel is not None and device.type == "cuda":
            kernels[name] = profiled_ms(fn, kernel)

    amp_damp_kernel.AMP_DAMP_LAUNCHES = 0
    unitary_kernel.UNITARY_LAUNCHES = 0
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
    return {"times_ms": times, "kernel_ms": kernels,
            "launches": {"amp_damp": amp_damp_kernel.AMP_DAMP_LAUNCHES,
                         "unitary": unitary_kernel.UNITARY_LAUNCHES}}


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
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
