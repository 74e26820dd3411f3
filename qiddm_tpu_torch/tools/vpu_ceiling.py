"""Measure the card's practical float32 FMA ceiling at the gate kernels'
geometry (counterpart of the TPU's ``tools/vpu_ceiling.py``).

The statevector gate chains are elementwise complex arithmetic on (d, B)
planes, so the tensor cores' peak is the wrong yardstick for them. This
probe does nothing but chained FMAs on (d, B) float32 planes, one thread an
element (``csrc/probes.cu``, ``fma_ceiling_kernel``): ``chains``
independent accumulators, ``iters`` FMAs each. chains = 1 is one dependent
chain, the floor of what dependent elementwise code reaches; 4 and 8 give
the scheduler independent FMAs, the throughput envelope. Its GFLOP/s
stands beside the nominal 67 TFLOP/s of the H100's CUDA cores.

Each record: ``d``, ``batch``, ``iters``, ``chains``, ``wall_us`` (median
CUDA-event time of one launch over ``reps``, after a warm-up, each behind
a spin kernel that hides the host's enqueue: ``common.median_ms``), ``gflops``
(2 d B iters chains over it), the device, and the card's name and power
limit from ``nvidia-smi``. ``--device cpu`` times the plain version on the
host clock instead (for the tests; no device figure).

Usage: python -m qiddm_tpu_torch.tools.vpu_ceiling [--d 1024] [--batch 80]
    [--iters 4096] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import config
from . import common
from .probe_kernels import fma_ceiling

SEED = 0


def measure(d: int, batch: int, iters: int, chains: int = 1, reps: int = 20,
            device=None) -> dict:
    """One FMA-ceiling record at (d, batch, iters, chains)."""
    dev = config.resolve_device("cuda" if device is None else device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((d, batch), generator=gen, device=dev)
    y = torch.rand((d, batch), generator=gen, device=dev)
    ms = common.median_ms(lambda: fma_ceiling(x, y, iters, chains), dev, reps)
    flops = 2.0 * d * batch * iters * chains
    return {"d": d, "batch": batch, "iters": iters, "chains": chains,
            "wall_us": 1e3 * ms, "gflops": flops / ms / 1e6,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "card": common.card(dev)}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=80)  # B*tau chain pairs
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the gate-kernel geometry and a batch of 128; the serial chain (floor)
    # and 4 and 8 independent chains (the throughput envelope) each
    records = []
    for b in sorted({args.batch, 128}):
        for chains in (1, 4, 8):
            rec = measure(args.d, b, args.iters, chains,
                          device=args.device)
            print(json.dumps(rec))
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
