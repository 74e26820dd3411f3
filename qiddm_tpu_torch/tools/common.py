"""What the probe tools share: the card's name, power limit and SM clock,
and the timing rule."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card(device: torch.device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, or None on the
    CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def max_sm_clock_mhz(device: torch.device) -> float:
    """``nvidia-smi``'s clocks.max.sm of the card, MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0])


# Cycles of torch.cuda._sleep ahead of each timed call (~1 ms at the
# H100's 1.98 GHz): the stream is busy while the host enqueues the call,
# so the events time the device's work, not the host's (~20-40 us of
# Python and ctypes a probe call).
SPIN_CYCLES = 2_000_000


def median_ms(fn, device: torch.device, reps: int = 20) -> float:
    """Median time of one ``fn()`` over ``reps`` calls after a warm-up: on
    the card CUDA events around the call, each behind a spin kernel that
    hides the host's enqueue (up to ~1 ms of it); on the CPU the host
    clock."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)
