"""Phase timers and a device trace (counterpart of ``qiddm_tpu/profiler.py``).

``PhaseTimer`` sums wall time per named phase. ``device_trace(logdir)``
records the enclosed region with ``torch.profiler`` (host and, where a
card is present, CUDA activity) and writes a Chrome trace into ``logdir``
(``chrome://tracing`` or Perfetto reads it), where the JAX package writes
an xprof trace.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    """Accumulates wall time per named phase.

    with timer.phase("train_epoch"): ...
    timer.summary() -> {"train_epoch": {"total_s": ..., "count": ...}}
    """

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self._acc[k], "count": self._count[k],
                "mean_s": self._acc[k] / max(self._count[k], 1)}
            for k in self._acc
        }

    def report(self) -> str:
        lines = [f"{k:24s} total={v['total_s']:8.3f}s n={v['count']:4d} "
                 f"mean={v['mean_s']*1e3:8.2f}ms"
                 for k, v in sorted(self.summary().items())]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record the enclosed region under ``torch.profiler`` and write it as
    a Chrome trace, ``<logdir>/trace_<time in ns>.json`` (one file a
    region, as the JAX profiler writes a run directory a trace). CUDA
    activity is recorded when a card is present, so the trace names each
    kernel launched."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    out = path / f"trace_{time.time_ns()}.json"
    prof.export_chrome_trace(str(out))
    print(f"device trace written to {out}")


GLOBAL_TIMER = PhaseTimer()
