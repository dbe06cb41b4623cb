"""Profiling helpers: `torch.profiler` traces and host-side step timing.

Port of `xfmr_rec_tpu/utils/profiling.py`: `device_trace` records the
host's operators and, where a card is visible, its kernels into
`log_dir` in the Chrome trace format (`torch.profiler`'s
`tensorboard_trace_handler`: one `*.pt.trace.json` a trace, readable by
TensorBoard's profiler plugin or chrome://tracing); `StepTimer` is a
cheap rolling step rate.
"""

from __future__ import annotations

import contextlib
import time
from collections.abc import Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block: CPU operators, and CUDA kernels when a card is
    visible. The card is synchronized before the trace stops, so every
    kernel launched inside the block is in it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()


class StepTimer:
    """Rolling step-rate tracker: `timer.tick()` per step, `.summary()`."""

    def __init__(self, window: int = 100) -> None:
        self.window = window
        self._times: list[float] = []
        self._count = 0

    def tick(self) -> None:
        self._count += 1
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def steps_per_second(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / max(span, 1e-9)

    def summary(self) -> dict[str, float]:
        return {
            "steps": float(self._count),
            "steps_per_second": self.steps_per_second,
        }
