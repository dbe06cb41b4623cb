"""Profiling helpers: `torch.profiler` traces and the program's spans.

Port of `xfmr_rec_tpu/utils/profiling.py`: `device_trace` records the
host's operators and, where a card is visible, its kernels into
`log_dir` in the Chrome trace format (`torch.profiler`'s
`tensorboard_trace_handler`: one `*.pt.trace.json` a trace, readable by
TensorBoard's profiler plugin or chrome://tracing).

`span(name)` marks a phase of the program (`index.*`, `train.*`,
`data.batch`). While a `torch.profiler` records, it is a
`record_function`: a `user_annotation` range in the same trace, on the
same clock, as the operators, the CUDA runtime calls and the kernels they
launch. Otherwise it is one shared null context, built once, and costs a
test of the profiler's state. The spans are kept nowhere else.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A profiler range named `name` while a profiler records, else the
    shared null context (no `record_function` built, no dispatcher
    call)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
