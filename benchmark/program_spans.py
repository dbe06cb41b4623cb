"""The port's own spans in a traced window, for the readers that use them.

The port marks its phases with `xfmr_rec_torch/utils/profiling.py`
`span`: while the profiler records, a `record_function` range, which the
trace holds as a `user_annotation` event and `TraceView` files in
`host_ops` beside the operators, on the profiler's clock. A phase's device
time is that of the operations whose launch falls inside its span, on any
thread: autograd launches the backward from a thread of its own.
"""

from __future__ import annotations

import bisect


def intervals(view, name: str) -> list[tuple[float, float]]:
    """(start, end) in us of the spans `name` that ended inside the traced
    window, by start."""
    return sorted(
        (start, start + dur) for op, _, start, dur in view.host_ops
        if op == name and view.start_us <= start + dur <= view.end_us)


def mean_ms(view, name: str) -> float | None:
    """Mean host milliseconds of the spans `name`; None where the trace
    holds none."""
    spans = intervals(view, name)
    if not spans:
        return None
    return sum(end - start for start, end in spans) / len(spans) / 1e3


def launch_times(view) -> list[tuple[float, float]]:
    """(launch time in us, device seconds) of each operation on the device.
    The launch is its CUDA runtime call, on whatever thread made it. An
    operation whose launch the view does not hold (cuBLASLt launches its
    GEMMs with `cuLaunchKernelEx`) takes the launch of the operation
    before it on the device: one stream runs in the order it was given
    work."""
    out = []
    last = None
    for _, start, dur, corr in sorted(view.kernels, key=lambda k: k[1]):
        launch = view.launches.get(corr)
        if launch is not None:
            last = launch[1]
        if last is not None:
            out.append((last, dur / 1e6))
    return out


def device_seconds(view, spans: list[tuple[float, float]]) -> float:
    """Device seconds of the operations launched inside one of `spans`
    (disjoint, by start)."""
    starts = [start for start, _ in spans]
    total = 0.0
    for at, seconds in launch_times(view):
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= spans[i][1]:
            total += seconds
    return total


def device_ms_per_span(view, name: str) -> float | None:
    """Device milliseconds launched inside the spans `name`, a span; None
    where the trace holds none."""
    spans = intervals(view, name)
    if not spans:
        return None
    return 1e3 * device_seconds(view, spans) / len(spans)
