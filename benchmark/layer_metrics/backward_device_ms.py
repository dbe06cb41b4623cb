"""Device milliseconds a step of the operations launched inside the port's
`train.backward` span, on any thread (autograd launches from its own)."""

from benchmark import program_spans


def read(view):
    return program_spans.device_ms_per_span(view, "train.backward")
