"""Device milliseconds a step of the operations launched inside the port's
`train.optimizer` span (missing gradients filled, the global norm, AdamW's
update)."""

from benchmark import program_spans


def read(view):
    return program_spans.device_ms_per_span(view, "train.optimizer")
