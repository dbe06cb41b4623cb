"""Device milliseconds a step of the operations launched inside the port's
`train.forward` span (the encoder over the batch's texts and the losses)."""

from benchmark import program_spans


def read(view):
    return program_spans.device_ms_per_span(view, "train.forward")
