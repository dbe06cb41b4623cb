"""Mean host milliseconds of a training step's batch upload: the port's
`train.to_device` span (`batch_to_device`)."""

from benchmark import program_spans


def read(view):
    return program_spans.mean_ms(view, "train.to_device")
