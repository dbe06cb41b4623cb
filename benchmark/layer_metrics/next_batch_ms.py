"""Mean host milliseconds the data layer took to assemble a training batch:
the port's `data.batch` span inside `RecDataModule.train_batches`."""

from benchmark import program_spans


def read(view):
    return program_spans.mean_ms(view, "data.batch")
