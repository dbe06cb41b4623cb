"""Mean host milliseconds of a certified search's pipeline: the port's
`index.pipeline` span (pass 1, the retry rounds and the syncs that decide
them)."""

from benchmark import program_spans


def read(view):
    return program_spans.mean_ms(view, "index.pipeline")
