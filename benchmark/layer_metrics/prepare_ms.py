"""Mean host milliseconds of a certified search's preparation: the port's
`index.prepare` span (the queries to the host, padded, uploaded, and the
score bound)."""

from benchmark import program_spans


def read(view):
    return program_spans.mean_ms(view, "index.prepare")
