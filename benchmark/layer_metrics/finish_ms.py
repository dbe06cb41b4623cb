"""Mean host milliseconds of a certified search's finish: the port's
`index.finish` span (the answers' copies to the host, the rows left
uncertified, the dense fallback, the id map)."""

from benchmark import program_spans


def read(view):
    return program_spans.mean_ms(view, "index.finish")
