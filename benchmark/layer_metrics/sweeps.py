"""Corpus sweeps a certified search: the port's `index.sweep` spans (pass 1
and one a retry round) over its `index.search_certified` spans."""

from benchmark import program_spans


def read(view):
    searches = program_spans.intervals(view, "index.search_certified")
    if not searches:
        return None
    return len(program_spans.intervals(view, "index.sweep")) / len(searches)
