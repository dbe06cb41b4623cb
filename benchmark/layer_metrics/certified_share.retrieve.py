"""Share (%) of the traced window's rows that the guaranteed-exact search
answered without its dense fallback: `RetrievalIndex.last_certified_stats`
after each call, summed over the window."""


def read(view):
    rows = view.counter_delta("rows")
    dense = view.counter_delta("dense_rows")
    if not rows:
        return None
    return 100.0 * (rows - dense) / rows
