"""Share (%) of the card's roofline in the searches: the least time of each
search's work (`roofline.search_least_seconds` from the `bench.search`
span's batch, items, width and k) summed, over the device time of the
operations that the search's thread launched inside its span (spans the
trace holds no mark of are left out)."""

from benchmark import roofline


def read(view):
    spans = view.spans_named("bench.search")
    pairs = [(s, t) for s, t in zip(spans, view.kernel_seconds_in(spans),
                                    strict=True) if t]
    if not pairs:
        return None
    least = sum(roofline.search_least_seconds(
        s.attrs["batch"], s.attrs["items"], s.attrs["dim"], s.attrs["top_k"])
        for s, _ in pairs)
    return 100.0 * least / sum(t for _, t in pairs)
