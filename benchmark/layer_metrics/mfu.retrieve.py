"""Share (%) of the card's bf16 peak that the batches' scoring fills over
the traced window: 2·B·N·D a batch finished in it."""

from benchmark import roofline


def read(view):
    spans = view.spans_named("bench.search")
    if not spans or view.window_s <= 0:
        return None
    flops = sum(roofline.search_flops(s.attrs["batch"], s.attrs["items"],
                                      s.attrs["dim"]) for s in spans)
    return 100.0 * flops / (view.window_s * roofline.BF16_FLOPS)
