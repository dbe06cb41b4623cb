"""Share (%) of the card's bf16 peak that the steps' model FLOPs fill over
the traced window: forward and backward of the encoder over the non-padding
tokens of every step launched in it (`roofline.train_step_flops` from the
configuration's widths)."""

from benchmark import roofline


def read(view):
    spans = view.spans_named("bench.train_step")
    if not spans or view.window_s <= 0:
        return None
    config = view.facts["config"]
    flops = sum(roofline.train_step_flops(config, s.attrs["tokens"],
                                          s.attrs["tokens_sq"]) for s in spans)
    return 100.0 * flops / (view.window_s * roofline.BF16_FLOPS)
