"""Share (%) of the traced window's training steps that the port replayed
from CUDA graphs captured before them: its `train.step` spans that hold a
`train.graphed` span and no `train.capture` span, over every `train.step`
span. A step that captures its shape first does not count, so a window
whose shapes keep being captured anew reads low. None where the window
holds no step, or where the program marks no step as graphed or eager
(`train.eager`): a program without the graphs."""

from benchmark import program_spans


def _holding(steps, inner):
    return [any(start <= a and b <= end for a, b in inner)
            for start, end in steps]


def read(view):
    steps = program_spans.intervals(view, "train.step")
    graphed = program_spans.intervals(view, "train.graphed")
    if not steps or not (graphed or program_spans.intervals(view,
                                                            "train.eager")):
        return None
    captures = program_spans.intervals(view, "train.capture")
    held = sum(g and not c for g, c in zip(_holding(steps, graphed),
                                           _holding(steps, captures),
                                           strict=True))
    return 100.0 * held / len(steps)
