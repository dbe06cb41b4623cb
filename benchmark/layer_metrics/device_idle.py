"""Share (%) of the traced window in which no operation ran on the card,
from the profiler's device trace."""


def read(view):
    if view.window_s <= 0 or not view.kernels:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
