"""The reader of `graph_steps.train`: the share of the window's train
steps that hold a `train.graphed` span and no `train.capture` span, on
hand-built views."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.test_program_spans import view


def _read(host_ops):
    return harness.reader_module("graph_steps.train").read(
        view(host_ops=host_ops))


def _steps(kinds):
    """A `train.step` span every 100 us, each holding a span of its kind
    (`None`: neither graphed nor eager, as a program without graphs)."""
    ops = []
    for i, kind in enumerate(kinds):
        start = 100.0 * i
        ops.append(("train.step", 1, start, 90.0))
        if kind is not None:
            ops.append((f"train.{kind}", 1, start + 5.0, 80.0))
    return ops


@pytest.mark.parametrize(
    "kinds,share",
    [
        (["graphed"] * 4, 100.0),
        (["eager"] * 4, 0.0),
        (["graphed", "graphed", "eager", "graphed"], 75.0),
        ([None] * 4, None),
        ([], None),
    ],
)
def test_share_of_steps_graphed(kinds, share):
    got = _read(_steps(kinds))
    assert got == (None if share is None else pytest.approx(share))


def test_a_capture_then_replay_counts_as_graphed():
    """The steps that replay a capture count; the step that captured
    does not, though it replays too."""
    ops = _steps(["graphed"] * 4)
    ops.append(("train.capture", 1, 2.0, 2.0))
    assert _read(ops) == pytest.approx(75.0)


def test_steps_that_each_capture_anew_read_zero():
    ops = _steps(["graphed"] * 3)
    ops += [("train.capture", 1, 100.0 * i + 2.0, 2.0) for i in range(3)]
    assert _read(ops) == pytest.approx(0.0)


def test_only_steps_that_ended_in_the_window_count():
    # the second step ends after the window (1000 us)
    ops = _steps(["graphed"]) + [("train.step", 1, 950.0, 90.0),
                                 ("train.eager", 1, 955.0, 80.0)]
    assert _read(ops) == pytest.approx(100.0)


def test_graph_steps_is_a_program_span_of_the_training_cell():
    spec = harness.load_spec()
    (entry,) = [m for m in spec["per_layer"]
                if m["name"] == "graph_steps.train"]
    assert entry["source"] == "program_span"
    assert entry["layer"] == "whole step"
    assert entry["workloads"] == ["train-minilm-b1024"]
    _, layers = harness.metrics_of_cell(spec, "train-minilm-b1024")
    assert entry in layers
