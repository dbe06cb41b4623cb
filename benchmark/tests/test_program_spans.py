"""The readers of the port's own spans (`benchmark/program_spans.py` and
the `program_span` metrics of BENCHMARK.json that read them)."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import SMALL
from benchmark.tests.test_control import CARD

HOST_MS = {
    "retrieve-h32-b4096": ["prepare_ms.retrieve", "pipeline_ms.retrieve",
                           "finish_ms.retrieve"],
    "train-minilm-b1024": ["next_batch_ms.train", "to_device_ms.train"],
}
DEVICE_MS = ["forward_device_ms.train", "backward_device_ms.train",
             "optimizer_device_ms.train"]
NINE = (HOST_MS["retrieve-h32-b4096"] + ["sweeps.retrieve"]
        + HOST_MS["train-minilm-b1024"] + DEVICE_MS)
CELL_OF = {name: cell for cell, names in HOST_MS.items() for name in names}
CELL_OF["sweeps.retrieve"] = "retrieve-h32-b4096"
CELL_OF.update(dict.fromkeys(DEVICE_MS, "train-minilm-b1024"))


def _reader(name: str):
    return harness.reader_module(name).read


def view(kernels=(), launches=None, host_ops=()) -> harness.TraceView:
    return harness.TraceView(
        start_us=0.0, end_us=1000.0, kernels=list(kernels),
        launches=dict(launches or {}), host_ops=list(host_ops), marks=[],
        spans=[])


def test_the_nine_are_program_spans_of_their_cells():
    spec = harness.load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NINE:
        entry = entries[name]
        assert entry["source"] == "program_span"
        assert entry["workloads"] == [CELL_OF[name]]
        _, layers = harness.metrics_of_cell(spec, CELL_OF[name])
        assert entry in layers


@pytest.mark.parametrize("cell", sorted(HOST_MS))
def test_traced_rehearsal_reads_the_span_metrics(cell):
    mix = harness.traffic_of(harness.cell_entry(harness.load_spec(), cell))
    # a CPU step takes most of a second: trace two seconds of three
    result = harness.run_cell(cell, 2**31 + 101, 3.0, True,
                              torch.device("cpu"), 0.0,
                              overrides=dict(SMALL[mix["driver"]],
                                             trace_seconds=2.0))
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    for name in HOST_MS[cell]:
        assert metrics[name] > 0
    if cell.startswith("retrieve"):
        assert metrics["sweeps.retrieve"] >= 1
    else:
        # no device on the CPU: the spans are there, their device time 0
        assert all(metrics[name] == 0.0 for name in DEVICE_MS)


def test_device_time_counts_launches_of_any_thread_inside_the_span():
    spans = [("train.backward", 1, 100.0, 100.0)]  # 100 us to 200 us
    kernels = [
        ("inside, second thread", 300.0, 40.0, 1),
        ("outside", 350.0, 7.0, 2),
        ("inside, main thread", 120.0, 5.0, 3),
        ("no runtime launch, after 3", 125.0, 11.0, -1),
    ]
    launches = {1: (2, 150.0), 2: (2, 250.0), 3: (1, 110.0)}
    got = _reader("backward_device_ms.train")(
        view(kernels, launches, spans))
    assert got == pytest.approx((40.0 + 5.0 + 11.0) / 1e3)


def test_means_and_sweeps_over_the_window():
    host = [("index.search_certified", 1, 0.0, 30.0),
            ("index.search_certified", 1, 40.0, 30.0),
            ("index.sweep", 1, 5.0, 4.0), ("index.sweep", 1, 45.0, 4.0),
            ("index.sweep", 1, 52.0, 4.0),
            ("index.prepare", 1, 1.0, 2000.0),  # ends after the window
            ("index.prepare", 1, 41.0, 3.0), ("index.prepare", 1, 2.0, 1.0)]
    v = view(host_ops=host)
    assert _reader("sweeps.retrieve")(v) == pytest.approx(1.5)
    assert _reader("prepare_ms.retrieve")(v) == pytest.approx(2.0 / 1e3)


@pytest.mark.parametrize("name", NINE)
def test_a_reader_without_its_spans_reads_none(name):
    other = [("bench.search", 1, 10.0, 50.0), ("aten::mm", 1, 20.0, 5.0)]
    assert _reader(name)(view([("k", 30.0, 5.0, 1)], {1: (1, 21.0)},
                              other)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(HOST_MS))
def test_the_span_metrics_are_read_on_the_card(cell, cuda_device):
    mix = harness.traffic_of(harness.cell_entry(harness.load_spec(), cell))
    result = harness.run_cell(cell, 2**31 + 13, 3.0, True, cuda_device, 0.0,
                              overrides=dict(CARD[mix["driver"]],
                                             trace_seconds=1.0))
    assert result["correct"] is True, result["checks"]
    read = {k: v["value"] for k, v in result["metrics"].items()}
    mine = [name for name in NINE if CELL_OF[name] == cell]
    assert all(read.get(name, 0) > 0 for name in mine), read
