"""The control (the reference one precision below the configuration's) and
the half-batch fault come out as not correct by the runs' own checks
(`harness.checks_from`, `Check.ok`), and the port's readings as correct.

On the CPU at a small size; with a card, at a size between that and the
cell's own (the cell's own sizes are read on the card by
`python3 -m benchmark.control`, which logs the same verdicts, and
`PERF.md` gives those readings).
"""

from __future__ import annotations

import math
import pathlib

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import SMALL

CELLS = ["retrieve-h32-b4096", "train-minilm-b1024"]
CARD = {
    "retrieve": {"items": 1 << 18, "batch": 1024, "max_batches": 2,
                 "check_batches": 2},
    "train": {"users": 1000, "movies": 1000, "ratings": 100000},
}


def _readings(cell_name: str, device, overrides: dict, tmp_path) -> tuple:
    spec = harness.load_spec()
    cell = harness.cell_entry(spec, cell_name)
    traffic = dict(harness.traffic_of(cell), **overrides)
    run = harness.Run(cell=cell, config=harness.config_of(spec, cell),
                      traffic=traffic, seed=2**31 + 5, seconds=5.0,
                      trace=False, device=device,
                      run_dir=pathlib.Path(tmp_path), process_start=0.0)
    return control.READINGS[traffic["driver"]](run), traffic["limits"]


def _assert_controls_fail(cell_name, device, overrides, tmp_path):
    readings, limits = _readings(cell_name, device, overrides, tmp_path)
    assert not control.verdict(readings["control"], limits), readings
    if "half_batch" in readings:
        assert not control.verdict(readings["half_batch"], limits), readings
    if "program" in readings:
        assert control.verdict(readings["program"], limits), readings


def test_verdict_is_the_runs_own_check():
    limits = {"gap": 0.5, "rows_off": 0}
    assert control.verdict({"gap": 0.5}, limits)
    assert not control.verdict({"gap": 0.6}, limits)
    assert not control.verdict({"gap": math.nan}, limits)
    assert not control.verdict({"gap": math.inf}, limits)
    assert not control.verdict({"gap": 0.1, "rows_off": 1}, limits)


def _driver(cell: str) -> str:
    return harness.traffic_of(harness.cell_entry(harness.load_spec(),
                                                 cell))["driver"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_cpu(cell, tmp_path):
    _assert_controls_fail(cell, torch.device("cpu"), SMALL[_driver(cell)],
                          tmp_path)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, cuda_device, tmp_path):
    _assert_controls_fail(cell, cuda_device, CARD[_driver(cell)], tmp_path)
