"""Each cell end to end on the card, at a small size and a short window."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.test_control import CARD, CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(cell, trace, cuda_device):
    driver = harness.traffic_of(harness.cell_entry(harness.load_spec(), cell))
    result = harness.run_cell(cell, 2**31 + 9, 3.0, trace, cuda_device, 0.0,
                              overrides=dict(CARD[driver["driver"]],
                                             trace_seconds=1.0))
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
