"""Small sizes for the CPU rehearsals, and the fixture that finds a card."""

from __future__ import annotations

import pytest

# traffic parameters a CPU run can hold, per driver
SMALL = {
    "retrieve": {"items": 16384, "batch": 64, "max_batches": 8,
                 "warmup_batches": 1, "trace_seconds": 0.5},
    "train": {"batch": 32, "users": 300, "movies": 400, "ratings": 20000,
              "trace_seconds": 0.5},
}


@pytest.fixture
def cuda_device():
    """The first card; skips where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
