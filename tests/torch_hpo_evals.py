"""Evaluators that the trial workers of `tests/test_torch_hpo_executor.py`
import by the `{"kind": "import"}` spec (closures don't pickle).

This module imports neither JAX nor torch at import time: every spawned
worker imports it, and a worker that imported JAX would start it.
"""

import math
import os
import time


def eval_deterministic(config, resource):
    """Pure function of (config, resource): the same answer in any
    process."""
    quality = 1.0 / (1 + abs(math.log10(config["learning_rate"]) + 3))
    return {"val/RetrievalNormalizedDCG": quality * resource}


def eval_sleepy(config, resource):
    """Records its own wall-clock window and pid, so the parent can show
    that trials overlapped in separate processes."""
    t0 = time.time()
    time.sleep(1.0)
    out = eval_deterministic(config, resource)
    out["t_start"] = t0
    out["t_end"] = time.time()
    out["pid"] = float(os.getpid())
    return out


def eval_flaky(config, resource):
    """Fails for half the space: a failing trial must stay a data point."""
    if config["learning_rate"] > 1e-3:
        msg = "synthetic trial failure"
        raise ValueError(msg)
    return eval_deterministic(config, resource)


def eval_dying(config, resource):
    """Kills its worker for half the space: a dead worker is a failed
    trial, and its pool takes the next job in a fresh process."""
    if config["learning_rate"] > 1e-3:
        os._exit(3)
    return eval_deterministic(config, resource)


def eval_device_probe(config, resource):
    """What the worker sees: its pid, its CUDA_VISIBLE_DEVICES and the
    cards torch counts."""
    import torch

    return {
        "pid": float(os.getpid()),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "device_count": float(torch.cuda.device_count()),
    }
