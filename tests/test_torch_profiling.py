"""`utils/profiling.py` and the trainer's `profile_dir` on the CPU.

`device_trace` writes a Chrome trace (`*.pt.trace.json`) holding the
block's operators; the trainer's `profile_dir` traces exactly train steps
10-20 (ten optimizer steps in the trace), as the reference's does with
`jax.profiler`; `StepTimer` counts as the reference's does.
"""

import json

import pytest
import torch

from tests.test_torch_trainer import port_trainer
from xfmr_rec_torch.utils.profiling import StepTimer, device_trace
from xfmr_rec_tpu.data.prepare import prepare_movielens
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.utils.profiling import StepTimer as RefStepTimer


def trace_events(log_dir):
    files = sorted(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones(64, 64)
    with device_trace(str(tmp_path)):
        (a @ a).sum()
    names = {event.get("name") for event in trace_events(tmp_path)}
    assert "aten::mm" in names


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("profiledata")
    generate_movielens(
        path, num_users=40, num_movies=120, num_ratings=1200, seed=1
    )
    prepare_movielens(str(path), overwrite=True)
    return str(path)


def test_profile_dir_traces_steps_10_to_20(data_dir, tmp_path):
    trainer = port_trainer(
        data_dir, tmp_path / "runs",
        trainer=dict(max_steps=24, checkpointing=False,
                     profile_dir=str(tmp_path / "prof")),
    )
    trainer.fit()
    assert trainer.global_step == 24
    steps = [event for event in trace_events(tmp_path / "prof")
             if event.get("cat") == "user_annotation"
             and event.get("name", "").startswith("Optimizer.step#AdamW")]
    assert len(steps) == 10


def test_step_timer_counts_like_the_reference():
    timers = (StepTimer(window=3), RefStepTimer(window=3))
    for _ in range(5):
        for timer in timers:
            timer.tick()
    got, want = (timer.summary() for timer in timers)
    assert got["steps"] == want["steps"] == 5.0
    assert got["steps_per_second"] > 0
    assert len(timers[0]._times) == len(timers[1]._times) == 3
