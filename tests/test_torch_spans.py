"""The program's spans (`utils/profiling.py` `span`) on the CPU.

Under `device_trace` the certified search writes `index.search_certified`
holding `index.prepare`, `index.pipeline` (one `index.sweep` for pass 1
and one a retry round) and `index.finish` (with `index.dense` where rows
fall back); `Trainer.train_step` writes `train.step` holding
`train.to_device` and, on the CPU, `train.eager`, which holds
`train.forward`, `train.backward` and `train.optimizer`;
`train_batches` writes one `data.batch` a batch, around its assembly
only; the trainer's `profile_dir` trace holds the
`train.*` spans. With no profiler, `span` is the shared null context and
builds no `record_function`.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_certified import K, planted
from xfmr_rec_torch.data.module import DataConfig, RecDataModule
from xfmr_rec_torch.index import mips
from xfmr_rec_torch.index.mips import RetrievalIndex
from xfmr_rec_torch.ops import topk
from xfmr_rec_torch.training.module import TrainConfig
from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig
from xfmr_rec_torch.utils import profiling
from xfmr_rec_torch.utils.profiling import device_trace, span

MODEL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
             intermediate_size=32, vocab_size=500, max_position_embeddings=32,
             max_length=16, compute_dtype="float32")
DATA = dict(batch_size=8, eval_batch_size=16, max_length=16, vocab_size=500,
            synthetic_users=40, synthetic_movies=120, synthetic_ratings=1200)
TRAIN_PHASES = ["train.to_device", "train.forward", "train.backward",
                "train.optimizer"]


def annotations(log_dir) -> list[tuple[str, int, float, float]]:
    """(name, thread, start, end) of the trace's `user_annotation` ranges,
    by start."""
    (path,) = log_dir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(
        ((e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + e["dur"])
         for e in events
         if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
        key=lambda a: a[2])


def inside(child, parent) -> bool:
    return (child[1] == parent[1] and parent[2] <= child[2]
            and child[3] <= parent[3])


def named(spans, prefix: str) -> list:
    return [s for s in spans if s[0].startswith(prefix)]


def planted_index():
    """The index and queries of `planted`: rows that retry and a row that
    falls back to the dense path, in every method."""
    queries, corpus = planted(430)
    return RetrievalIndex(corpus, np.arange(len(corpus)), method="scan",
                          device="cpu"), queries


@pytest.mark.parametrize("method", ["fused", "packed", "f32"])
def test_certified_search_spans_nest(method, tmp_path, monkeypatch):
    index, queries = planted_index()
    shuffles = []

    def counted(inner):
        def sweep(*args, **kwargs):
            shuffles.append(kwargs["lane_shuffle"])
            return inner(*args, **kwargs)
        return sweep

    # the fused pipeline calls the ops module's function, the host
    # escalation the index module's names
    monkeypatch.setattr(topk, "packed_certified_parts",
                        counted(topk.packed_certified_parts))
    monkeypatch.setattr(mips, "packed_certified_parts",
                        counted(mips.packed_certified_parts))
    monkeypatch.setattr(mips, "certified_topk_parts",
                        counted(mips.certified_topk_parts))
    with device_trace(str(tmp_path)):
        index.search_certified(queries, top_k=K, method=method)
    spans = named(annotations(tmp_path), "index.")
    (parent,) = named(spans, "index.search_certified")
    phases = [s for s in spans
              if s[0] in ("index.prepare", "index.pipeline", "index.finish")]
    assert [s[0] for s in phases] == ["index.prepare", "index.pipeline",
                                      "index.finish"]
    assert all(inside(s, parent) for s in phases)
    assert all(a[3] <= b[2] for a, b in zip(phases, phases[1:]))
    sweeps = named(spans, "index.sweep")
    retries = sum(1 for shuffle in shuffles if shuffle)
    assert retries >= 1
    assert len(sweeps) == len(shuffles) == 1 + retries
    assert all(inside(s, phases[1]) for s in sweeps)
    dense = named(spans, "index.dense")
    stats = index.last_certified_stats
    assert stats.get("pipeline_bad", stats.get("retry_bad")) > 0
    assert len(dense) == 1
    assert all(inside(s, phases[2]) for s in dense)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    trainer = Trainer(
        TrainConfig(**MODEL),
        data=RecDataModule(DataConfig(data_dir=str(root / "data"), **DATA)),
        trainer_config=TrainerConfig(log_dir=str(root / "logs"),
                                     run_name="r", checkpointing=False),
        device="cpu",
    )
    trainer.setup()
    return trainer


def test_train_step_spans_hold_its_phases(trainer, tmp_path):
    batch = next(trainer.data.train_batches(0))
    with device_trace(str(tmp_path)):
        trainer.train_step(batch)
    spans = named(annotations(tmp_path), "train.")
    (step,) = named(spans, "train.step")
    (eager,) = named(spans, "train.eager")
    phases = [s for s in spans if s[0] not in ("train.step", "train.eager")]
    assert [s[0] for s in phases] == TRAIN_PHASES
    assert inside(phases[0], step) and inside(eager, step)
    assert all(inside(s, eager) for s in phases[1:])


def test_one_data_batch_span_per_batch_around_its_assembly(trainer,
                                                           tmp_path):
    batches = 0
    with device_trace(str(tmp_path)):
        for _ in trainer.data.train_batches(1):
            with torch.profiler.record_function("consumer"):
                batches += 1
    spans = annotations(tmp_path)
    assembled = named(spans, "data.batch")
    consumers = named(spans, "consumer")
    assert batches == trainer.data.steps_per_epoch > 1
    assert len(assembled) == len(consumers) == batches
    # the consumer's work between two batches is in no batch's span
    assert not any(c[2] < a[3] and a[2] < c[3]
                   for a in assembled for c in consumers)


def test_no_profiler_no_record_function(trainer, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler")

    # the name `span` builds through (AdamW builds its own ranges through
    # `torch.autograd.profiler`, whatever the profiler's state)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("index.sweep") is span("train.step") is profiling._NO_SPAN
    index, queries = planted_index()
    index.search_certified(queries, top_k=K, method="fused")
    trainer.train_step(next(trainer.data.train_batches(2)))


def test_profile_dir_trace_holds_the_train_spans(tmp_path):
    trainer = Trainer(
        TrainConfig(**MODEL),
        data=RecDataModule(DataConfig(data_dir=str(tmp_path / "data"),
                                      **DATA)),
        trainer_config=TrainerConfig(
            log_dir=str(tmp_path / "logs"), run_name="r", max_steps=12,
            checkpointing=False, profile_dir=str(tmp_path / "prof")),
        device="cpu",
    )
    trainer.fit()
    spans = annotations(tmp_path / "prof")
    steps = named(spans, "train.step")
    assert len(steps) == 2  # steps 11 and 12: traced from global step 10
    for name in TRAIN_PHASES:
        phases = named(spans, name)
        assert len(phases) == len(steps)
        assert all(any(inside(p, s) for s in steps) for p in phases)
