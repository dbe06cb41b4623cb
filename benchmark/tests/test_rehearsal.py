"""Each driver end to end on the CPU at a small size: a well-formed result
line, and `correct` false under each fault the cell can have."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.tests.conftest import SMALL

CELLS = {"retrieve-h32-b4096": "retrieve", "train-minilm-b1024": "train"}
TRAIN = "train-minilm-b1024"


def _run(cell: str, trace: bool = False, seconds: float = 1.5) -> dict:
    return harness.run_cell(cell, 2**31 + 77, seconds, trace,
                            torch.device("cpu"), 0.0,
                            overrides=SMALL[CELLS[cell]])


def _well_formed(result: dict, capsys, trace: bool) -> dict:
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:2] == ["correct", "attempted"]
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
        assert isinstance(metric["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(text.startswith("check ") for text in last)
    return line


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_prints_a_result(cell, trace, capsys):
    line = _well_formed(_run(cell, trace), capsys, trace)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    spec = harness.load_spec()
    e2e, _ = harness.metrics_of_cell(spec, cell)
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in e2e}


def _alter_answers(monkeypatch, method: str):
    from xfmr_rec_torch.index.mips import RetrievalIndex

    inner = getattr(RetrievalIndex, method)

    def altered(self, *args, **kwargs):
        scores, ids = inner(self, *args, **kwargs)
        ids = ids.copy()
        ids[0, 0] = ids[0, -1]  # an item twice, where the answer is made
        return scores, ids

    monkeypatch.setattr(RetrievalIndex, method, altered)


def test_altered_answer_fails_retrieval(monkeypatch):
    _alter_answers(monkeypatch, "search_certified")
    assert _run("retrieve-h32-b4096")["correct"] is False


def test_unchanged_state_fails_training(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    result = _run(TRAIN)
    assert result["correct"] is False
    assert result["checks"]["train_change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_fails_training(monkeypatch):
    from xfmr_rec_torch.training.trainer import Trainer

    inner = Trainer.train_step

    def half(self, batch):
        rows = len(batch["user_tokens"])
        cut = {k: v[: rows // 2] for k, v in batch.items() if len(v) == rows}
        cut["item_idx"] = np.concatenate([batch["item_idx"][: rows // 2],
                                          batch["item_idx"][rows : rows + rows // 2]])
        cut["log_q"] = np.concatenate([batch["log_q"][: rows // 2],
                                       batch["log_q"][rows : rows + rows // 2]])
        return inner(self, cut)

    monkeypatch.setattr(Trainer, "train_step", half)
    result = _run(TRAIN)
    assert result["correct"] is False
    assert result["checks"]["train_loss_gap"]["value"] > 0.2


def test_altered_token_fails_training(monkeypatch):
    from xfmr_rec_torch.data.module import RecDataModule

    inner = RecDataModule._assemble_loss_batch

    def altered(self, *args, **kwargs):
        batch = inner(self, *args, **kwargs)
        batch["item_tokens"] = batch["item_tokens"].copy()
        batch["item_tokens"][0, 1] += 1  # where the batch is made
        return batch

    monkeypatch.setattr(RecDataModule, "_assemble_loss_batch", altered)
    result = _run(TRAIN)
    assert result["correct"] is False
    assert result["checks"]["train_rows_off"]["value"] >= 1
