"""Experiment logging: JSONL + stdout.

Port of `xfmr_rec_tpu/utils/logging.py`: every metric dict is appended to
`<log_dir>/<run_name>/metrics.jsonl` as one row `{"step", "time", **metrics}`
(the same rows as the reference), and the hyperparameters are archived as
`config.json` beside it. The reference's optional TensorBoard and MLflow
sinks are not carried over: the port depends on neither package.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any


class MetricsLogger:
    """`write=False` keeps the paths and writes nothing (a process other
    than the first of a process group)."""

    def __init__(
        self, log_dir: str | pathlib.Path, run_name: str = "run", *,
        write: bool = True,
    ) -> None:
        self.log_dir = pathlib.Path(log_dir) / run_name
        self._jsonl = None
        if write:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = (self.log_dir / "metrics.jsonl").open("a")
        self._start = time.time()

    def log_hyperparams(self, params: dict[str, Any]) -> None:
        if self._jsonl is None:
            return
        (self.log_dir / "config.json").write_text(
            json.dumps(params, indent=2, default=str)
        )

    def log_metrics(self, metrics: dict[str, Any], step: int) -> None:
        if self._jsonl is None:
            return
        record = {
            "step": step,
            "time": round(time.time() - self._start, 3),
            **{key: float(value) for key, value in metrics.items()},
        }
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
