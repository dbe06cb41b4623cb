"""Trainer: the training loop with in-training retrieval eval.

Port of `xfmr_rec_tpu/training/trainer.py` for the text tower on one
device:
- defaults: max_epochs 1, validation every 1/4 epoch, monitor
  val/RetrievalNormalizedDCG (max), early stopping with min_delta 0.001
  and patience 3, best / last checkpoints;
- every validation re-embeds the item corpus with the current encoder
  into a `RetrievalIndex(method="auto")` on the trainer's device (dense
  below 65,536 items, the packed scan kernels from there on) and scores
  per-user top-k retrieval with the user's train history excluded;
- checkpoints are `torch.save` files holding the parameters, the
  optimizer state, the step, the best metric and the dropout
  generator's state, so a restored run resumes with the same masks;
- `save` writes the serving artifact: `processors.json` (same keys as
  the reference), `index/`, `vocab.json` for the vocab tokenizer, and
  `encoder.npz` + `portable.json`. It writes no `encoder.msgpack` (a
  flax file) and no `users.parquet` (the port reads no parquet).

Refused with an error (not ported yet, ROADMAP.md Queue 1): two-tower
and history configs and `remat` (`training/module.py`
`check_supported`), the CF channel (`cf_rank > 0`), multi-device
training (`mesh=True`, `model_parallel > 1`, `shard_vocab`), and
`profile_dir`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import time

import numpy as np
import torch

from xfmr_rec_torch.data.module import DataConfig, RecDataModule
from xfmr_rec_torch.device import resolve_device
from xfmr_rec_torch.index.mips import RetrievalIndex
from xfmr_rec_torch.models.convert import write_portable
from xfmr_rec_torch.params import (
    INDEX_DIR,
    METRIC,
    PROCESSORS_JSON,
    VOCAB_JSON,
)
from xfmr_rec_torch.training import module as train_mod
from xfmr_rec_torch.training.metrics import retrieval_metrics
from xfmr_rec_torch.training.module import TrainConfig, TrainState
from xfmr_rec_torch.utils.logging import MetricsLogger

logger = logging.getLogger(__name__)

_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1)"


@dataclasses.dataclass
class TrainerConfig:
    """The reference's `TrainerConfig` fields and defaults."""

    max_epochs: int = 1
    max_steps: int | None = None
    max_time_s: float | None = 86400.0
    val_check_interval: float = 0.25
    limit_train_batches: float | int | None = None
    limit_val_batches: int | None = None
    # held-out interaction batches per validation for val/<LossName>
    limit_val_loss_batches: int | None = 8
    early_stopping_min_delta: float = 0.001
    early_stopping_patience: int = 3
    encode_batch_size: int = 512
    log_every_steps: int = 50
    log_dir: str = "runs"
    run_name: str = ""
    ckpt_dir: str | None = None
    # False skips the best / last checkpoint writes
    checkpointing: bool = True
    seed: int = 0
    profile_dir: str | None = None
    mesh: bool | None = None
    model_parallel: int = 1
    # log every registered loss each step (False: the train loss only;
    # the same updates)
    log_all_losses: bool = True
    shard_vocab: bool = False


def _refusals(config: TrainConfig, tc: TrainerConfig) -> list[str]:
    refused = []
    if config.cf_rank > 0:
        refused.append("the CF channel (cf_rank > 0)")
    if tc.mesh or tc.model_parallel > 1 or tc.shard_vocab:
        refused.append(
            "multi-device training (mesh, model_parallel, shard_vocab)"
        )
    if tc.profile_dir:
        refused.append("profile_dir")
    return refused


class Trainer:
    def __init__(
        self,
        config: TrainConfig | None = None,
        data: RecDataModule | DataConfig | None = None,
        trainer_config: TrainerConfig | None = None,
        *,
        device: str | torch.device = "cuda",
    ) -> None:
        self.config = config or TrainConfig()
        self.trainer_config = trainer_config or TrainerConfig()
        train_mod.check_supported(self.config)
        refused = _refusals(self.config, self.trainer_config)
        if refused:
            msg = f"{', '.join(refused)}: {_NOT_PORTED}"
            raise NotImplementedError(msg)
        self.device = resolve_device(device)
        if isinstance(data, RecDataModule):
            self.data = data
        else:
            self.data = RecDataModule(data or DataConfig())
        run_name = self.trainer_config.run_name or time.strftime(
            "%Y%m%d-%H%M%S"
        )
        self.logger = MetricsLogger(self.trainer_config.log_dir, run_name)
        self.state: TrainState | None = None
        self.best_metric = -np.inf
        self._bad_checks = 0
        self.index: RetrievalIndex | None = None

    @property
    def global_step(self) -> int:
        return 0 if self.state is None else self.state.step

    # ------------------------------------------------------------------
    def setup(self) -> None:
        if self.state is not None:
            return
        self.data.prepare_data()
        self.data.setup()
        if (
            self.config.lr_schedule != "constant"
            and self.config.total_steps is None
        ):
            # decay over the planned run: max_steps, else epochs x the
            # batches an epoch actually runs
            planned = (
                self.trainer_config.max_steps
                or self.trainer_config.max_epochs * self._num_train_batches()
            )
            self.config = dataclasses.replace(
                self.config, total_steps=max(int(planned), 1)
            )
        self.state = TrainState(
            self.config, seed=self.trainer_config.seed, device=self.device
        )
        self.logger.log_hyperparams(
            {
                "model": dataclasses.asdict(self.config),
                "data": dataclasses.asdict(self.data.config),
                "trainer": dataclasses.asdict(self.trainer_config),
                "dataset": self.data.provenance or {},
            }
        )

    def _num_train_batches(self) -> int:
        total = self.data.steps_per_epoch
        limit = self.trainer_config.limit_train_batches
        if limit is None:
            return total
        if isinstance(limit, float) and limit <= 1.0:
            return max(1, int(total * limit))
        return min(total, int(limit))

    def train_step(self, batch: dict[str, np.ndarray]) -> dict:
        """One update on a host batch; returns device metric tensors."""
        return train_mod.train_step(
            self.state,
            train_mod.batch_to_device(batch, self.device),
            log_all_losses=self.trainer_config.log_all_losses,
        )

    def fit(self) -> dict[str, float]:
        """Train with periodic validation; returns the last val metrics."""
        self.setup()
        tc = self.trainer_config
        num_batches = self._num_train_batches()
        val_every = max(1, int(num_batches * tc.val_check_interval))
        last_val: dict[str, float] = {}
        stop = False
        fit_start = time.time()
        for epoch in range(tc.max_epochs):
            if stop:
                break
            for batch_idx, batch in enumerate(self.data.train_batches(epoch)):
                if batch_idx >= num_batches:
                    break
                metrics = self.train_step(batch)
                if self.global_step % tc.log_every_steps == 0:
                    self.logger.log_metrics(metrics, self.global_step)
                if tc.max_steps and self.global_step >= tc.max_steps:
                    stop = True
                    break
                if tc.max_time_s and time.time() - fit_start > tc.max_time_s:
                    logger.info("max_time_s reached; stopping")
                    stop = True
                    break
                if (batch_idx + 1) % val_every == 0:
                    last_val = self.validate()
                    if self._early_stop_check(last_val):
                        stop = True
                        break
            if not stop:
                last_val = self.validate()
                if self._early_stop_check(last_val):
                    stop = True
        if not last_val:  # e.g. max_steps hit before any val check
            last_val = self.validate()
            self._early_stop_check(last_val)
        return last_val

    def _early_stop_check(self, val_metrics: dict[str, float]) -> bool:
        """Best-metric checkpointing + early stopping (monitor = METRIC)."""
        tc = self.trainer_config
        value = val_metrics.get(METRIC["name"])
        if value is None:
            return False
        if value > self.best_metric + tc.early_stopping_min_delta:
            self.best_metric = value
            self._bad_checks = 0
            if tc.checkpointing:
                self.save_checkpoint("best")
        else:
            self._bad_checks += 1
        if tc.checkpointing:
            self.save_checkpoint("last")
        return self._bad_checks >= tc.early_stopping_patience

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _encode_rows(self, tokens: np.ndarray) -> torch.Tensor:
        """Embeddings of a token matrix, `encode_batch_size` rows a pass,
        left on the device."""
        batch = self.trainer_config.encode_batch_size
        outs = [
            train_mod.encode(
                self.state.model,
                torch.from_numpy(tokens[start : start + batch]).to(
                    self.device
                ),
            )
            for start in range(0, len(tokens), batch)
        ]
        if not outs:
            return torch.zeros(
                (0, self.config.hidden_size), device=self.device
            )
        return torch.cat(outs)

    def build_index(self) -> RetrievalIndex:
        """Embed the full item corpus -> exact MIPS index (eval barrier)."""
        corpus = self._encode_rows(self.data.item_tokens)
        metadata = [
            {"movie_text": text, "movie_rn": int(rn)}
            for text, rn in zip(
                self.data.item_texts, self.data.item_rns, strict=True
            )
        ]
        self.index = RetrievalIndex(
            corpus,
            self.data.item_ids,
            metadata,
            id_col="movie_id",
            dtype=self.config.index_dtype,
            method="auto",
            device=self.device,
        )
        return self.index

    def _eval_retrieval(self, subset: str) -> dict[str, float]:
        index = self.build_index()
        top_k = self.config.top_k
        totals: dict[str, float] = {}
        count = 0
        limit = self.trainer_config.limit_val_batches
        for batch_idx, batch in enumerate(self.data.eval_batches(subset)):
            if limit is not None and batch_idx >= limit:
                break
            users = self._encode_rows(batch["user_tokens"])
            _, pred_ids = index.search(
                users,
                top_k=top_k,
                exclude_positions=batch["exclude_positions"],
            )
            # zero the padded rows' targets: the metrics drop them
            valid = batch["valid"][:, None]
            metrics = retrieval_metrics(
                torch.from_numpy(pred_ids),
                torch.from_numpy(batch["target_ids"] * valid),
                torch.from_numpy(batch["target_ratings"] * valid),
                top_k=top_k,
                prefix=f"{subset}/",
            )
            weight = int(batch["valid"].sum())
            for key, value in metrics.items():
                totals[key] = totals.get(key, 0.0) + float(value) * weight
            count += weight
        return {key: value / max(count, 1) for key, value in totals.items()}

    def _eval_losses(self, subset: str) -> dict[str, float]:
        """The loss family averaged over held-out interaction batches."""
        limit = self.trainer_config.limit_val_loss_batches
        totals: dict[str, torch.Tensor] = {}
        count = 0
        for batch_idx, batch in enumerate(
            self.data.eval_interaction_batches(subset)
        ):
            if limit is not None and batch_idx >= limit:
                break
            losses = train_mod.eval_losses(
                self.state, train_mod.batch_to_device(batch, self.device)
            )
            for name, value in losses.items():
                totals[name] = totals.get(name, 0.0) + value
            count += 1
        return {
            f"{subset}/{name}": float(value) / count
            for name, value in totals.items()
        } if count else {}

    def validate(self) -> dict[str, float]:
        self.setup()
        metrics = self._eval_retrieval("val")
        metrics.update(self._eval_losses("val"))
        self.logger.log_metrics(metrics, self.global_step)
        logger.info("step %d val: %s", self.global_step, metrics)
        return metrics

    def test(self) -> dict[str, float]:
        self.setup()
        metrics = self._eval_retrieval("test")
        metrics.update(self._eval_losses("test"))
        self.logger.log_metrics(metrics, self.global_step)
        return metrics

    def embed_texts(self, texts: list[str]) -> torch.Tensor:
        """Unit-norm embeddings of raw texts (the serving tokenizer)."""
        self.setup()
        tokens = self.data.tokenizer.encode_batch(
            texts, self.config.max_length
        )
        return self._encode_rows(tokens)

    # ------------------------------------------------------------------
    # checkpointing + artifact
    # ------------------------------------------------------------------
    def _ckpt_path(self, name: str) -> pathlib.Path:
        # a path-like name resolves as given; a bare name ("best",
        # "last") always lives under this run's checkpoint directory
        if "/" in str(name):
            return pathlib.Path(name).absolute()
        base = self.trainer_config.ckpt_dir or (self.logger.log_dir / "ckpt")
        return pathlib.Path(base).absolute() / name

    def save_checkpoint(self, name: str = "last") -> None:
        path = self._ckpt_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        torch.save(
            {
                "params": self.state.model.state_dict(),
                "opt_state": self.state.optimizer.state_dict(),
                "step": self.state.step,
                "best_metric": float(self.best_metric),
                "dropout_generator": self.state.generator.get_state(),
            },
            tmp,
        )
        os.replace(tmp, path)

    def restore_checkpoint(self, name: str = "last") -> None:
        self.setup()
        saved = torch.load(
            self._ckpt_path(name), map_location=self.device, weights_only=True
        )
        self.state.model.load_state_dict(saved["params"])
        self.state.optimizer.load_state_dict(saved["opt_state"])
        self.state.step = int(saved["step"])
        self.best_metric = float(saved["best_metric"])
        self.state.generator.set_state(saved["dropout_generator"].cpu())

    def save(self, path: str | pathlib.Path) -> None:
        """Write the deployable serving artifact (encoder + index +
        config); see the module docstring for the files."""
        self.setup()
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        model_dump = dataclasses.asdict(self.config)
        data_dump = dataclasses.asdict(self.data.config)
        (path / PROCESSORS_JSON).write_text(
            json.dumps(
                {
                    "model": model_dump,
                    "data": data_dump,
                    "step": self.global_step,
                    "best_metric": float(self.best_metric),
                },
                indent=2,
            )
        )
        if self.index is None:
            self.build_index()
        self.index.save(path / INDEX_DIR)
        if hasattr(self.data.tokenizer, "vocab"):
            self.data.tokenizer.save(path / VOCAB_JSON)
        write_portable(
            self.state.model.state_dict(), model_dump, data_dump, path
        )
