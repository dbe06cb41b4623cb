"""Trainer: the training loop with in-training retrieval eval.

Port of `xfmr_rec_tpu/training/trainer.py` on one device:
- defaults: max_epochs 1, validation every 1/4 epoch, monitor
  val/RetrievalNormalizedDCG (max), early stopping with min_delta 0.001
  and patience 3, best / last checkpoints;
- every validation re-embeds the item corpus with the current encoder
  (the item tower: + ID embedding, + bias column, + the CF factor and
  popularity columns) into a `RetrievalIndex(method="auto")` on the
  trainer's device (dense below 65,536 items, the packed scan kernels
  from there on) and scores per-user top-k retrieval with the user's
  train history excluded; the history tower's users gather their
  history embeddings from that f32 corpus matrix;
- `cf_rank > 0` factorizes the train co-occurrence at setup
  (`models/cf.py`, seeded) and appends each user's CF query columns;
- checkpoints are `torch.save` files holding the parameters, the
  optimizer state, the step, the best metric and the dropout
  generator's state, so a restored run resumes with the same masks;
- `save` writes the serving artifact: `processors.json` (same keys as
  the reference), `encoder.msgpack` (the whole parameter tree in flax's
  format), `index/`, `vocab.json` for the vocab tokenizer, `cf.npz` with
  the CF channel, the user store `users.npz` (in place of the
  reference's `users.parquet`; `serving/users.py`), and `encoder.npz` +
  `portable.json` with the text encoder alone.

Refused with an error (not ported yet, ROADMAP.md Queue 1): `remat`
(`training/module.py` `check_supported`), multi-device training
(`mesh=True`, `model_parallel > 1`, `shard_vocab`), and `profile_dir`.
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
from xfmr_rec_torch.models.cf import factorize_item_cf
from xfmr_rec_torch.models.convert import write_msgpack, write_portable
from xfmr_rec_torch.models.encoder import needs_two_tower, uses_item_ids
from xfmr_rec_torch.params import (
    CF_NPZ,
    INDEX_DIR,
    METRIC,
    PROCESSORS_JSON,
    USERS_NPZ,
    VOCAB_JSON,
)
from xfmr_rec_torch.serving.users import UserStore
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


def _refusals(tc: TrainerConfig) -> list[str]:
    refused = []
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
        refused = _refusals(self.trainer_config)
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
        # the factorized item-CF channel and each user's CF vector
        self.cf = None
        self._user_cf: np.ndarray | None = None
        # the history tower gathers from this (N, d) f32 corpus matrix
        self._corpus_f32: torch.Tensor | None = None

    @property
    def global_step(self) -> int:
        return 0 if self.state is None else self.state.step

    # ------------------------------------------------------------------
    def setup(self) -> None:
        if self.state is not None:
            return
        self._sync_data_fields()
        self.data.prepare_data()
        self.data.setup()
        if self.config.cf_rank > 0:
            # recomputed from the train interactions (seeded), so
            # checkpoints need not hold it
            self.cf = factorize_item_cf(
                self.data._train_items_by_user,
                self.data.num_items,
                rank=self.config.cf_rank,
                seed=self.trainer_config.seed,
            )
            self._user_cf = np.zeros(
                (self.data.num_users, self.cf.rank), np.float32
            )
            for upos, items in self.data._train_items_by_user.items():
                if items:
                    self._user_cf[upos] = self.cf.user_vectors(
                        np.asarray(items, dtype=np.int64)
                    )
        if self.config.item_id_embedding == "dense":
            max_rn = int(self.data.item_rns.max(initial=0))
            if max_rn >= self.config.item_id_buckets:
                msg = (
                    "dense item_id_embedding needs item_id_buckets > max "
                    f"movie_rn ({self.config.item_id_buckets} <= {max_rn}); "
                    "raise item_id_buckets or use bloom/hash"
                )
                raise ValueError(msg)
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

    def _sync_data_fields(self) -> None:
        """The data module must emit the history and bag fields at the
        model's widths: set them before its setup, or fail on a mismatch
        with one already set up."""
        sync = {}
        if self.config.user_tower == "history":
            sync["max_history"] = self.config.max_history
        if self.config.max_bag > 0:
            sync["max_bag"] = self.config.max_bag
        if not sync:
            return
        if self.data._ready:
            for field, value in sync.items():
                built = getattr(self.data.config, field)
                if built != value:
                    msg = (
                        f"model needs data.{field} == {value} (data module "
                        f"built with {built})"
                    )
                    raise ValueError(msg)
        else:
            self.data.config = dataclasses.replace(self.data.config, **sync)

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
    def _encode_rows(
        self, tokens: np.ndarray, rns: np.ndarray | None = None
    ) -> torch.Tensor:
        """Embeddings of a token matrix, `encode_batch_size` rows a pass,
        left on the device; with `rns`, through the item tower."""
        batch = self.trainer_config.encode_batch_size
        model = self.state.model
        outs = []
        for start in range(0, len(tokens), batch):
            chunk = torch.from_numpy(tokens[start : start + batch]).to(
                self.device
            )
            if rns is None:
                outs.append(train_mod.encode(model, chunk))
                continue
            with torch.no_grad():
                outs.append(model.encode_items(
                    chunk,
                    torch.from_numpy(rns[start : start + batch]).to(
                        self.device
                    ),
                ))
        if not outs:
            return torch.zeros(
                (0, self.config.hidden_size), device=self.device
            )
        return torch.cat(outs)

    def build_index(self) -> RetrievalIndex:
        """Embed the full item corpus -> exact MIPS index (eval barrier)."""
        corpus = self._encode_rows(
            self.data.item_tokens,
            rns=self.data.item_rns if uses_item_ids(self.config) else None,
        )
        if self.cf is not None:
            if self.config.index_dtype == "int8":
                logger.warning(
                    "cf_rank > 0 with an int8 index: the per-item scale "
                    "spans embeddings and CF factors of other magnitudes"
                )
            corpus = torch.cat([
                corpus,
                torch.from_numpy(self.cf.item_factors).to(self.device),
                torch.from_numpy(self.cf.pop_prior[:, None]).to(self.device),
            ], dim=1)
        if self.config.user_tower == "history":
            # the fusion reads the d-dim part only (no bias / CF columns)
            self._corpus_f32 = corpus[:, : self.config.hidden_size].float()
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
            users = self._eval_user_embeds(batch)
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

    def _eval_user_embeds(self, batch: dict[str, np.ndarray]) -> torch.Tensor:
        """User vectors of one eval batch, at index width: the text tower
        (+ the constant 1 paired with the bias column), or the history
        fusion over embeddings gathered from the corpus matrix; then the
        CF query columns."""
        if self.config.user_tower != "history":
            out = self._encode_rows(batch["user_tokens"])
            if self.config.item_bias:
                out = torch.cat([out, torch.ones_like(out[:, :1])], dim=1)
            return self._augment_query(out, batch.get("user_pos"))
        names = ["hist_positions", "hist_mask", "hist_ratings"]
        if self.config.max_bag > 0:
            names += ["bag_rns", "bag_ratings", "bag_mask"]
        extras = [
            torch.from_numpy(np.ascontiguousarray(batch[name])).to(self.device)
            for name in names
        ]
        out = self.state.model.encode_users_from_corpus(
            torch.from_numpy(batch["user_tokens"]).to(self.device),
            self._corpus_f32,
            *extras,
        )
        return self._augment_query(out, batch.get("user_pos"))

    def _augment_query(
        self, out: torch.Tensor, user_pos: np.ndarray | None
    ) -> torch.Tensor:
        """Append the CF query columns: cf_weight * the user's unit CF
        vector, then the constant cf_pop_weight paired with the
        popularity column. Queries with no dataset user get zero CF."""
        if self.cf is None:
            return out
        if user_pos is None:
            cf_vecs = np.zeros((len(out), self.cf.rank), np.float32)
        else:
            cf_vecs = self._user_cf[np.asarray(user_pos, dtype=np.int64)]
        cf = torch.from_numpy(cf_vecs).to(out.device, out.dtype)
        pop = torch.full_like(out[:, :1], self.config.cf_pop_weight)
        return torch.cat([out, self.config.cf_weight * cf, pop], dim=1)

    def eval_user_embeddings(self, user_pos: np.ndarray) -> torch.Tensor:
        """Query vectors of dataset users by position, on the eval path
        (text tower, or the history fusion over the corpus)."""
        self.setup()
        if self.index is None:
            self.build_index()
        user_pos = np.asarray(user_pos)
        batch = {
            "user_tokens": self.data.user_tokens[user_pos],
            "user_pos": user_pos,
            **self.data.user_history_fields(user_pos),
        }
        return self._eval_user_embeds(batch)

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
        if self.cf is not None:
            self.cf.save(path / CF_NPZ)
        UserStore.from_prepared(self.data.config.data_dir).save(
            path / USERS_NPZ
        )
        state = self.state.model.state_dict()
        write_msgpack(state, path)
        if needs_two_tower(self.config):
            state = {
                name.removeprefix("text."): value
                for name, value in state.items()
                if name.startswith("text.")
            }
        write_portable(state, model_dump, data_dump, path)
