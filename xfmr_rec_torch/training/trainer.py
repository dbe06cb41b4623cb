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
  `portable.json` with the text encoder alone;
- on one card (`graphs_engage`: off the mesh, remat off, the text
  tower) a train step replays from CUDA graphs captured for its batch
  shape (`training/graphs.py`); elsewhere it runs eagerly;
- `profile_dir` traces train steps 10-20 with `torch.profiler`
  (`utils/profiling.py` `device_trace`), as the reference traces them
  with `jax.profiler`;
- `predict` runs every predict user through the eval search with the
  user's train history excluded and writes `predictions.npz` (in place of
  the reference's `predictions.parquet`: the card's machine has neither
  pandas nor pyarrow).
- `recommend` (raw texts) and `recommend_users` (dataset users by
  position) return each query's top-k as `{"movie_id", "score",
  **metadata}` through the eval index, as the reference does even when
  the eval corpus is split over the model axis.

Multi-device (`parallel/`): with `mesh=True`, or by default when more
than one device is given (`devices=`, else the visible cards), the
trainer builds a (data, model) mesh with `model_parallel` on the model
axis. A step is the single-device step over the global batch
(`parallel/train.py`; the batch size must divide by the mesh size), and
`shard_vocab` splits the token table over the model axis, also where a
model row crosses processes (each process then holds its columns'
pieces); checkpoints and the artifact hold the whole table. Eval encodes
in chunks padded to the mesh size; with `model_parallel > 1` the eval
corpus is split over the model axis and searched by `sharded_topk`, its
shard-balancing rows excluded.

Many processes: after `parallel.initialize_distributed` the mesh spans
every process (by default on, each process giving its pinned device or
`devices=`), and `batch_size` must divide by the global mesh size. Every
process runs the same program on the same data: its own slots' rows, the
same summed gradients and parameters. Only the first process writes
checkpoints, the artifact, predictions and the metrics log, the others
waiting at a barrier; `restore_checkpoint` runs in every process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import pathlib
import time
from typing import Any

import numpy as np
import torch

from xfmr_rec_torch.data.module import DataConfig, RecDataModule
from xfmr_rec_torch.device import resolve_device
from xfmr_rec_torch.index.mips import RetrievalIndex
from xfmr_rec_torch.models.cf import factorize_item_cf
from xfmr_rec_torch.models.convert import write_msgpack, write_portable
from xfmr_rec_torch.models.encoder import needs_two_tower, uses_item_ids
from xfmr_rec_torch.parallel.mesh import (
    Mesh,
    any_process,
    barrier,
    create_mesh,
    is_distributed,
    process_index,
    shard_batch,
)
from xfmr_rec_torch.parallel.retrieval import place_rows, sharded_topk
from xfmr_rec_torch.parallel.train import (
    gathered_state_dict,
    make_sharded_train_step,
    place_state,
    unsharded_state,
)
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
from xfmr_rec_torch.training.graphs import StepGraphs, graphs_engage
from xfmr_rec_torch.training.metrics import retrieval_metrics
from xfmr_rec_torch.training.module import TrainConfig, TrainState
from xfmr_rec_torch.utils.logging import MetricsLogger
from xfmr_rec_torch.utils.profiling import device_trace, span

logger = logging.getLogger(__name__)

# train steps traced under `profile_dir`: [PROFILE_STEPS[0], [1])
PROFILE_STEPS = (10, 20)


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


class Trainer:
    def __init__(
        self,
        config: TrainConfig | None = None,
        data: RecDataModule | DataConfig | None = None,
        trainer_config: TrainerConfig | None = None,
        *,
        device: str | torch.device = "cuda",
        devices: list[str | torch.device] | None = None,
    ) -> None:
        self.config = config or TrainConfig()
        self.trainer_config = trainer_config or TrainerConfig()
        tc = self.trainer_config
        self.device = resolve_device(device)
        if devices is not None:
            visible = [resolve_device(d) for d in devices]
        elif is_distributed():
            # this process's own slot: its pinned card, or the device given
            visible = [self.device]
            if self.device.type == "cuda" and self.device.index is None:
                visible = [torch.device("cuda", torch.cuda.current_device())]
        elif self.device.type == "cuda" and self.device.index is None:
            visible = [
                torch.device("cuda", i) for i in range(torch.cuda.device_count())
            ]
        else:
            visible = [self.device]
        use_mesh = (
            tc.mesh if tc.mesh is not None
            else len(visible) > 1 or is_distributed()
        )
        self.mesh: Mesh | None = None
        if use_mesh:
            self.mesh = create_mesh(
                model_parallel=tc.model_parallel, devices=visible
            )
            self.device = self.mesh.lead
        self._mesh_step = None
        # train steps replayed from a graph set captured for them
        # ("captured"), from one captured before ("replayed"), or run
        # eagerly ("eager")
        self.step_counts = {"captured": 0, "replayed": 0, "eager": 0}
        # the eval corpus split over the model axis (model_parallel > 1)
        self._sharded_corpus = None
        self._sharded_corpus_pad = 0
        if isinstance(data, RecDataModule):
            self.data = data
        else:
            self.data = RecDataModule(data or DataConfig())
        if self.mesh is not None and self.data.config.batch_size % self.mesh.size:
            msg = (
                f"batch_size {self.data.config.batch_size} must be "
                f"divisible by the mesh size {self.mesh.size} "
                f"(shape {dict(self.mesh.shape)})"
            )
            raise ValueError(msg)
        run_name = self.trainer_config.run_name or time.strftime(
            "%Y%m%d-%H%M%S"
        )
        # the first process writes (all compute the same metrics)
        self._writer = process_index() == 0
        self.logger = MetricsLogger(
            self.trainer_config.log_dir, run_name, write=self._writer
        )
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
        graphed = graphs_engage(
            self.config, self.device, mesh=self.mesh is not None
        )
        self.state = TrainState(
            self.config, seed=self.trainer_config.seed, device=self.device,
            capturable=graphed,
        )
        if graphed:
            self.state.graphs = StepGraphs(self.device)
        if self.mesh is not None:
            tc = self.trainer_config
            place_state(
                self.state, self.mesh, self.config, shard_vocab=tc.shard_vocab
            )
            self._mesh_step = make_sharded_train_step(
                self.config,
                self.mesh,
                shard_vocab=tc.shard_vocab,
                state=self.state,
                log_all_losses=tc.log_all_losses,
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
        """One update on a host batch; returns device metric tensors.
        Spans: `train.step` holds `train.to_device`, then
        `train.graphed` where the state's graphs replay the step (after
        `train.capture` on a new batch shape), else `train.eager`; those
        hold `train.forward`, `train.backward` and `train.optimizer`.
        `step_counts` counts the steps of each kind."""
        log_all = self.trainer_config.log_all_losses
        with span("train.step"):
            if self.state.graphs is not None:
                metrics, captured = self.state.graphs.step(
                    self.state, batch, log_all_losses=log_all
                )
                self.step_counts["captured" if captured else "replayed"] += 1
                return metrics
            self.step_counts["eager"] += 1
            if self._mesh_step is not None:
                with span("train.eager"):
                    return self._mesh_step(
                        self.state, shard_batch(batch, self.mesh)
                    )
            with span("train.to_device"):
                device_batch = train_mod.batch_to_device(
                    batch, self.device, self.config.pooling_mode
                )
            with span("train.eager"):
                return train_mod.train_step(
                    self.state, device_batch, log_all_losses=log_all
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
        # holds the profiler while steps PROFILE_STEPS are traced
        trace = contextlib.ExitStack()
        with trace:
            for epoch in range(tc.max_epochs):
                if stop:
                    break
                for batch_idx, batch in enumerate(
                    self.data.train_batches(epoch)
                ):
                    if batch_idx >= num_batches:
                        break
                    if (
                        tc.profile_dir
                        and self.global_step == PROFILE_STEPS[0]
                    ):
                        trace.enter_context(device_trace(tc.profile_dir))
                    metrics = self.train_step(batch)
                    if self.global_step == PROFILE_STEPS[1]:
                        trace.close()
                    if self.global_step % tc.log_every_steps == 0:
                        self.logger.log_metrics(metrics, self.global_step)
                    if tc.max_steps and self.global_step >= tc.max_steps:
                        stop = True
                        break
                    if tc.max_time_s and self._agree(
                        time.time() - fit_start > tc.max_time_s
                    ):
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

    def _agree(self, flag: bool) -> bool:
        """A host-side decision every process of the mesh takes alike
        (any process's True)."""
        return any_process(flag, self.mesh) if self.mesh is not None else flag

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
        left on the device; with `rns`, through the item tower. On a mesh
        each pass splits over the devices (padded to the mesh size)."""
        batch = self.trainer_config.encode_batch_size
        model = self.state.model
        outs = []
        if self.mesh is not None:  # keep chunk shapes mesh-divisible
            batch += -batch % self.mesh.size
        for start in range(0, len(tokens), batch):
            chunk = torch.from_numpy(tokens[start : start + batch]).to(
                self.device
            )
            if self._mesh_step is not None:
                if rns is None:
                    outs.append(self._mesh_step.encode(
                        self.state, lambda m, t: m(t), chunk
                    ))
                else:
                    outs.append(self._mesh_step.encode(
                        self.state,
                        lambda m, t, r: m.encode_items(t, r),
                        chunk,
                        torch.from_numpy(rns[start : start + batch]),
                    ))
                continue
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
        if self.mesh is not None and self.mesh.shape["model"] > 1:
            # corpus parallelism: the f32 item matrix split over the
            # model axis, its shard-balancing rows excluded in the search
            pad = -len(corpus) % self.mesh.shape["model"]
            self._sharded_corpus = place_rows(
                torch.nn.functional.pad(corpus.float(), (0, 0, 0, pad)),
                self.mesh,
            )
            self._sharded_corpus_pad = pad
        return self.index

    def _search(
        self, users: torch.Tensor, batch: dict[str, np.ndarray], top_k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """(scores, item ids) of one eval batch, its train history
        excluded: the eval index, or `sharded_topk` over the split
        corpus."""
        if self._sharded_corpus is None:
            return self.index.search(
                users, top_k=top_k, exclude_positions=batch["exclude_positions"]
            )
        excl = np.asarray(batch["exclude_positions"], dtype=np.int32)
        if self._sharded_corpus_pad:
            n = self.data.num_items
            pad_cols = np.broadcast_to(
                np.arange(n, n + self._sharded_corpus_pad, dtype=np.int32),
                (len(excl), self._sharded_corpus_pad),
            )
            excl = np.concatenate([excl, pad_cols], axis=1)
        values, positions = sharded_topk(
            users.float(),
            self._sharded_corpus,
            top_k,
            self.mesh,
            exclude_positions=torch.from_numpy(excl).to(self.device),
        )
        # clipped as the reference clips them: pad rows sit last and tie
        # at -inf, so one comes back only when top_k exceeds the catalogue
        positions = np.minimum(positions.cpu().numpy(), self.data.num_items - 1)
        return values.cpu().numpy(), self.data.item_ids[positions]

    def _eval_retrieval(self, subset: str) -> dict[str, float]:
        self.build_index()
        top_k = self.config.top_k
        totals: dict[str, float] = {}
        count = 0
        limit = self.trainer_config.limit_val_batches
        for batch_idx, batch in enumerate(self.data.eval_batches(subset)):
            if limit is not None and batch_idx >= limit:
                break
            users = self._eval_user_embeds(batch)
            _, pred_ids = self._search(users, batch, top_k)
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
        tokens = torch.from_numpy(batch["user_tokens"]).to(self.device)
        if self._mesh_step is not None:
            corpus = self._corpus_f32
            out = self._mesh_step.encode(
                self.state,
                lambda m, t, *rest: m.encode_users_from_corpus(
                    t, corpus.to(t.device), *rest
                ),
                tokens,
                *extras,
            )
        else:
            out = self.state.model.encode_users_from_corpus(
                tokens, self._corpus_f32, *extras
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
                self.state,
                train_mod.batch_to_device(
                    batch, self.device, self.config.pooling_mode
                ),
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

    def predict(
        self,
        output_path: str | pathlib.Path | None = None,
        *,
        top_k: int | None = None,
    ) -> dict[str, np.ndarray]:
        """Top-k recommendations for every predict user (the full
        `is_predict` cohort), each user's train history excluded, through
        the eval index's search (kernel 1 from 65,536 items).

        Returns and, given a path, writes (`np.savez`) `user_id (U,)
        int64`, `rec_item_ids (U, k)` and `rec_scores (U, k) float32`.
        The reference writes the same three columns as
        `predictions.parquet`; the card's machine has neither pandas nor
        pyarrow, so the port writes `predictions.npz`.
        """
        self.setup()
        self.build_index()
        top_k = top_k or self.config.top_k
        user_ids, rec_ids, rec_scores = [], [], []
        for batch in self.data.eval_batches("predict"):
            users = self._eval_user_embeds(batch)
            scores, pred_ids = self._search(users, batch, top_k)
            valid = np.asarray(batch["valid"], bool)
            upos = np.asarray(batch["user_pos"])[valid]
            user_ids.append(self.data.user_ids[upos].astype(np.int64))
            rec_ids.append(pred_ids[valid])
            rec_scores.append(scores[valid].astype(np.float32))
        out = {
            "user_id": np.concatenate(user_ids) if user_ids
            else np.zeros(0, np.int64),
            "rec_item_ids": np.concatenate(rec_ids) if rec_ids
            else np.zeros((0, top_k), self.index.ids.dtype),
            "rec_scores": np.concatenate(rec_scores) if rec_scores
            else np.zeros((0, top_k), np.float32),
        }
        if output_path is not None and self._writer:
            output_path = pathlib.Path(output_path)
            output_path.parent.mkdir(parents=True, exist_ok=True)
            with output_path.open("wb") as f:
                np.savez(f, **out)
            logger.info(
                "predictions for %d users written to %s",
                len(out["user_id"]),
                output_path,
            )
        if output_path is not None:
            barrier()
        return out

    def embed_texts(self, texts: list[str]) -> torch.Tensor:
        """Unit-norm embeddings of raw texts (the serving tokenizer)."""
        self.setup()
        tokens = self.data.tokenizer.encode_batch(
            texts, self.config.max_length
        )
        return self._encode_rows(tokens)

    def recommend(
        self,
        texts: list[str],
        *,
        top_k: int | None = None,
        exclude_ids: list[list[int]] | None = None,
    ) -> list[list[dict[str, Any]]]:
        """Top-k items for raw texts through the eval index's search
        (kernel 1 from 65,536 items), `exclude_ids` a list of item ids a
        text. A raw text query carries the constant 1 paired with the
        bias column (`item_bias`) and zero CF columns (no dataset user)."""
        self.setup()
        if self.index is None:
            self.build_index()
        embeds = self.embed_texts(texts)
        if self.config.item_bias:
            embeds = torch.cat([embeds, torch.ones_like(embeds[:, :1])], dim=1)
        embeds = self._augment_query(embeds, None)
        scores, item_ids = self.index.search(
            embeds, top_k=top_k or self.config.top_k, exclude_ids=exclude_ids
        )
        return self._format_candidates(scores, item_ids)

    def recommend_users(
        self,
        user_pos: np.ndarray | list[int],
        *,
        top_k: int | None = None,
        exclude_ids: list[list[int]] | None = None,
    ) -> list[list[dict[str, Any]]]:
        """Top-k items for dataset users by position, on the eval path's
        user vectors (`eval_user_embeddings`) and the eval index."""
        embeds = self.eval_user_embeddings(np.asarray(user_pos))
        scores, item_ids = self.index.search(
            embeds, top_k=top_k or self.config.top_k, exclude_ids=exclude_ids
        )
        return self._format_candidates(scores, item_ids)

    def _format_candidates(
        self, scores: np.ndarray, item_ids: np.ndarray
    ) -> list[list[dict[str, Any]]]:
        """One list a query of {"movie_id", "score", **metadata}."""
        return [
            [
                {
                    "movie_id": int(i),
                    "score": float(s),
                    **self.index.get_id(int(i)),
                }
                for s, i in zip(row_scores, row_ids, strict=True)
            ]
            for row_scores, row_ids in zip(scores, item_ids, strict=True)
        ]

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
        """Write the training state in the layout of an unsharded run
        (`shard_vocab` tables and their moments whole, gathered from every
        process: all call it; the first writes, the others wait)."""
        params, opt_state = unsharded_state(self.state)
        if self._writer:
            path = self._ckpt_path(name)
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(path.name + ".tmp")
            torch.save(
                {
                    "params": params,
                    "opt_state": opt_state,
                    "step": self.state.step,
                    "best_metric": float(self.best_metric),
                    "dropout_generator": self.state.generator.get_state(),
                },
                tmp,
            )
            os.replace(tmp, path)
        barrier()

    def restore_checkpoint(self, name: str = "last") -> None:
        self.setup()
        saved = torch.load(
            self._ckpt_path(name), map_location=self.device, weights_only=True
        )
        if saved["params"].keys() == self.state.model.state_dict().keys():
            self.state.model.load_state_dict(saved["params"])
            self.state.load_optimizer_state(saved["opt_state"])
            if self.state.graphs is not None:
                # the graphs read the optimizer state the load replaced
                self.state.graphs.clear()
        else:
            # whole tables for a sharded model: load them into a fresh
            # state and split them again
            state = TrainState(
                self.config, seed=self.trainer_config.seed, device=self.device
            )
            state.model.load_state_dict(saved["params"])
            state.load_optimizer_state(saved["opt_state"])
            place_state(state, self.mesh, self.config, shard_vocab=True)
            self.state = state
        self.state.step = int(saved["step"])
        self.best_metric = float(saved["best_metric"])
        self.state.generator.set_state(saved["dropout_generator"].cpu())

    def save(self, path: str | pathlib.Path) -> None:
        """Write the deployable serving artifact (encoder + index +
        config); see the module docstring for the files. In a process
        group every process calls it, the first writes."""
        self.setup()
        if self.index is None:
            self.build_index()
        state = gathered_state_dict(self.state.model)
        if self._writer:
            self._write_artifact(pathlib.Path(path), state)
        barrier()

    def _write_artifact(
        self, path: pathlib.Path, state: dict[str, torch.Tensor]
    ) -> None:
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
        self.index.save(path / INDEX_DIR)
        if hasattr(self.data.tokenizer, "vocab"):
            self.data.tokenizer.save(path / VOCAB_JSON)
        if self.cf is not None:
            self.cf.save(path / CF_NPZ)
        UserStore.from_prepared(self.data.config.data_dir).save(
            path / USERS_NPZ
        )
        write_msgpack(state, path)
        if needs_two_tower(self.config):
            state = {
                name.removeprefix("text."): value
                for name, value in state.items()
                if name.startswith("text.")
            }
        write_portable(state, model_dump, data_dump, path)
