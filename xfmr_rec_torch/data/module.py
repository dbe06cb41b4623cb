"""Fixed-shape batch pipeline + data module facade.

Port of `xfmr_rec_tpu/data/module.py`, on numpy only:
every unique text is tokenized once at setup, token matrices stay host
numpy arrays, and batches are fixed-shape integer arrays gathered by
index. For the same data and seed the batches are the reference's, field
by field and bit for bit.

- Training stream: the train interactions reshuffled each epoch
  (`default_rng((seed, epoch))`), each row paired with one uniform corpus
  negative from an endless reshuffled item cycle (mixed negative
  sampling).
- `pos_idx`: the user's train positives as `movie_rn`, 0-padded, so the
  accidental-hit mask covers all of them.
- Eval batches are per user: exclusions = the user's train history
  (padded with `num_items`, which every search drops), targets = the
  holdout with graded ratings.
- LogQ: per-candidate sampling log-probabilities (frequency-based for
  in-batch positives, uniform for sampled negatives).
- History (`max_history > 0`): train rows carry the user's most recent
  `max_history` train interactions strictly before the row (tokens,
  mask, ratings, movie_rns), most-recent-first; eval rows carry the
  user's full train history as corpus positions (padded slots clipped
  to 0) for the gather from the corpus matrix.
- CF bag (`max_bag > 0`): the user's most recent `max_bag` train items
  (movie_rn, rating, mask); train rows mask their own positive out.
"""

from __future__ import annotations

import dataclasses
import fcntl
import logging
import pathlib
from collections.abc import Iterator

import numpy as np

from xfmr_rec_torch.data import prepare as prepare_mod
from xfmr_rec_torch.models.tokenizer import (
    HashingTokenizer,
    TokenizerConfig,
    VocabTokenizer,
    build_vocab,
)
from xfmr_rec_torch.params import BATCH_SIZE, DATA_DIR
from xfmr_rec_torch.utils.profiling import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DataConfig:
    """The reference's `DataConfig` fields and defaults."""

    data_dir: str = DATA_DIR
    batch_size: int = BATCH_SIZE
    eval_batch_size: int = 256
    max_length: int = 64
    vocab_size: int = 30522
    # "hashing" = stateless feature hashing; "vocab" = corpus-frequency
    # vocab built at setup, with FNV-hashed OOV buckets
    tokenizer: str = "hashing"
    oov_buckets: int = 2048
    # pos_idx / target widths; None = the corpus maximum (no truncation)
    max_positives: int | None = None
    max_targets: int | None = None
    max_history: int = 0
    max_bag: int = 0
    seed: int = 0
    # with no raw files: generate a synthetic corpus of this size
    synthetic_if_missing: bool = True
    synthetic_users: int = 120
    synthetic_movies: int = 200
    synthetic_ratings: int = 4000


class NegativeItemSampler:
    """Endless shuffled cycle over item positions: each pass visits every
    item once in a fresh random order."""

    def __init__(self, num_items: int, seed: int = 0) -> None:
        self.num_items = num_items
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(num_items)
        self._cursor = 0

    def draw(self, count: int) -> np.ndarray:
        out = np.empty(count, dtype=np.int64)
        filled = 0
        while filled < count:
            take = min(count - filled, self.num_items - self._cursor)
            out[filled : filled + take] = self._order[
                self._cursor : self._cursor + take
            ]
            filled += take
            self._cursor += take
            if self._cursor >= self.num_items:
                self._order = self.rng.permutation(self.num_items)
                self._cursor = 0
        return out


def _pad_rows(rows: list[np.ndarray], width: int, fill: int) -> np.ndarray:
    out = np.full((len(rows), width), fill, dtype=np.int64)
    for i, row in enumerate(rows):
        n = min(len(row), width)
        out[i, :n] = row[:n]
    return out


def _split_by_user(user_pos: np.ndarray, *columns: np.ndarray):
    """Contiguous runs of equal `user_pos` -> (user, column slices...)."""
    bounds = np.flatnonzero(np.diff(user_pos) != 0) + 1
    starts = np.r_[0, bounds]
    stops = np.r_[bounds, len(user_pos)]
    for lo, hi in zip(starts, stops, strict=True):
        if hi > lo:
            yield (int(user_pos[lo]), *(c[lo:hi] for c in columns))


class RecDataModule:
    """Owns ETL, tokenization, and batch iterators for train/val/test."""

    def __init__(self, config: DataConfig | None = None, **kwargs) -> None:
        self.config = config if config is not None else DataConfig(**kwargs)
        cfg = self.config
        if cfg.tokenizer not in ("hashing", "vocab"):
            msg = f"unknown tokenizer {cfg.tokenizer!r}"
            raise ValueError(msg)
        self.tokenizer = (
            HashingTokenizer(
                TokenizerConfig(
                    vocab_size=cfg.vocab_size, max_length=cfg.max_length
                )
            )
            if cfg.tokenizer == "hashing"
            else None
        )
        self._ready = False
        self.provenance: dict | None = None

    # ------------------------------------------------------------------
    def prepare_data(self, *, overwrite: bool = False) -> None:
        """Raw files (or a synthetic corpus) -> the prepared tables, under
        an exclusive lock on `<data_dir>.lock` so concurrent trainers do
        not race on the directory."""
        cfg = self.config
        pathlib.Path(cfg.data_dir).parent.mkdir(parents=True, exist_ok=True)
        with open(f"{cfg.data_dir}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            self._prepare_data_locked(overwrite=overwrite)

    def _prepare_data_locked(self, *, overwrite: bool) -> None:
        cfg = self.config
        source = "preexisting"
        raw = prepare_mod.raw_dir(cfg.data_dir) / "ratings.dat"
        if not raw.exists() and not prepare_mod.prepared(cfg.data_dir):
            if not cfg.synthetic_if_missing:
                msg = (
                    f"no MovieLens files under {cfg.data_dir}/ml-1m and "
                    "synthetic_if_missing is off; nothing is downloaded"
                )
                raise FileNotFoundError(msg)
            from xfmr_rec_torch.data.synthetic import generate_movielens

            logger.warning("raw data absent; generating a synthetic corpus")
            generate_movielens(
                cfg.data_dir,
                num_users=cfg.synthetic_users,
                num_movies=cfg.synthetic_movies,
                num_ratings=cfg.synthetic_ratings,
                seed=cfg.seed,
            )
            source = "synthetic"
        self.provenance = prepare_mod.record_provenance(
            cfg.data_dir, source=source
        )
        prepare_mod.prepare_movielens(cfg.data_dir, overwrite=overwrite)

    # ------------------------------------------------------------------
    def setup(self) -> None:
        """Load the prepared tables, tokenize all texts once, build the
        index arrays."""
        if self._ready:
            return
        cfg = self.config
        if self.provenance is None:
            self.provenance = prepare_mod.load_provenance(cfg.data_dir)
        movies = prepare_mod.load_table(cfg.data_dir, "movies")
        users = prepare_mod.load_table(cfg.data_dir, "users")
        ratings = prepare_mod.load_table(cfg.data_dir, "ratings")

        if self.tokenizer is None:
            self.tokenizer = self._build_vocab_tokenizer(
                prepare_mod.raw_dir(cfg.data_dir),
                movies["movie_text"].tolist() + users["user_text"].tolist(),
            )

        # items: position p is movie_rn p + 1
        order = np.argsort(movies["movie_rn"], kind="stable")
        self.item_ids = movies["movie_id"][order]
        self.item_rns = movies["movie_rn"][order]
        if not np.array_equal(self.item_rns, np.arange(1, len(order) + 1)):
            msg = (
                "movie_rn must be the contiguous 1-based row number; re-run "
                "data preparation"
            )
            raise ValueError(msg)
        self.item_texts = movies["movie_text"][order].tolist()
        self.item_tokens = self.tokenizer.encode_batch(self.item_texts)
        self.num_items = len(order)

        order = np.argsort(users["user_rn"], kind="stable")
        self.user_ids = users["user_id"][order]
        self.user_rns = users["user_rn"][order]
        self.user_texts = users["user_text"][order].tolist()
        self.user_tokens = self.tokenizer.encode_batch(self.user_texts)
        self.num_users = len(order)
        self.user_subsets = {
            name: users[name][order] for name in prepare_mod.FLAGS
        }

        user_pos = prepare_mod.lookup_positions(
            ratings["user_id"], self.user_ids, "user"
        )
        item_pos = prepare_mod.lookup_positions(
            ratings["movie_id"], self.item_ids, "movie"
        )
        is_train = ratings["is_train"]
        self.train_user_pos = user_pos[is_train]
        self.train_item_pos = item_pos[is_train]
        self.train_rating = ratings["rating"][is_train].astype(np.float32)

        # held-out interactions per subset, for val/test loss logging
        self._holdout_interactions = {}
        for subset in ("val", "test"):
            mask = ratings[f"is_{subset}"] & ~is_train
            self._holdout_interactions[subset] = (
                user_pos[mask],
                item_pos[mask],
                ratings["rating"][mask].astype(np.float32),
            )

        # per-user train item positions, in train order (the ratings are
        # sorted by user, so each user's rows are contiguous)
        self._train_items_by_user = {
            upos: items.tolist()
            for upos, items in _split_by_user(
                self.train_user_pos, self.train_item_pos
            )
        }
        if cfg.max_history > 0:
            self._build_history_arrays()
        if cfg.max_bag > 0:
            self._build_bag_arrays()

        pos_rows = [
            np.asarray(self._train_items_by_user.get(u, []), dtype=np.int64)
            + 1
            for u in range(self.num_users)
        ]
        corpus_max_pos = max((len(r) for r in pos_rows), default=1) or 1
        self.max_positives = (
            corpus_max_pos if cfg.max_positives is None else cfg.max_positives
        )
        if self.max_positives < corpus_max_pos:
            logger.warning(
                "max_positives=%d truncates the accidental-hit mask (corpus "
                "max %d)", self.max_positives, corpus_max_pos,
            )
        self.user_pos_idx = _pad_rows(pos_rows, self.max_positives, 0)

        # holdout targets per user, sorted by rating descending (stable)
        holdout = ~is_train
        target_ids = [np.zeros(0, np.int64) for _ in range(self.num_users)]
        target_ratings = [
            np.zeros(0, np.float64) for _ in range(self.num_users)
        ]
        holdout_pos_rows = [
            np.zeros(0, np.int64) for _ in range(self.num_users)
        ]
        for upos, movie_ids, rates, ipos in _split_by_user(
            user_pos[holdout],
            ratings["movie_id"][holdout],
            ratings["rating"][holdout],
            item_pos[holdout],
        ):
            by_rating = np.argsort(-rates, kind="stable")
            target_ids[upos] = movie_ids[by_rating]
            target_ratings[upos] = rates[by_rating]
            holdout_pos_rows[upos] = ipos + 1
        holdout_width = max((len(r) for r in holdout_pos_rows), default=1) or 1
        self.user_holdout_pos_idx = _pad_rows(
            holdout_pos_rows, holdout_width, 0
        )
        self._target_ids = target_ids
        self._target_ratings = target_ratings
        self.target_counts = np.array(
            [len(t) for t in target_ids], dtype=np.int64
        )
        corpus_max_targets = max(int(self.target_counts.max()), 1)
        self.max_targets = (
            corpus_max_targets if cfg.max_targets is None else cfg.max_targets
        )
        if self.max_targets < corpus_max_targets:
            logger.warning(
                "max_targets=%d truncates holdout targets (corpus max %d)",
                self.max_targets, corpus_max_targets,
            )

        # item sampling log-probabilities for the LogQ correction
        counts = np.bincount(self.train_item_pos, minlength=self.num_items)
        freq = (counts + 1.0) / (counts.sum() + self.num_items)
        self.item_log_q_inbatch = np.log(freq).astype(np.float32)
        self.item_log_q_uniform = np.full(
            self.num_items, -np.log(self.num_items), dtype=np.float32
        )

        self._neg_sampler = NegativeItemSampler(self.num_items, cfg.seed)
        self._ready = True
        logger.info(
            "data ready: %d users, %d items, %d train interactions",
            self.num_users, self.num_items, len(self.train_user_pos),
        )

    def _train_blocks(self) -> list[np.ndarray]:
        """Train-row indices split into each user's contiguous,
        time-ascending block."""
        num_rows = len(self.train_user_pos)
        if num_rows == 0:
            return []
        boundaries = np.flatnonzero(np.diff(self.train_user_pos) != 0) + 1
        return np.split(np.arange(num_rows), boundaries)

    def _build_history_arrays(self) -> None:
        """Causal history tables: `train_hist_pos[t, j]` = the item position
        of the (j+1)-th most recent train interaction of row t's user
        strictly before row t (-1: none), with its rating; `user_hist_pos`
        = each user's most recent `max_history` train items, the
        serving-time input."""
        hist_len = self.config.max_history
        num_rows = len(self.train_user_pos)
        self.train_hist_pos = np.full((num_rows, hist_len), -1, np.int64)
        self.train_hist_rating = np.zeros((num_rows, hist_len), np.int32)
        self.user_hist_pos = np.full((self.num_users, hist_len), -1, np.int64)
        self.user_hist_rating = np.zeros((self.num_users, hist_len), np.int32)
        for block in self._train_blocks():
            items = self.train_item_pos[block]
            ratings = self.train_rating[block].astype(np.int32)
            rows = len(block)
            for back in range(min(hist_len, rows)):
                src = np.arange(rows) - (back + 1)
                valid = src >= 0
                self.train_hist_pos[block[valid], back] = items[src[valid]]
                self.train_hist_rating[block[valid], back] = ratings[
                    src[valid]
                ]
            upos = int(self.train_user_pos[block[0]])
            take = min(hist_len, rows)
            self.user_hist_pos[upos, :take] = items[::-1][:take]
            self.user_hist_rating[upos, :take] = ratings[::-1][:take]

    def _build_bag_arrays(self) -> None:
        """Per-user CF-bag tables: the most recent `max_bag` train items
        and ratings, most-recent-first, -1 / 0 padded."""
        width = self.config.max_bag
        self.user_bag_pos = np.full((self.num_users, width), -1, np.int64)
        self.user_bag_rating = np.zeros((self.num_users, width), np.int32)
        for block in self._train_blocks():
            upos = int(self.train_user_pos[block[0]])
            items = self.train_item_pos[block][::-1][:width]
            ratings = self.train_rating[block].astype(np.int32)[::-1][:width]
            self.user_bag_pos[upos, : len(items)] = items
            self.user_bag_rating[upos, : len(ratings)] = ratings

    def train_history_item_ids(self, user_pos: int) -> list[int]:
        """Item ids of one user's train interactions (the recommend-time
        exclusion set)."""
        return [
            int(self.item_ids[p])
            for p in self._train_items_by_user.get(int(user_pos), [])
        ]

    def user_history_fields(
        self, user_pos: np.ndarray
    ) -> dict[str, np.ndarray]:
        """The eval-side history and bag fields of users by position:
        corpus positions (padded slots clipped to 0), mask and ratings,
        and the bag's movie_rns (0 = pad), ratings and mask."""
        out = {}
        if self.config.max_history > 0:
            hist_pos = self.user_hist_pos[user_pos]
            out["hist_positions"] = np.maximum(hist_pos, 0)
            out["hist_mask"] = hist_pos >= 0
            out["hist_ratings"] = self.user_hist_rating[user_pos]
        if self.config.max_bag > 0:
            bag_pos = self.user_bag_pos[user_pos]
            bag_mask = bag_pos >= 0
            out["bag_rns"] = ((bag_pos + 1) * bag_mask).astype(np.int32)
            out["bag_ratings"] = self.user_bag_rating[user_pos]
            out["bag_mask"] = bag_mask
        return out

    def _build_vocab_tokenizer(
        self, base: pathlib.Path, texts: list[str]
    ) -> VocabTokenizer:
        """Build (or reload) the corpus-frequency vocab tokenizer, cached
        beside the raw files under the reference's cache key (one file
        serves both packages)."""
        cfg = self.config
        cache = base / (
            f"vocab-{cfg.vocab_size}-{cfg.oov_buckets}-{cfg.max_length}.json"
        )
        if cache.exists():
            return VocabTokenizer.load(cache)
        vocab = build_vocab(
            texts, vocab_size=cfg.vocab_size, oov_buckets=cfg.oov_buckets
        )
        tokenizer = VocabTokenizer(
            vocab,
            TokenizerConfig(
                vocab_size=cfg.vocab_size, max_length=cfg.max_length
            ),
        )
        tokenizer.save(cache)
        return tokenizer

    # ------------------------------------------------------------------
    @property
    def steps_per_epoch(self) -> int:
        return len(self.train_user_pos) // self.config.batch_size

    def _assemble_loss_batch(
        self,
        upos: np.ndarray,
        ipos: np.ndarray,
        target: np.ndarray,
        pos_table: np.ndarray,
        sampler: NegativeItemSampler,
        hist: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> dict[str, np.ndarray]:
        """One loss-step batch (train and eval share this schema)."""
        neg_pos = sampler.draw(len(upos))
        item_idx = np.concatenate([ipos, neg_pos]) + 1  # movie_rn
        log_q = np.concatenate(
            [self.item_log_q_inbatch[ipos], self.item_log_q_uniform[neg_pos]]
        )
        batch = {
            "user_tokens": self.user_tokens[upos],
            "item_tokens": self.item_tokens[ipos],
            "neg_item_tokens": self.item_tokens[neg_pos],
            "target": target,
            "item_idx": item_idx.astype(np.int64),
            "pos_idx": pos_table[upos],
            "log_q": log_q,
        }
        if hist is not None:
            hist_pos, hist_rating = hist
            mask = hist_pos >= 0
            # padded slots get all-PAD token rows
            tokens = self.item_tokens[np.maximum(hist_pos, 0)]
            batch["hist_tokens"] = (tokens * mask[..., None]).astype(
                self.item_tokens.dtype
            )
            batch["hist_mask"] = mask
            batch["hist_ratings"] = hist_rating
            batch["hist_rns"] = ((hist_pos + 1) * mask).astype(np.int32)
        if self.config.max_bag > 0:
            bag_pos = self.user_bag_pos[upos]
            # padding and the row's own positive are masked out
            bag_mask = (bag_pos >= 0) & (bag_pos != ipos[:, None])
            batch["bag_rns"] = ((bag_pos + 1) * bag_mask).astype(np.int32)
            batch["bag_ratings"] = self.user_bag_rating[upos]
            batch["bag_mask"] = bag_mask
        return batch

    def train_batches(self, epoch: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """Shuffled fixed-shape training batches with sampled negatives;
        the trailing partial batch is dropped. Each batch's assembly is a
        `data.batch` span."""
        cfg = self.config
        rng = np.random.default_rng((cfg.seed, epoch))
        order = rng.permutation(len(self.train_user_pos))
        batch = cfg.batch_size
        for start in range(0, len(order) - batch + 1, batch):
            with span("data.batch"):
                take = order[start : start + batch]
                assembled = self._assemble_loss_batch(
                    self.train_user_pos[take],
                    self.train_item_pos[take],
                    self.train_rating[take],
                    self.user_pos_idx,
                    self._neg_sampler,
                    hist=(
                        (
                            self.train_hist_pos[take],
                            self.train_hist_rating[take],
                        )
                        if cfg.max_history > 0
                        else None
                    ),
                )
            yield assembled

    def eval_interaction_batches(
        self, subset: str = "val"
    ) -> Iterator[dict[str, np.ndarray]]:
        """Held-out interaction batches shaped like `train_batches`, in a
        fixed order with a freshly seeded negative stream; a subset
        smaller than one batch is wrap-filled to one full batch."""
        cfg = self.config
        upos_all, ipos_all, rating_all = self._holdout_interactions[subset]
        sampler = NegativeItemSampler(self.num_items, seed=cfg.seed + 1)
        batch = cfg.batch_size
        indices = np.arange(len(upos_all))
        if 0 < indices.size < batch:
            indices = np.resize(indices, batch)
        for start in range(0, len(indices) - batch + 1, batch):
            take = indices[start : start + batch]
            upos = upos_all[take]
            yield self._assemble_loss_batch(
                upos,
                ipos_all[take],
                rating_all[take],
                self.user_holdout_pos_idx,
                sampler,
                # a holdout row's causal history is the user's whole
                # train history (the split is temporal per user)
                hist=(
                    (self.user_hist_pos[upos], self.user_hist_rating[upos])
                    if cfg.max_history > 0
                    else None
                ),
            )

    # ------------------------------------------------------------------
    def eval_users(self, subset: str) -> np.ndarray:
        """User positions belonging to an eval subset."""
        if subset == "predict":
            return np.flatnonzero(self.user_subsets["is_predict"])
        mask = self.user_subsets[f"is_{subset}"] & (self.target_counts > 0)
        return np.flatnonzero(mask)

    def eval_batches(
        self, subset: str = "val"
    ) -> Iterator[dict[str, np.ndarray]]:
        """Per-user eval batches: tokens, exclusions (padded with
        `num_items`), 0-padded targets; the last batch is padded with
        repeats and carries a `valid` mask."""
        cfg = self.config
        users = self.eval_users(subset)
        batch = cfg.eval_batch_size
        max_hist = max(
            (len(self._train_items_by_user.get(int(u), [])) for u in users),
            default=1,
        )
        max_hist = max(max_hist, 1)
        for start in range(0, len(users), batch):
            take = users[start : start + batch]
            valid = np.ones(len(take), dtype=bool)
            if len(take) < batch:
                pad = np.full(batch - len(take), take[-1])
                valid = np.concatenate(
                    [valid, np.zeros(batch - len(take), dtype=bool)]
                )
                take = np.concatenate([take, pad])
            exclude = _pad_rows(
                [
                    np.asarray(
                        self._train_items_by_user.get(int(u), []),
                        dtype=np.int64,
                    )
                    for u in take
                ],
                max_hist,
                self.num_items,
            )
            target_ids = _pad_rows(
                [self._target_ids[u] for u in take], self.max_targets, 0
            )
            ratings = np.zeros((batch, self.max_targets), dtype=np.float32)
            for i, u in enumerate(take):
                r = self._target_ratings[u][: self.max_targets]
                ratings[i, : len(r)] = r
            yield {
                "user_pos": take,
                "user_tokens": self.user_tokens[take],
                "exclude_positions": exclude,
                "target_ids": target_ids,
                "target_ratings": ratings,
                "valid": valid,
                **self.user_history_fields(take),
            }
