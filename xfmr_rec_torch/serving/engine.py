"""Artifact-backed recommendation engine on the card.

Port of `xfmr_rec_tpu/serving/engine.py`. It loads the artifact
`Trainer.save` (either package's) writes, using only files that need no
JAX, flax or pandas to read: `processors.json`; the
text encoder from `portable.json` + `encoder.npz`, or for a two-tower
model (history user tower, item-identity channels) the whole tree from
`encoder.msgpack` (`utils/flax_msgpack.py`); `vocab.json` when the
tokenizer is "vocab"; `index/`; `cf.npz` for the CF channel; and the user
store `users.npz` (`serving/users.py`; a JAX artifact's `users.parquet`
converts with `UserStore.from_rows`). Without a user store every user id
is unknown.

User queries run the model's user tower: the profile text, or for the
history tower the profile fused with the user's most recent rated items,
their embeddings gathered from the packaged corpus (f32 from the index's
stored values) on the device. Query vectors are padded to the index
width: the constant 1 paired with the bias column, the CF columns.

`add_items` grows the live catalog: the new items are encoded by the
item tower, a new index over the appended corpus is built and warmed on
the card, and then published by one reference swap, so searches never
lock and each reads one consistent index. `search_items_text` and
`search_users_text` are BM25 keyword search over the item metadata and
the user store's profile text.

`index_kind="ivf"` builds an `IVFIndex` (`index/ivf.py`) over the
index's corpus at load, or loads the one cached under `ivf/` when its
`fingerprint.json` holds the sha256 of `index/corpus.npz`, and measures
the probe's recall@10 (a warning below `ivf_min_recall`, an error with
`ivf_enforce_recall`). Item search then probes `nprobe` clusters a
query; with `ivf_certified` a row whose certificate fails is answered by
the exact index (the packed scan, kernel 1, from 65,536 items), so every
answer is exact. The IVF snapshots the corpus, so `add_items` is refused
under it.

`index_kind="sharded"` loads the index as a `ShardedRetrievalIndex`
(`index/sharded.py`) over `mesh`, by default every visible card with
`model_parallel` of them (default all) on the model axis. Searches,
the micro-batcher's included, go through it (`search_vectors`); it
snapshots the corpus too, so `add_items` is refused.
"""

from __future__ import annotations

import hashlib
import json
import logging
import pathlib
import threading

import numpy as np
import torch

from xfmr_rec_torch.device import resolve_device
from xfmr_rec_torch.index.ivf import IVFIndex
from xfmr_rec_torch.index.mips import BM25Index, RetrievalIndex
from xfmr_rec_torch.index.sharded import ShardedRetrievalIndex
from xfmr_rec_torch.models.cf import CFChannel
from xfmr_rec_torch.models.convert import (
    build_encoder,
    load_portable,
    read_msgpack,
    two_tower_state_from_flat,
)
from xfmr_rec_torch.models.encoder import ModelConfig, needs_two_tower
from xfmr_rec_torch.models.history import TwoTowerModel
from xfmr_rec_torch.models.tokenizer import (
    HashingTokenizer,
    TokenizerConfig,
    VocabTokenizer,
)
from xfmr_rec_torch.parallel.mesh import Mesh, create_mesh
from xfmr_rec_torch.params import (
    CF_NPZ,
    ENCODER_MSGPACK,
    INDEX_DIR,
    PROCESSORS_JSON,
    TOP_K,
    USERS_NPZ,
    VOCAB_JSON,
)
from xfmr_rec_torch.serving.schemas import (
    Activity,
    ItemCandidate,
    ItemQuery,
    NotFoundError,
    Query,
    UserQuery,
)
from xfmr_rec_torch.serving.users import UserStore

logger = logging.getLogger(__name__)

_INDEX_KINDS = ("exact", "ivf", "sharded")


class RecommenderEngine:
    """Loads the artifact and serves embed / item search / lookups / the
    user tower."""

    def __init__(
        self,
        artifact_dir: str | pathlib.Path,
        *,
        warmup: bool = True,
        index_kind: str = "exact",
        nprobe: int = 8,
        ivf_min_recall: float = 0.5,
        ivf_enforce_recall: bool = False,
        ivf_certified: bool = False,
        model_parallel: int | None = None,
        mesh: Mesh | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        if index_kind not in _INDEX_KINDS:
            msg = f"unknown index_kind {index_kind!r}"
            raise ValueError(msg)
        self.index_kind = index_kind
        path = pathlib.Path(artifact_dir)
        self.manifest = json.loads((path / PROCESSORS_JSON).read_text())
        self.model_config = ModelConfig.from_dict(self.manifest["model"])
        data_config = self.manifest.get("data", {})
        if data_config.get("tokenizer", "hashing") == "vocab":
            self.tokenizer = VocabTokenizer.load(path / VOCAB_JSON)
        else:
            self.tokenizer = HashingTokenizer(
                TokenizerConfig(
                    vocab_size=data_config.get(
                        "vocab_size", self.model_config.vocab_size
                    ),
                    max_length=data_config.get(
                        "max_length", self.model_config.max_length
                    ),
                )
            )
        if needs_two_tower(self.model_config):
            state = two_tower_state_from_flat(
                read_msgpack(path / ENCODER_MSGPACK), self.model_config
            )
            self.encoder = build_encoder(
                self.model_config, state, self.device, cls=TwoTowerModel
            )
        else:
            _, _, state = load_portable(path)
            self.encoder = build_encoder(self.model_config, state, self.device)
        if index_kind == "sharded":
            # one on-disk layout: the artifact serves on one device or
            # split over the mesh's model axis
            self.index = ShardedRetrievalIndex.load(
                path / INDEX_DIR, mesh=mesh or self._default_mesh(model_parallel)
            )
        else:
            self.index = RetrievalIndex.load(path / INDEX_DIR, device=self.device)
        self.ivf: IVFIndex | None = None
        self._ivf_certified = bool(ivf_certified)
        # rows the certified probe answered / handed to the exact index
        self.ivf_rows = {"certified": 0, "fallback": 0}
        self._ivf_rows_lock = threading.Lock()
        if index_kind == "ivf":
            self.ivf = self._load_ivf(path, nprobe)
            recall = self.ivf.recall_probe(top_k=10, nprobe=nprobe)
            self.ivf_probe_recall = recall
            if recall < ivf_min_recall:
                msg = (
                    f"IVF probe recall@10 = {recall:.2f} at nprobe={nprobe} "
                    f"(threshold {ivf_min_recall}): this corpus does not "
                    "cluster well; raise nprobe or use index_kind='exact'"
                )
                if ivf_enforce_recall:
                    raise RuntimeError(msg)
                logger.warning(msg)
            else:
                logger.info(
                    "IVF probe recall@10 = %.3f at nprobe=%d", recall, nprobe
                )
        self.cf = None
        if self.model_config.cf_rank > 0 and (path / CF_NPZ).exists():
            self.cf = CFChannel.load(path / CF_NPZ)
        # query width before the CF columns: d (+ the bias pair)
        self._base_width = self.model_config.hidden_size + int(
            self.model_config.item_bias
        )
        self._hist_corpus = None
        if self.model_config.user_tower == "history":
            # the stored corpus in f32, d-dim part, for the history gather:
            # the fusion casts it to compute_dtype, so at bf16 it reads the
            # values the trainer's f32 rows round to
            self._hist_corpus = self.index.dequantized(self.device)[
                :, : self.model_config.hidden_size
            ].contiguous()
        self.users = (
            UserStore.load(path / USERS_NPZ)
            if (path / USERS_NPZ).exists()
            else None
        )
        self._user_fts: BM25Index | None = None
        # serializes catalog mutations; searches take no lock
        self._catalog_lock = threading.Lock()
        if warmup:
            # first search builds the kernels and pads the corpus, so
            # the first live request does not pay for it
            self.search_items(Query(text="warmup"), top_k=TOP_K)

    def _default_mesh(self, model_parallel: int | None) -> Mesh:
        """The sharded index's mesh: every visible card, `model_parallel`
        of them (default all) on the model axis; on the CPU, a virtual
        mesh of `model_parallel` (default 1) CPU devices."""
        if self.device.type == "cuda":
            return create_mesh(
                model_parallel=model_parallel or torch.cuda.device_count()
            )
        shards = model_parallel or 1
        return create_mesh(model_parallel=shards, devices=[self.device] * shards)

    def _load_ivf(self, path: pathlib.Path, nprobe: int) -> IVFIndex:
        """The IVF cached under `ivf/` when it was built from this
        artifact's `index/corpus.npz` (by sha256), else a new build from
        the index's stored corpus in f32 (dequantized for int8), cached
        there; a read-only artifact rebuilds on every load."""
        ivf_dir = path / "ivf"
        fp_file = ivf_dir / "fingerprint.json"
        corpus_fp = hashlib.sha256(
            (path / INDEX_DIR / "corpus.npz").read_bytes()
        ).hexdigest()
        cached_fp = None
        if fp_file.exists():
            cached_fp = json.loads(fp_file.read_text()).get("corpus_sha256")
        self.ivf_cache_hit = (
            (ivf_dir / "ivf.npz").exists() and cached_fp == corpus_fp
        )
        if self.ivf_cache_hit:
            ivf = IVFIndex.load(ivf_dir, device=self.device)
            ivf.nprobe = nprobe
            return ivf
        if (ivf_dir / "ivf.npz").exists():
            logger.warning(
                "cached IVF was built from a different corpus (artifact "
                "re-exported?); rebuilding"
            )
        ivf = IVFIndex(
            self.index.dequantized(torch.device("cpu")).numpy(),
            self.index.ids,
            nprobe=nprobe,
            device=self.device,
        )
        try:
            ivf.save(ivf_dir)
            fp_file.write_text(json.dumps({"corpus_sha256": corpus_fp}))
        except OSError:
            logger.warning("could not cache IVF index to %s", ivf_dir)
        return ivf

    # -- embedder --------------------------------------------------------
    def embed(self, texts: list[str]) -> np.ndarray:
        tokens = torch.from_numpy(self.tokenizer.encode_batch(texts))
        return self.encoder(tokens.to(self.device)).cpu().numpy()

    def embed_query(self, query: Query) -> Query:
        embedding = self.embed([query.text])[0]
        return Query(text=query.text, embedding=embedding.tolist())

    # -- scoring columns (item bias, CF channel) ---------------------------
    def _cf_query_cols(self, history: list[Activity] | None) -> np.ndarray:
        """(rank + 1,) CF query columns: cf_weight * the unit CF vector of
        the history's items, then cf_pop_weight for the popularity
        column. Unknown movie ids contribute nothing."""
        positions = [
            self.index._id_to_pos.get(int(entry.movie_id), -1)
            for entry in (history or [])
        ]
        vec = self.cf.user_vectors(
            np.asarray(positions or [-1], dtype=np.int64)
        )
        return np.concatenate([
            np.float32(self.model_config.cf_weight) * vec,
            np.asarray([self.model_config.cf_pop_weight], np.float32),
        ])

    def _pad_query_vec(self, vec: np.ndarray) -> np.ndarray:
        """A query vector at index width: a d-wide text vector gets the
        constant 1 of the bias pair, and a vector without CF columns gets
        zero CF and the popularity weight (anonymous and raw-text queries
        rank by the learned and popularity channels alone)."""
        if self.model_config.item_bias and vec.shape[-1] == (
            self.model_config.hidden_size
        ):
            vec = np.concatenate([vec, np.ones(1, vec.dtype)])
        if self.cf is not None and vec.shape[-1] == self._base_width:
            vec = np.concatenate([
                vec,
                np.zeros(self.cf.rank, vec.dtype),
                np.asarray([self.model_config.cf_pop_weight], vec.dtype),
            ])
        if vec.shape[-1] != self.index.dim:
            msg = f"query width {vec.shape[-1]} != index width {self.index.dim}"
            raise ValueError(msg)
        return vec

    # -- item store ------------------------------------------------------
    def _candidates(
        self, scores: np.ndarray, item_ids: np.ndarray
    ) -> list[ItemCandidate]:
        return [
            ItemCandidate(
                movie_id=int(item_id),
                movie_text=str(
                    self.index.get_id(int(item_id)).get("movie_text", "")
                ),
                score=float(score),
            )
            for score, item_id in zip(scores, item_ids, strict=True)
            if int(item_id) != -1
        ]

    def search_items(
        self,
        query: Query,
        exclude_item_ids: list[int] | None = None,
        top_k: int = TOP_K,
    ) -> list[ItemCandidate]:
        if query.embedding is None:
            query = self.embed_query(query)
        embedding = self._pad_query_vec(
            np.asarray(query.embedding, dtype=np.float32)
        )
        scores, item_ids = self.search_vectors(
            embedding[None], [list(exclude_item_ids or [])], top_k
        )
        return self._candidates(scores[0], item_ids[0])

    def search_vectors(
        self, queries: np.ndarray, exclude_ids: list[list[int]], top_k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """(scores, item_ids) of index-width query rows through the
        engine's index kind: the exact index, the IVF probe, or the
        certified probe with the exact index answering the rows whose
        certificate fails."""
        if self.ivf is None:
            return self.index.search(
                queries, top_k=top_k, exclude_ids=exclude_ids
            )
        if not self._ivf_certified:
            return self.ivf.search(
                queries, top_k=top_k, exclude_ids=exclude_ids
            )
        scores, item_ids, exact = self.ivf.search_certified(
            queries, top_k=top_k, exclude_ids=exclude_ids
        )
        fallback = np.flatnonzero(~exact)
        with self._ivf_rows_lock:
            self.ivf_rows["certified"] += len(exact) - len(fallback)
            self.ivf_rows["fallback"] += len(fallback)
        if not len(fallback):
            return scores, item_ids
        if scores.shape[1] < top_k:
            # a pool smaller than top_k is never certified: widen to k
            pad = top_k - scores.shape[1]
            scores = np.pad(scores, ((0, 0), (0, pad)),
                            constant_values=-np.inf)
            item_ids = np.pad(item_ids, ((0, 0), (0, pad)),
                              constant_values=-1)
        exact_scores, exact_ids = self.index.search(
            queries[fallback],
            top_k=top_k,
            exclude_ids=[exclude_ids[row] for row in fallback],
        )
        scores[fallback] = exact_scores
        item_ids[fallback] = exact_ids
        return scores, item_ids

    def get_item(self, item_id: int) -> ItemQuery:
        row = self.index.get_id(item_id)
        if not row:
            msg = f"item not found: {item_id=}"
            raise NotFoundError(msg)
        return ItemQuery(
            movie_rn=int(row.get("movie_rn", 0)),
            movie_id=int(row["movie_id"]),
            movie_text=str(row.get("movie_text", "")),
        )

    def process_item(self, item: ItemQuery) -> Query:
        return Query(text=item.movie_text)

    def _encode_items(self, items: list[ItemQuery]) -> torch.Tensor:
        """(n, index width) f32 rows of new items on the device: the item
        tower (text, identity channels, bias column) and, with the CF
        channel, zero CF factors and zero popularity (no train
        interactions)."""
        tokens = torch.from_numpy(
            self.tokenizer.encode_batch([item.movie_text for item in items])
        ).to(self.device)
        if isinstance(self.encoder, TwoTowerModel):
            rns = torch.tensor(
                [int(item.movie_rn) for item in items], device=self.device
            )
            rows = self.encoder.encode_items(tokens, rns)
        else:
            rows = self.encoder(tokens)
        rows = rows.float()
        if self.cf is not None:
            rows = torch.nn.functional.pad(rows, (0, self.cf.rank + 1))
        return rows

    def add_items(self, items: list[ItemQuery]) -> int:
        """Add items to the live catalog; returns how many were added.

        Builds a new `RetrievalIndex` over the appended corpus (on the
        card; an int8 corpus is dequantized through the host and
        re-quantized, as the reference does), runs one search on it so
        its padded scan corpus exists before it serves, and then swaps
        `self.index`. With the history tower the gather corpus grows
        first: a user query reads positions from the index and rows from
        `_hist_corpus` afterwards, and both only grow. Ids must be new;
        concurrent calls serialize. The live engine offers no deletion:
        compaction would move positions under a user query in flight.
        Refused under `index_kind="ivf"` and `"sharded"`: both snapshot
        the corpus at load and pick new items up from a re-exported
        artifact.
        """
        if self.index_kind != "exact":
            msg = (
                f"live catalog updates need index_kind='exact' "
                f"(got {self.index_kind!r}: ivf/sharded snapshot the "
                "corpus at load and rebuild on the next boot)"
            )
            raise RuntimeError(msg)
        if not items:
            return 0
        new_ids = [int(item.movie_id) for item in items]
        if len(set(new_ids)) != len(new_ids):
            dupes = sorted({i for i in new_ids if new_ids.count(i) > 1})
            msg = f"duplicate ids within the added batch: {dupes[:8]}"
            raise ValueError(msg)
        with self._catalog_lock:
            old = self.index
            clashes = [i for i in new_ids if i in old._id_to_pos]
            if clashes:
                msg = f"item ids already in the catalog: {clashes[:8]}"
                raise ValueError(msg)
            rows = self._encode_items(items)
            if old._scales is not None:
                corpus = torch.cat([
                    old.corpus.float() * old._scales[0][:, None], rows
                ]).cpu().numpy()
            else:
                corpus = torch.cat([old.corpus, rows.to(old.corpus.dtype)])
            new_index = RetrievalIndex(
                corpus,
                np.concatenate([old.ids, np.asarray(new_ids)]),
                metadata=list(old.metadata) + [
                    {
                        "movie_rn": int(item.movie_rn),
                        "movie_id": int(item.movie_id),
                        "movie_text": item.movie_text,
                    }
                    for item in items
                ],
                id_col=old.id_col,
                dtype=old.dtype,
                chunk_size=old.chunk_size,
                method=old.method,
                scan_kernel=old.scan_kernel,
                device=self.device,
            )
            if self._hist_corpus is not None:
                self._hist_corpus = torch.cat([
                    self._hist_corpus,
                    rows[:, : self.model_config.hidden_size],
                ])
            new_index.search(
                np.zeros((1, new_index.dim), np.float32), top_k=TOP_K
            )
            self.index = new_index
        return len(items)

    def search_items_text(self, query: str, *, top_k: int = 10) -> list[dict]:
        """BM25 keyword search over the item text."""
        return self.index.search_text(query, top_k=top_k)

    # -- user store ------------------------------------------------------
    def get_user(self, user_id: int) -> UserQuery:
        if self.users is None:
            msg = (
                f"user not found: {user_id=} (the artifact has no user "
                f"store {USERS_NPZ})"
            )
            raise NotFoundError(msg)
        return self.users.get(user_id)

    def user_activity(
        self, user_id: int, activity_name: str
    ) -> dict[int, int]:
        """{movie_id: rating} of a user's `history` or `target` ({} for a
        user the store does not hold)."""
        if self.users is None or user_id not in self.users:
            return {}
        return {
            entry.movie_id: entry.rating
            for entry in self.users.activities(user_id, activity_name)
        }

    def process_user(self, user: UserQuery) -> Query:
        return Query(text=user.user_text)

    def search_users_text(self, query: str, *, top_k: int = 10) -> list[dict]:
        """BM25 keyword search over the user store's profile text, built
        at the first call: `user_id`, `user_text` and `score` per hit."""
        if self.users is None:
            return []
        ids = self.users.arrays["user_id"]
        texts = self.users.arrays["user_text"]
        if self._user_fts is None:
            self._user_fts = BM25Index(
                [{"user_text": str(t)} for t in texts], text_col="user_text"
            )
        return [
            {
                "user_id": int(ids[row]),
                "user_text": str(texts[row]),
                "score": score,
            }
            for row, score in self._user_fts.search(query, top_k=top_k)
        ]

    def _history_inputs(
        self, entries: list[Activity], width: int, bag: bool
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The most recent `width` known items of `entries` (time-sorted),
        most-recent-first: corpus positions (or, for the bag, movie_rns =
        position + 1), ratings and mask, each (1, width)."""
        cfg = self.model_config
        pos = np.zeros((1, width), np.int32)
        ratings = np.zeros((1, width), np.int32)
        mask = np.zeros((1, width), bool)
        filled = 0
        for entry in reversed(entries):
            if filled == width:
                break
            p = self.index._id_to_pos.get(int(entry.movie_id))
            if p is None:
                continue
            if bag and cfg.item_id_embedding == "dense" and (
                p + 1 >= cfg.item_id_buckets
            ):
                # past the trained dense table: the clipped gather would
                # alias the last row, so it counts as unknown
                continue
            pos[0, filled] = p + 1 if bag else p
            ratings[0, filled] = int(entry.rating)
            mask[0, filled] = True
            filled += 1
        return pos, ratings, mask

    def embed_user_query(self, user: UserQuery) -> Query:
        """The user tower's query vector at index width: the profile text
        (+ CF columns of its history), or the history fusion over the
        user's most recent known rated items, most-recent-first, their
        embeddings gathered from the packaged corpus."""
        cfg = self.model_config
        if cfg.user_tower != "history":
            query = self.embed_query(self.process_user(user))
            if self.cf is None:
                return query
            embedding = np.concatenate([
                self._pad_query_vec(
                    np.asarray(query.embedding, np.float32)
                )[: self._base_width],
                self._cf_query_cols(user.history),
            ])
            return Query(text=query.text, embedding=embedding.tolist())
        entries = sorted(user.history or [], key=lambda e: e.datetime)
        hist_pos, hist_rat, hist_mask = self._history_inputs(
            entries, cfg.max_history, bag=False
        )
        extras = [hist_pos, hist_mask, hist_rat]
        if cfg.max_bag > 0:
            bag_rns, bag_rat, bag_mask = self._history_inputs(
                entries, cfg.max_bag, bag=True
            )
            extras += [bag_rns, bag_rat, bag_mask]
        tokens = self.tokenizer.encode_batch([user.user_text])
        embedding = self.encoder.encode_users_from_corpus(
            torch.from_numpy(tokens).to(self.device),
            self._hist_corpus,
            *(torch.from_numpy(x).to(self.device) for x in extras),
        )[0].cpu().numpy()
        if self.cf is not None:
            embedding = np.concatenate(
                [embedding, self._cf_query_cols(user.history)]
            )
        return Query(text=user.user_text, embedding=embedding.tolist())
