"""Artifact-backed recommendation engine on the card: text tower + exact
index.

Port of `xfmr_rec_tpu/serving/engine.py` for the text tower with
`index_kind="exact"`. It loads the artifact `Trainer.save` writes, using
only files that need no JAX, flax or pandas to read: `processors.json`,
`portable.json` + `encoder.npz` (the flat encoder weights), `vocab.json`
when the tokenizer is "vocab", and `index/`.

Not ported yet (ROADMAP.md, Queue 1): the history tower and item-identity
channels (two-tower artifacts), the CF channel, IVF and sharded indexes,
live catalog mutation, and the user store (it reads `users.parquet`,
which needs a parquet-free replacement first).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from xfmr_rec_torch.device import resolve_device
from xfmr_rec_torch.index.mips import RetrievalIndex
from xfmr_rec_torch.models.convert import build_encoder, load_portable
from xfmr_rec_torch.models.encoder import ModelConfig, needs_two_tower
from xfmr_rec_torch.models.tokenizer import (
    HashingTokenizer,
    TokenizerConfig,
    VocabTokenizer,
)
from xfmr_rec_torch.params import (
    INDEX_DIR,
    PROCESSORS_JSON,
    TOP_K,
    VOCAB_JSON,
)
from xfmr_rec_torch.serving.schemas import (
    ItemCandidate,
    ItemQuery,
    NotFoundError,
    Query,
)

_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1)"


class RecommenderEngine:
    """Loads the artifact and serves embed / item search / item lookup."""

    def __init__(
        self,
        artifact_dir: str | pathlib.Path,
        *,
        warmup: bool = True,
        index_kind: str = "exact",
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        if index_kind != "exact":
            msg = f"index_kind={index_kind!r} is {_NOT_PORTED}"
            raise NotImplementedError(msg)
        self.index_kind = index_kind
        path = pathlib.Path(artifact_dir)
        self.manifest = json.loads((path / PROCESSORS_JSON).read_text())
        self.model_config = ModelConfig.from_dict(self.manifest["model"])
        if needs_two_tower(self.model_config):
            msg = (
                "two-tower artifacts (history user tower or item-identity "
                f"channels) are {_NOT_PORTED}"
            )
            raise NotImplementedError(msg)
        if self.model_config.cf_rank > 0:
            msg = f"the CF scoring channel is {_NOT_PORTED}"
            raise NotImplementedError(msg)
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
        _, _, state = load_portable(path)
        self.encoder = build_encoder(self.model_config, state, self.device)
        self.index = RetrievalIndex.load(path / INDEX_DIR, device=self.device)
        if warmup:
            # first search builds the kernels and pads the corpus, so
            # the first live request does not pay for it
            self.search_items(Query(text="warmup"), top_k=TOP_K)

    # -- embedder --------------------------------------------------------
    def embed(self, texts: list[str]) -> np.ndarray:
        tokens = torch.from_numpy(self.tokenizer.encode_batch(texts))
        return self.encoder(tokens.to(self.device)).cpu().numpy()

    def embed_query(self, query: Query) -> Query:
        embedding = self.embed([query.text])[0]
        return Query(text=query.text, embedding=embedding.tolist())

    def _pad_query_vec(self, vec: np.ndarray) -> np.ndarray:
        """Query vector at index width. The text tower's width already
        is the index's (the bias and CF columns belong to channels not
        ported yet), so this only checks it."""
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
        scores, item_ids = self.index.search(
            embedding,
            top_k=top_k,
            exclude_ids=[list(exclude_item_ids or [])],
        )
        return self._candidates(scores[0], item_ids[0])

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
