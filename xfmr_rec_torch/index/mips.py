"""Exact maximum-inner-product retrieval over a device-resident corpus.

Port of `xfmr_rec_tpu/index/mips.py`: the corpus lives on the card as
one (N, D) bf16, f32 or int8 (+ per-item scale) matrix and every search
is exhaustive. `method="scan"` rides the packed-key kernels
(`ops/topk.py`); `method="dense"` scores with one matmul and a stable
top-k. The on-disk layout (`corpus.npz` + `index.json`) is the JAX
package's, so an index saved by either package loads in the other.

Not ported yet (ROADMAP.md, Queue 1): BM25 text search, the f32 lane-max
scan (`scan_kernel="f32"`) and the f32 / "packed" certified methods,
which need kernels 3 and 4, and catalog mutation
(`add_items`/`remove_items`).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from xfmr_rec_torch.device import resolve_device
from xfmr_rec_torch.ops.topk import (
    packed_guaranteed_topk,
    packed_topk_excluding,
    pick_corpus_tile,
    topk_stable,
)

NEG_INF = float("-inf")

_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1)"


def _apply_exclusions(
    scores: torch.Tensor, exclude_positions: torch.Tensor | None
) -> torch.Tensor:
    """-inf at excluded corpus positions per row; positions outside
    [0, N) are padding and are dropped."""
    if exclude_positions is None:
        return scores
    num_items = scores.shape[1]
    excl = exclude_positions.long()
    valid = (excl >= 0) & (excl < num_items)
    # invalid entries aim at an extra column that is cut off afterwards
    padded = torch.cat(
        [scores, torch.zeros_like(scores[:, :1])], dim=1
    )
    padded.scatter_(1, torch.where(valid, excl, num_items), NEG_INF)
    return padded[:, :num_items]


def exact_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    exclude_positions: torch.Tensor | None = None,
    chunk_size: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive top-k MIPS: (scores (B, k) f32 descending, positions).

    Scores are f32 dots of the stored (bf16/f32) values; ties keep the
    lower position first, like `lax.top_k`. `chunk_size` streams over
    corpus tiles with a running top-k (memory O(B * chunk)).
    """
    num_items = corpus.shape[0]
    q32 = queries.float()
    if chunk_size is None or chunk_size >= num_items:
        scores = q32 @ corpus.float().T
        scores = _apply_exclusions(scores, exclude_positions)
        return topk_stable(scores, k)
    if num_items % chunk_size != 0:
        msg = f"{num_items=} must be divisible by {chunk_size=}"
        raise ValueError(msg)
    batch = queries.shape[0]
    best_scores = torch.full(
        (batch, k), NEG_INF, dtype=torch.float32, device=queries.device
    )
    best_pos = torch.zeros(
        (batch, k), dtype=torch.int64, device=queries.device
    )
    arange = torch.arange(chunk_size, device=queries.device)
    for start in range(0, num_items, chunk_size):
        scores = q32 @ corpus[start : start + chunk_size].float().T
        positions = (start + arange).expand(batch, -1)
        if exclude_positions is not None:
            hit = (
                positions[:, :, None] == exclude_positions[:, None, :]
            ).any(dim=-1)
            scores = torch.where(hit, NEG_INF, scores)
        tile_scores, tile_arg = topk_stable(scores, min(k, chunk_size))
        tile_pos = torch.gather(positions, 1, tile_arg)
        merged_scores = torch.cat([best_scores, tile_scores], dim=-1)
        merged_pos = torch.cat([best_pos, tile_pos], dim=-1)
        best_scores, arg = topk_stable(merged_scores, k)
        best_pos = torch.gather(merged_pos, 1, arg)
    return best_scores, best_pos


class CorpusMetadata:
    """Host-side id/metadata surface: `ids`, `_id_to_pos`, `metadata`,
    `id_col` are set by the subclass."""

    def __len__(self) -> int:
        return len(self.ids)

    def positions_of(
        self, id_lists: list[list[int]], width: int | None = None
    ) -> np.ndarray:
        """Per-row id lists -> padded corpus positions (pad = N), width
        rounded up to a power of two (at least 8)."""
        num_items = len(self.ids)
        if width is None:
            longest = max((len(x) for x in id_lists), default=1) or 1
            width = max(1 << (longest - 1).bit_length(), 8)
        out = np.full((len(id_lists), width), num_items, dtype=np.int32)
        for row, id_list in enumerate(id_lists):
            for col, id_val in enumerate(id_list[:width]):
                out[row, col] = self._id_to_pos.get(int(id_val), num_items)
        return out

    def get_id(self, id_val: int | None) -> dict:
        """Metadata row for one id ({} on a miss)."""
        if id_val is None:
            return {}
        pos = self._id_to_pos.get(int(id_val))
        if pos is None:
            return {}
        row = dict(self.metadata[pos])
        row[self.id_col] = int(self.ids[pos])
        return row


class RetrievalIndex(CorpusMetadata):
    """Corpus embeddings on the card + item metadata + exact search."""

    def __init__(
        self,
        embeddings: np.ndarray | torch.Tensor,
        ids: np.ndarray,
        metadata: list[dict] | None = None,
        *,
        id_col: str = "id",
        dtype: str = "bfloat16",
        chunk_size: int | None = None,
        method: str = "dense",
        scan_kernel: str = "packed",
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        if embeddings.shape[0] != len(ids):
            msg = "embeddings and ids must align"
            raise ValueError(msg)
        if method == "auto":
            # the packed scan wins once the (B, N) score matrix stops
            # fitting comfortably; small corpora are faster dense
            method = "scan" if embeddings.shape[0] >= 65536 else "dense"
        if method not in ("dense", "scan"):
            msg = f"unknown search method {method!r}"
            raise ValueError(msg)
        if scan_kernel not in ("f32", "packed"):
            msg = f"unknown scan_kernel {scan_kernel!r}"
            raise ValueError(msg)
        self.id_col = id_col
        self.ids = np.asarray(ids)
        self._ids32 = self.ids.astype(np.int32)
        self.metadata = metadata or [{} for _ in self.ids]
        self._id_to_pos = {int(i): p for p, i in enumerate(self.ids)}
        self.chunk_size = chunk_size
        self.dtype = dtype
        if dtype == "int8":
            # per-item symmetric quantization, c_i ~= scale_i * q_i (same
            # numpy arithmetic as the reference, so both packages store
            # identical int8 rows and scales)
            emb = np.asarray(
                embeddings.cpu() if torch.is_tensor(embeddings) else embeddings,
                dtype=np.float32,
            )
            scale = np.maximum(np.abs(emb).max(axis=1) / 127.0, 1e-12)
            quant = np.clip(
                np.round(emb / scale[:, None]), -127, 127
            ).astype(np.int8)
            self.corpus = torch.from_numpy(quant).to(self.device)
            self._scales = torch.from_numpy(
                scale.astype(np.float32).reshape(1, -1)
            ).to(self.device)
            self._query_dtype = torch.bfloat16
            method = "scan"  # int8 rides the dequantizing scan kernel
            self._corpus_maxnorm = float(
                (np.linalg.norm(quant.astype(np.float32), axis=1) * scale)
                .max(initial=0.0)
            )
        else:
            emb = torch.as_tensor(embeddings, dtype=torch.float32).to(
                self.device
            )
            self.corpus = emb.to(getattr(torch, dtype))
            self._scales = None
            self._query_dtype = self.corpus.dtype
            self._corpus_maxnorm = (
                float(torch.linalg.vector_norm(emb, dim=1).max())
                if emb.shape[0]
                else 0.0
            )
        if method == "scan" and scan_kernel == "f32":
            msg = f"scan_kernel='f32' needs the lane-max scan kernel, {_NOT_PORTED}"
            raise NotImplementedError(msg)
        self.method = method
        self.scan_kernel = scan_kernel
        self.last_certified_stats: dict = {}
        self._scan_state = None

    @property
    def dim(self) -> int:
        return self.corpus.shape[1]

    def _scan_setup(self):
        """Padded corpus (+ scales) and tile geometry, built once and
        shared by the search and certified paths."""
        if self._scan_state is None:
            true_n = self.corpus.shape[0]
            tile = pick_corpus_tile(true_n, self.corpus.shape[1])
            pad = -true_n % tile
            corpus = self.corpus
            scales = self._scales
            if pad:
                corpus = torch.nn.functional.pad(corpus, (0, 0, 0, pad))
                if scales is not None:
                    scales = torch.nn.functional.pad(scales, (0, pad))
            self._scan_state = (corpus, scales, tile, true_n)
        return self._scan_state

    def _dense_exact(
        self, queries: torch.Tensor, k: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dense exact top-k (the certified paths' residual fallback)."""
        if self._scales is not None:
            scores = (
                queries.float() @ self.corpus.to(torch.bfloat16).float().T
            ) * self._scales[0][None, :]
            return topk_stable(scores, k)
        return exact_topk(queries, self.corpus, k, chunk_size=self.chunk_size)

    def search(
        self,
        queries: np.ndarray | torch.Tensor,
        *,
        top_k: int,
        exclude_ids: list[list[int]] | None = None,
        exclude_positions: np.ndarray | torch.Tensor | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched search. Returns (scores (B, k), item_ids (B, k))."""
        queries = torch.as_tensor(queries).to(self.device, self._query_dtype)
        if queries.dim() == 1:
            queries = queries[None, :]
        if exclude_positions is None:
            if exclude_ids is not None:
                exclude_positions = self.positions_of(exclude_ids)
            else:
                exclude_positions = np.full(
                    (queries.shape[0], 1), len(self.ids), dtype=np.int32
                )
        exclude_positions = torch.as_tensor(exclude_positions).to(
            self.device, torch.int32
        )
        if self.method == "scan":
            corpus, scales, tile, true_n = self._scan_setup()
            # score bound on the device, in f32, as the reference does
            qnorm = torch.linalg.vector_norm(queries.float(), dim=-1).max()
            bound = torch.clamp(
                self._corpus_maxnorm * qnorm * 1.05, min=1e-6
            ).float()
            scores, positions = packed_topk_excluding(
                queries,
                corpus,
                top_k,
                exclude_positions=exclude_positions,
                score_bound=bound,
                true_num_items=true_n,
                corpus_tile=tile,
                scales=scales,
            )
        else:
            scores, positions = exact_topk(
                queries,
                self.corpus,
                top_k,
                exclude_positions=exclude_positions,
                chunk_size=self.chunk_size,
            )
        item_ids = self._ids32[positions.cpu().numpy()]
        return scores.cpu().numpy(), item_ids

    def search_certified(
        self,
        queries: np.ndarray | torch.Tensor,
        *,
        top_k: int,
        method: str = "fused",
        exact_scores: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Guaranteed-exact batched search (no exclusions).

        method="fused": the packed pass 1 with discard certificates,
        lane-shuffled retries and key-space pool merges
        (`packed_guaranteed_topk`), then the dense exact path for the
        rows still uncertified. Every returned row is the exact top-k of
        the packed (quantized-score) order. Scores are quantum-floor
        decodes, or exact f32 with `exact_scores=True`.
        """
        if method != "fused":
            if method in ("f32", "packed"):
                msg = f"search_certified(method={method!r}) is {_NOT_PORTED}"
                raise NotImplementedError(msg)
            msg = f"unknown certified search method {method!r}"
            raise ValueError(msg)
        if torch.is_tensor(queries):
            queries = queries.float().cpu().numpy()
        queries_f32 = np.asarray(queries, np.float32)
        if queries_f32.ndim == 1:
            queries_f32 = queries_f32[None, :]
        corpus, scales, tile, true_n = self._scan_setup()
        # host-side bound, in f64 then rounded to f32, as the reference
        qnorm = float(np.linalg.norm(queries_f32, axis=-1).max())
        bound = torch.tensor(
            np.float32(max(self._corpus_maxnorm * qnorm * 1.05, 1e-6)),
            device=self.device,
        )
        true_batch = queries_f32.shape[0]
        width = max(8, 1 << (true_batch - 1).bit_length())
        queries_dev = torch.from_numpy(
            np.pad(queries_f32, ((0, width - true_batch), (0, 0)))
        ).to(self.device, self._query_dtype)
        scores, positions, exact = packed_guaranteed_topk(
            queries_dev,
            corpus,
            top_k,
            score_bound=bound,
            batch_tile=512,
            corpus_tile=tile,
            merge_levels=1,
            merge_keep=3,
            true_num_items=true_n,
            scales=scales,
            retries=3,
            recompute_scores=exact_scores,
        )
        scores = scores.cpu().numpy()[:true_batch]
        positions = positions.cpu().numpy()[:true_batch]
        exact = exact.cpu().numpy()[:true_batch]
        bad = np.nonzero(~exact)[0]
        self.last_certified_stats = {
            "batch": true_batch,
            "pipeline_bad": int(bad.size),
        }
        if bad.size:
            rw = max(8, 1 << (int(bad.size) - 1).bit_length())
            retry = np.zeros((rw, self.dim), dtype=np.float32)
            retry[: bad.size] = queries_f32[bad]
            s3, p3 = self._dense_exact(
                torch.from_numpy(retry).to(self.device, self._query_dtype),
                top_k,
            )
            scores[bad] = s3.cpu().numpy()[: bad.size]
            positions[bad] = p3.cpu().numpy()[: bad.size]
        return scores, self._ids32[positions]

    def add_items(self, *args, **kwargs) -> None:
        msg = f"RetrievalIndex.add_items is {_NOT_PORTED}"
        raise NotImplementedError(msg)

    def remove_items(self, *args, **kwargs) -> None:
        msg = f"RetrievalIndex.remove_items is {_NOT_PORTED}"
        raise NotImplementedError(msg)

    # -- persistence ------------------------------------------------------
    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        embeddings = self.corpus.float()
        if self._scales is not None:
            # dequantize: re-quantizing these exact values reproduces the
            # same int8 corpus
            embeddings = embeddings * self._scales[0][:, None]
        np.savez(
            path / "corpus.npz",
            embeddings=embeddings.cpu().numpy(),
            ids=self.ids,
        )
        meta = {
            "id_col": self.id_col,
            "dtype": self.dtype,
            "chunk_size": self.chunk_size,
            "method": self.method,
            "scan_kernel": self.scan_kernel,
            "metadata": self.metadata,
        }
        (path / "index.json").write_text(json.dumps(meta))

    @classmethod
    def load(
        cls, path: str | pathlib.Path, *, device: str | torch.device = "cuda"
    ) -> RetrievalIndex:
        path = pathlib.Path(path)
        meta = json.loads((path / "index.json").read_text())
        with np.load(path / "corpus.npz", allow_pickle=False) as arrays:
            embeddings, ids = arrays["embeddings"], arrays["ids"]
        return cls(
            embeddings,
            ids,
            metadata=meta["metadata"],
            id_col=meta["id_col"],
            dtype=meta["dtype"],
            chunk_size=meta["chunk_size"],
            method=meta.get("method", "dense"),
            scan_kernel=meta.get("scan_kernel", "f32"),
            device=device,
        )
