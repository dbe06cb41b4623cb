"""Exact maximum-inner-product retrieval over a device-resident corpus.

Port of `xfmr_rec_tpu/index/mips.py`: the corpus lives on the card as
one (N, D) bf16, f32 or int8 (+ per-item scale) matrix and every search
is exhaustive. `method="scan"` rides the packed-key kernels
(`ops/topk.py`, `scan_kernel="packed"`) or the f32 lane-max kernel
(`ops/topk_f32.py`, `scan_kernel="f32"`); `method="dense"` scores with
one matmul and a stable top-k. The on-disk layout (`corpus.npz` +
`index.json`) is the JAX package's, so an index saved by either package
loads in the other.

`BM25Index` is keyword search over the metadata text, in C++
(`native/bm25.cpp`) with a numpy oracle behind `native=False`;
`RetrievalIndex.search_text` rides it. `add_items` / `remove_items`
mutate the catalog in place: the corpus grows or compacts on the card,
and what was cached for the old length (the padded scan corpus, the text
index) is dropped.
"""

from __future__ import annotations

import json
import math
import pathlib
import re

import numpy as np
import torch

from xfmr_rec_torch.device import resolve_device
from xfmr_rec_torch.ops.topk import (
    decode_scores,
    exact_scores_at,
    packed_certified_parts,
    packed_guaranteed_topk,
    packed_topk_excluding,
    pick_corpus_tile,
    topk_stable,
)
from xfmr_rec_torch.ops.topk_f32 import (
    certified_topk_parts,
    scan_topk_excluding,
)

NEG_INF = float("-inf")


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


def _quantize(
    embeddings: np.ndarray | torch.Tensor, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, float]:
    """Per-item symmetric int8 quantization, c_i ~= scale_i * q_i, on the
    host in the reference's numpy arithmetic (so both packages store
    identical rows and scales): the int8 rows and (1, N) scales on
    `device`, and the largest dequantized row norm."""
    emb = np.asarray(
        embeddings.cpu() if torch.is_tensor(embeddings) else embeddings,
        dtype=np.float32,
    )
    scale = np.maximum(np.abs(emb).max(axis=1) / 127.0, 1e-12)
    quant = np.clip(np.round(emb / scale[:, None]), -127, 127).astype(np.int8)
    maxnorm = float(
        (np.linalg.norm(quant.astype(np.float32), axis=1) * scale).max(
            initial=0.0
        )
    )
    return (
        torch.from_numpy(quant).to(device),
        torch.from_numpy(scale.astype(np.float32).reshape(1, -1)).to(device),
        maxnorm,
    )


_BM25_TOKEN = re.compile(r"[a-z0-9]+")


class BM25Index:
    """Okapi BM25 over one text column of metadata rows (k1 = 1.2,
    b = 0.75; positive scores only, ordered by score then row).

    The build and the search run in C++ (`native/bm25.cpp`) where it
    builds, else (`native=None`, the default, after one logged warning)
    or with `native=False` here, in numpy, as the oracle; `native=True`
    requires the library and raises where it cannot be built. The two give
    the same rows and bit-identical scores: the oracle's arithmetic is
    the reference's Python loop with every float32 step spelled out (the
    length norm in float32, each term in float64 added to the float32
    score), which the C++ repeats. `text_col=None` takes the first
    string column of the first non-empty row.
    """

    K1 = 1.2
    B = 0.75

    def __init__(
        self,
        metadata: list[dict],
        *,
        text_col: str | None = None,
        native: bool | None = None,
    ) -> None:
        if text_col is None:
            sample = next((m for m in metadata if m), {})
            text_col = next(
                (k for k, v in sample.items() if isinstance(v, str)), None
            )
        self.text_col = text_col
        self._native = None
        if text_col is None:
            return
        texts = [str(m.get(text_col, "")) for m in metadata]
        from xfmr_rec_torch import native as native_lib
        from xfmr_rec_torch.native import bm25_native

        if native_lib.choose(native, bm25_native.load, "BM25"):
            self._native = bm25_native.NativeBM25(texts)
            return
        postings: dict[str, dict[int, int]] = {}
        lengths = []
        for row, text in enumerate(texts):
            tokens = _BM25_TOKEN.findall(text.lower())
            lengths.append(len(tokens) or 1)
            for tok in tokens:
                bucket = postings.setdefault(tok, {})
                bucket[row] = bucket.get(row, 0) + 1
        self._postings = {
            tok: (
                np.fromiter(bucket.keys(), np.int64, len(bucket)),
                np.fromiter(bucket.values(), np.int64, len(bucket)),
            )
            for tok, bucket in postings.items()
        }
        self._doc_lens = np.asarray(lengths, dtype=np.float32)
        self._avg_len = (
            float(self._doc_lens.mean()) if len(lengths) else 1.0
        )

    def search(
        self, query: str, *, top_k: int = 10
    ) -> list[tuple[int, float]]:
        """Top matching (row, score) pairs, positive scores only."""
        if self.text_col is None:
            return []
        if self._native is not None:
            return self._native.search(query, top_k=top_k)
        f32 = np.float32
        n_docs = len(self._doc_lens)
        scores = np.zeros(n_docs, dtype=f32)
        for tok in _BM25_TOKEN.findall(query.lower()):
            plist = self._postings.get(tok)
            if plist is None:
                continue
            rows, tfs = plist
            df = len(rows)
            idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
            denom = tfs.astype(f32) + f32(self.K1) * (
                f32(1 - self.B)
                + f32(self.B) * self._doc_lens[rows] / f32(self._avg_len)
            )
            term = idf * tfs * (self.K1 + 1) / denom.astype(np.float64)
            scores[rows] = (scores[rows].astype(np.float64) + term).astype(f32)
        order = np.argsort(-scores, kind="stable")[:top_k]
        return [(int(r), float(scores[r])) for r in order if scores[r] > 0]


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

    def search_text(
        self, query: str, *, top_k: int = 10, text_col: str | None = None
    ) -> list[dict]:
        """Keyword (BM25) search over the metadata text: the top matching
        rows, each with its id and score. The text index is built at the
        first call and dropped by a catalog mutation."""
        fts = getattr(self, "_fts", None)
        if fts is None or self._fts_col != text_col:
            fts = BM25Index(self.metadata, text_col=text_col)
            self._fts, self._fts_col = fts, text_col
        out = []
        for row, score in fts.search(query, top_k=top_k):
            entry = dict(self.metadata[row])
            entry[self.id_col] = int(self.ids[row])
            entry["score"] = score
            out.append(entry)
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
            self.corpus, self._scales, self._corpus_maxnorm = _quantize(
                embeddings, self.device
            )
            self._query_dtype = torch.bfloat16
            method = "scan"  # int8 rides the dequantizing scan kernel
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
        self.method = method
        self.scan_kernel = scan_kernel
        self.last_certified_stats: dict = {}
        self._invalidate()

    @property
    def dim(self) -> int:
        return self.corpus.shape[1]

    def dequantized(self, device: torch.device) -> torch.Tensor:
        """The (N, D) stored rows in f32 on `device` (int8 rows times
        their scales)."""
        rows = self.corpus.float()
        if self._scales is not None:
            rows = rows * self._scales[0][:, None]
        return rows.to(device)

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
        if self.method == "scan" and self.scan_kernel == "f32":
            corpus, scales, tile, true_n = self._scan_setup()
            scores, positions = scan_topk_excluding(
                queries,
                corpus,
                top_k,
                exclude_positions=exclude_positions,
                true_num_items=true_n,
                corpus_tile=tile,
                scales=scales,
            )
        elif self.method == "scan":
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
        method: str = "f32",
        exact_scores: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Guaranteed-exact batched search (no exclusions).

        Returns (scores (B, k), item_ids (B, k)); every row is provably
        the exact top-k by score multiset. `last_certified_stats` holds
        how many rows each stage left uncertified.

        method="f32": three escalating stages, each certifying per row:
        1. one lane-max sweep with discard-max certificates
           (`certified_topk_parts`);
        2. for the uncertified rows, retry sweeps with shuffled lane
           mappings (shuffles 1, 3, 5 decorrelate the collisions of the
           earlier passes); the merged candidate pool certifies when
           the minimum of dmax over the passes is at most the merged
           k-th score;
        3. the dense exact path for anything still uncertified.

        method="packed": the same escalation on the packed-key scan, in
        int32 key space. The k-set is exact in the packed order (scores
        quantized at the key quantum: items within one quantum of the
        k-th score may swap). Scores are quantum-floor decodes, or exact
        f32 with `exact_scores=True`.

        method="fused": the guarantee of "packed" with pass 1, retries
        and pool merges on the device (`packed_guaranteed_topk`), the
        dense path only for its residual.
        """
        if method not in ("f32", "packed", "fused"):
            msg = f"unknown certified search method {method!r}"
            raise ValueError(msg)
        if torch.is_tensor(queries):
            queries = queries.float().cpu().numpy()
        queries_f32 = np.asarray(queries, np.float32)
        if queries_f32.ndim == 1:
            queries_f32 = queries_f32[None, :]
        if method == "f32":
            scores, positions = self._search_certified_f32(queries_f32, top_k)
        elif method == "packed":
            scores, positions = self._search_certified_packed(
                queries_f32, top_k, exact_scores
            )
        else:
            scores, positions = self._search_certified_fused(
                queries_f32, top_k, exact_scores
            )
        return scores, self.ids[positions]

    def _padded_queries(self, queries_f32: np.ndarray, floor: int):
        """Rows zero-padded to a power of two of at least `floor`, on the
        device in the query dtype (zero queries certify trivially)."""
        rows = queries_f32.shape[0]
        width = max(floor, 1 << (rows - 1).bit_length())
        padded = np.zeros((width, self.dim), dtype=np.float32)
        padded[:rows] = queries_f32
        return torch.from_numpy(padded).to(self.device, self._query_dtype)

    def _score_bound(self, queries_f32: np.ndarray) -> torch.Tensor:
        """Sound packed score bound for these queries: max ||q|| times
        the largest (dequantized) corpus row norm, 5% over for bf16
        rounding; on the host in f64, rounded to f32, as the reference."""
        qnorm = float(np.linalg.norm(queries_f32, axis=-1).max())
        return torch.tensor(
            np.float32(max(self._corpus_maxnorm * qnorm * 1.05, 1e-6)),
            device=self.device,
        )

    def _dense_rows(
        self, queries_f32: np.ndarray, rows: np.ndarray, top_k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Dense exact (scores, positions) of the given query rows."""
        scores, positions = self._dense_exact(
            self._padded_queries(queries_f32[rows], 8), top_k
        )
        return (
            scores.cpu().numpy()[: rows.size],
            positions.cpu().numpy()[: rows.size],
        )

    def _host_escalation(self, queries_f32, top_k, sweep, certify):
        """Pass 1, lane-shuffled retries and host-side pool merges.

        `sweep(queries_dev, shuffle)` -> device (values, positions,
        dmax) with values descending per row (f32 scores or int32 keys);
        `certify(dmax, tau)` -> the row's k-th value `tau` proves it
        exact. Returns (values, positions, bad, stats): host arrays over
        the padded batch, `bad` the rows no stage certified.
        """
        true_batch = queries_f32.shape[0]
        parts = sweep(self._padded_queries(queries_f32, 8), 0)
        values, positions, best_dmax = (p.cpu().numpy() for p in parts)
        # per-row min of dmax over passes: an element above the merged
        # tau missing from the candidate union was evicted in EVERY pass
        uncertified = ~certify(best_dmax, values[:, top_k - 1])
        uncertified[true_batch:] = False
        bad = np.nonzero(uncertified)[0]
        stats = {"batch": true_batch, "pass1_bad": int(bad.size)}
        pools = {int(b): (positions[b], values[b]) for b in bad}
        for shuffle in (1, 3, 5):
            if not bad.size:
                break
            parts = sweep(self._padded_queries(queries_f32[bad], 128), shuffle)
            v, p, d = (x.cpu().numpy()[: bad.size] for x in parts)
            still_bad = []
            for row, b in enumerate(bad):
                b = int(b)
                best_dmax[b] = min(best_dmax[b], d[row])
                pool_pos = np.concatenate([pools[b][0], p[row]])
                pool_val = np.concatenate([pools[b][1], v[row]])
                # dedupe the merged pool by position, keep the best k
                _, first = np.unique(pool_pos, return_index=True)
                order = first[np.argsort(-pool_val[first], kind="stable")]
                take = order[:top_k]
                pools[b] = (pool_pos[take], pool_val[take])
                tau = pool_val[take[-1]]
                if certify(best_dmax[b], tau) and len(take) == top_k:
                    values[b] = pool_val[take]
                    positions[b] = pool_pos[take]
                else:
                    still_bad.append(b)
            bad = np.asarray(still_bad, dtype=np.int64)
        stats["retry_bad"] = int(bad.size)
        self.last_certified_stats = stats
        return values, positions, bad

    def _search_certified_f32(self, queries_f32, top_k):
        corpus, scales, tile, true_n = self._scan_setup()

        def sweep(queries_dev, shuffle):
            return certified_topk_parts(
                queries_dev,
                corpus,
                top_k,
                corpus_tile=tile,
                true_num_items=true_n,
                lane_shuffle=shuffle,
                scales=scales,
            )

        # <=: score-multiset exactness (see `certified_topk`)
        scores, positions, bad = self._host_escalation(
            queries_f32, top_k, sweep, lambda dmax, tau: dmax <= tau
        )
        if bad.size:
            scores[bad], positions[bad] = self._dense_rows(
                queries_f32, bad, top_k
            )
        true_batch = queries_f32.shape[0]
        return scores[:true_batch], positions[:true_batch]

    def _search_certified_packed(self, queries_f32, top_k, exact_scores):
        corpus, scales, tile, true_n = self._scan_setup()
        idx_bits = max((corpus.shape[0] // tile - 1).bit_length(), 1)
        # one keep-3 lane-pair merge cuts the selection width to 1.5 ct;
        # a pair fails only when it holds >= 4 of a row's top-k, expected
        # rows ~ k^4 / (24 pairs^3): gate on pairs^3 >= k^4
        merge_levels = 1 if (tile >> 1) ** 3 >= top_k**4 else 0
        bound = self._score_bound(queries_f32)

        def sweep(queries_dev, shuffle):
            return packed_certified_parts(
                queries_dev,
                corpus,
                top_k,
                score_bound=bound,
                batch_tile=512,
                corpus_tile=tile,
                idx_bits=idx_bits,
                merge_levels=merge_levels,
                merge_keep=3,
                true_num_items=true_n,
                lane_shuffle=shuffle,
                scales=scales,
            )

        # padding keys are 0 but merge stamps can raise them to
        # (1 << merge_levels) - 1; real keys are >= bitcast(1.25)
        min_real = (1 << merge_levels) - 1
        keys, positions, bad = self._host_escalation(
            queries_f32,
            top_k,
            sweep,
            lambda dmax, tau: (dmax <= tau) & (tau > min_real),
        )
        dense_scores = None
        if bad.size:
            dense_scores, positions[bad] = self._dense_rows(
                queries_f32, bad, top_k
            )
        true_batch = queries_f32.shape[0]
        if exact_scores:
            # exact-score epilogue over the whole (padded) batch, then
            # re-sort rows descending (quantum ties are key-misordered)
            exact = exact_scores_at(
                self._padded_queries(queries_f32, 8),
                self.corpus,
                torch.from_numpy(positions).to(self.device),
                scales=self._scales,
            ).cpu().numpy()
            order = np.argsort(-exact, axis=-1, kind="stable")
            scores = np.take_along_axis(exact, order, axis=-1)
            positions = np.take_along_axis(positions, order, axis=-1)
        else:
            # the (already descending) keys back to quantum-floor scores;
            # dense-fallback rows keep their exact dense scores
            scores = decode_scores(
                torch.from_numpy(keys),
                idx_bits=idx_bits,
                score_bound=bound.cpu(),
                reserve_bits=merge_levels,
            ).numpy()
            if dense_scores is not None:
                scores[bad] = dense_scores
        return scores[:true_batch], positions[:true_batch]

    def _search_certified_fused(self, queries_f32, top_k, exact_scores):
        corpus, scales, tile, true_n = self._scan_setup()
        true_batch = queries_f32.shape[0]
        scores, positions, exact = packed_guaranteed_topk(
            self._padded_queries(queries_f32, 8),
            corpus,
            top_k,
            score_bound=self._score_bound(queries_f32),
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
            scores[bad], positions[bad] = self._dense_rows(
                queries_f32, bad, top_k
            )
        return scores, positions

    # -- catalog mutation -------------------------------------------------
    def _invalidate(self) -> None:
        """Drop what was built for the old corpus: the padded scan corpus
        and its geometry, and the text index (rebuilt from the mutated
        metadata at its next use)."""
        self._scan_state = None
        self._fts = None
        self._fts_col = None

    def _check_mutated_length(self, new_len: int) -> None:
        """Refuse, at mutation time, a length that a chunked dense index
        could not search (`exact_topk` needs num_items % chunk_size == 0
        once num_items > chunk_size)."""
        if (
            self.chunk_size is not None
            and new_len > self.chunk_size
            and new_len % self.chunk_size != 0
        ):
            msg = (
                f"mutation would leave {new_len} items, not divisible by "
                f"chunk_size={self.chunk_size}; the next chunked search "
                "would fail. Batch mutations to a multiple of chunk_size "
                "or rebuild the index with chunk_size=None."
            )
            raise ValueError(msg)

    def add_items(
        self,
        embeddings: np.ndarray | torch.Tensor,
        ids: np.ndarray | list[int],
        metadata: list[dict] | None = None,
    ) -> None:
        """Append items to the index (ids must be new).

        The new rows join the corpus on the card; an int8 index quantizes
        them with their own scales, so the existing rows stay bit for
        bit. The score bound's max norm rises to cover the new rows. Not
        safe against searches running in other threads:
        `RecommenderEngine.add_items` publishes a new index instead.
        """
        ids = np.asarray(ids)
        if not torch.is_tensor(embeddings):
            embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or embeddings.shape[0] != len(ids):
            msg = "embeddings and ids must align"
            raise ValueError(msg)
        if len(ids) == 0:
            return
        if embeddings.shape[1] != self.dim:
            msg = f"dim mismatch: corpus {self.dim}, new {embeddings.shape[1]}"
            raise ValueError(msg)
        if metadata is not None and len(metadata) != len(ids):
            msg = "metadata and ids must align"
            raise ValueError(msg)
        new_ids = [int(i) for i in ids.tolist()]
        if len(set(new_ids)) != len(new_ids):
            msg = "duplicate ids within the added batch"
            raise ValueError(msg)
        clashes = [i for i in new_ids if i in self._id_to_pos]
        if clashes:
            msg = f"ids already in the index: {clashes[:8]}"
            raise ValueError(msg)
        self._check_mutated_length(len(self.ids) + len(new_ids))
        if self._scales is not None:
            quant, scales, added_maxnorm = _quantize(embeddings, self.device)
            self.corpus = torch.cat([self.corpus, quant])
            self._scales = torch.cat([self._scales, scales], dim=1)
        else:
            emb = torch.as_tensor(embeddings, dtype=torch.float32).to(
                self.device
            )
            self.corpus = torch.cat([self.corpus, emb.to(self.corpus.dtype)])
            added_maxnorm = float(torch.linalg.vector_norm(emb, dim=1).max())
        self._corpus_maxnorm = max(self._corpus_maxnorm, added_maxnorm)
        base = len(self.ids)
        self.ids = np.concatenate([self.ids, ids])
        self._ids32 = self.ids.astype(np.int32)
        self.metadata = list(self.metadata) + (
            list(metadata) if metadata is not None else [{} for _ in new_ids]
        )
        for offset, id_val in enumerate(new_ids):
            self._id_to_pos[id_val] = base + offset
        self._invalidate()

    def remove_items(self, ids: list[int] | np.ndarray) -> None:
        """Delete items by id (every id must be present).

        The corpus compacts on the card (no tombstones; positions after a
        removed row shift down). The score bound's max norm is kept as it
        was: removal cannot raise it, and keeping it keeps the packed-key
        quantum, so the surviving rows keep their keys exactly.
        """
        drop = {int(i) for i in np.asarray(ids).tolist()}
        missing = sorted(i for i in drop if i not in self._id_to_pos)
        if missing:
            msg = f"ids not in the index: {missing[:8]}"
            raise ValueError(msg)
        if not drop:
            return
        self._check_mutated_length(len(self.ids) - len(drop))
        keep = ~np.isin(self.ids, np.fromiter(drop, np.int64, len(drop)))
        rows = torch.from_numpy(np.flatnonzero(keep)).to(self.device)
        self.corpus = self.corpus.index_select(0, rows)
        if self._scales is not None:
            self._scales = self._scales.index_select(1, rows)
        self.ids = self.ids[keep]
        self._ids32 = self.ids.astype(np.int32)
        self.metadata = [
            m for m, k in zip(self.metadata, keep, strict=True) if k
        ]
        self._id_to_pos = {int(i): p for p, i in enumerate(self.ids)}
        self._invalidate()

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
