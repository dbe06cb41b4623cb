"""Mesh-sharded retrieval index: one logical index over many devices.

Port of `xfmr_rec_tpu/index/sharded.py`. `ShardedRetrievalIndex` has
the host surface of `RetrievalIndex` (search / search_certified /
get_id / positions_of / search_text / save / load) but keeps the item
corpus split along items over the mesh's "model" axis: each device holds
N/m rows, sweeps them with the packed-key kernels, and the per-shard
candidates merge in key space on the lead device
(`parallel/retrieval.py`).

The class adds the corpus placement (bf16, f32, or int8 with per-item
scales), the shard-balancing zero rows (`true_num_items` masks them),
batch padding for the data axis, and the id and metadata surface. The
on-disk layout is `RetrievalIndex`'s, so an index saved by either kind,
in either package, loads in the other.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from xfmr_rec_torch.index.mips import CorpusMetadata, _quantize
from xfmr_rec_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, create_mesh
from xfmr_rec_torch.parallel.retrieval import (
    ShardedTensor,
    sharded_packed_certified_topk,
    sharded_packed_guaranteed_topk,
    sharded_packed_topk_excluding,
    sharded_topk,
)

NEG_INF = float("-inf")


class ShardedRetrievalIndex(CorpusMetadata):
    """Item corpus split over the mesh's model axis, exact search.

    Args:
        embeddings: (N, D) float array or tensor.
        ids: (N,) item ids aligned with rows.
        metadata: optional per-row dicts (drives get_id / search_text).
        mesh: the device mesh; default a model-parallel mesh over every
            visible card (`create_mesh(model_parallel=m)`). On a 2-D mesh
            (data d x model m) queries split over the data axis too:
            each device's work is (B/d, N/m), batches pad to a multiple
            of d.
        dtype: corpus storage: "bfloat16", "float32", or "int8" (per-item
            symmetric quantization, the single-card index's scheme:
            search is exact over the quantized corpus).
    """

    def __init__(
        self,
        embeddings: np.ndarray | torch.Tensor,
        ids: np.ndarray,
        metadata: list[dict] | None = None,
        *,
        mesh: Mesh | None = None,
        model_parallel: int | None = None,
        id_col: str = "id",
        dtype: str = "bfloat16",
    ) -> None:
        if embeddings.shape[0] != len(ids):
            msg = "embeddings and ids must align"
            raise ValueError(msg)
        if dtype not in ("bfloat16", "float32", "int8"):
            msg = f"unsupported sharded corpus dtype {dtype!r}"
            raise ValueError(msg)
        if mesh is None:
            mesh = create_mesh(
                model_parallel=model_parallel or torch.cuda.device_count() or 1
            )
        self.mesh = mesh
        self.num_shards = mesh.shape[MODEL_AXIS]
        self._data_size = mesh.shape[DATA_AXIS]
        self.id_col = id_col
        self.ids = np.asarray(ids)
        self.metadata = metadata or [{} for _ in self.ids]
        self._id_to_pos = {int(i): p for p, i in enumerate(self.ids)}
        self.dtype = dtype
        self.last_certified_stats: dict = {}

        emb = np.asarray(
            embeddings.detach().float().cpu()
            if torch.is_tensor(embeddings)
            else embeddings,
            dtype=np.float32,
        )
        self._true_n = emb.shape[0]
        # shard-balancing zero rows (the sharded paths need N % m == 0),
        # masked by true_num_items
        pad = -self._true_n % self.num_shards
        if pad:
            emb = np.pad(emb, ((0, pad), (0, 0)))
        self._true_num_items = self._true_n if pad else None
        lead = mesh.lead
        if dtype == "int8":
            quant, scales, self._corpus_maxnorm = _quantize(emb, lead)
            self.corpus = ShardedTensor(quant, mesh, axis=0)
            self.scales = ShardedTensor(scales, mesh, axis=1)
            self._query_dtype = torch.bfloat16
        else:
            full = torch.from_numpy(emb).to(lead, getattr(torch, dtype))
            self.corpus = ShardedTensor(full, mesh, axis=0)
            self.scales = None
            self._query_dtype = full.dtype
            self._corpus_maxnorm = float(
                np.linalg.norm(emb, axis=1).max(initial=0.0)
            )

    @property
    def dim(self) -> int:
        return self.corpus.shape[1]

    def dequantized(self, device: torch.device) -> torch.Tensor:
        """The (N, D) stored rows in f32 on `device` (int8 rows times
        their scales), without the shard-balancing rows."""
        rows = self.corpus.full(device).float()
        if self.scales is not None:
            rows = rows * self.scales.full(device)[0][:, None]
        return rows[: self._true_n]

    def _ids_at(self, scores: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """Global positions -> item ids; pad positions and -inf entries
        (exhausted exclusion pools) become -1, the engine's no-candidate
        sentinel."""
        safe = np.clip(positions, 0, self._true_n - 1)
        item_ids = self.ids[safe].astype(np.int64)
        invalid = (positions >= self._true_n) | ~np.isfinite(scores)
        return np.where(invalid, -1, item_ids)

    def _pad_batch(
        self, queries: torch.Tensor, exclude_positions: torch.Tensor | None = None
    ) -> tuple[torch.Tensor, torch.Tensor | None, int]:
        """Pad the batch so every data shard tiles the scan: a multiple
        of 8*d, and of 128*d once the per-device rows exceed the default
        batch tile (zero-query pad rows certify trivially and are cut
        off by the caller)."""
        batch = queries.shape[0]
        d = self._data_size
        unit = 8 * d
        padded = -(-max(batch, 8) // unit) * unit
        if padded // d > 128 and (padded // d) % 128:
            unit = 128 * d
            padded = -(-padded // unit) * unit
        pad = padded - batch
        if pad:
            queries = torch.nn.functional.pad(queries, (0, 0, 0, pad))
            if exclude_positions is not None:
                exclude_positions = torch.nn.functional.pad(
                    exclude_positions, (0, 0, 0, pad), value=self._true_n
                )
        return queries, exclude_positions, batch

    def _score_bound(self, queries: torch.Tensor) -> torch.Tensor:
        """Sound packed score bound, on the device (no host sync)."""
        qnorm = torch.linalg.vector_norm(queries.float(), dim=-1).max()
        return torch.clamp(self._corpus_maxnorm * qnorm * 1.05, min=1e-6).float()

    def _queries(self, queries) -> torch.Tensor:
        queries = torch.as_tensor(queries).to(self.mesh.lead, self._query_dtype)
        return queries[None, :] if queries.dim() == 1 else queries

    def search(
        self,
        queries: np.ndarray | torch.Tensor,
        *,
        top_k: int,
        exclude_ids: list[list[int]] | None = None,
        exclude_positions: np.ndarray | torch.Tensor | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched search. Returns (scores (B, k), item_ids (B, k))."""
        queries = self._queries(queries)
        if exclude_positions is None:
            if exclude_ids is not None:
                exclude_positions = self.positions_of(exclude_ids)
            else:
                exclude_positions = np.full(
                    (queries.shape[0], 1), self._true_n, dtype=np.int32
                )
        exclude_positions = torch.as_tensor(exclude_positions).to(
            self.mesh.lead, torch.int32
        )
        queries, exclude_positions, batch = self._pad_batch(
            queries, exclude_positions
        )
        scores, positions = sharded_packed_topk_excluding(
            queries,
            self.corpus,
            top_k,
            self.mesh,
            exclude_positions=exclude_positions,
            score_bound=self._score_bound(queries),
            true_num_items=self._true_num_items,
            scales=self.scales,
        )
        scores = scores.cpu().numpy()[:batch]
        positions = positions.cpu().numpy()[:batch]
        return scores, self._ids_at(scores, positions)

    def search_certified(
        self,
        queries: np.ndarray | torch.Tensor,
        *,
        top_k: int,
        method: str = "fused",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Guaranteed-exact batched search across the mesh (no exclusions).

        method="fused": the keep-3 certified sweep a shard, the key-space
        merge and the lane-shuffled retries with the composed certificate
        (`sharded_packed_guaranteed_topk`); only its residual runs on the
        dense sharded path. method="packed": pass 1 only, and the dense
        path for every uncertified row. Exact at the key quantum, as on
        one card. `last_certified_stats` counts the rows left to the
        dense path.
        """
        if method not in ("fused", "packed"):
            msg = f"unknown certified search method {method!r}"
            raise ValueError(msg)
        queries, _, batch = self._pad_batch(self._queries(queries))
        fn = (
            sharded_packed_guaranteed_topk
            if method == "fused"
            else sharded_packed_certified_topk
        )
        scores, positions, exact = fn(
            queries,
            self.corpus,
            top_k,
            self.mesh,
            score_bound=self._score_bound(queries),
            true_num_items=self._true_num_items,
            scales=self.scales,
        )
        scores = scores.cpu().numpy()[:batch]
        positions = positions.cpu().numpy()[:batch]
        exact = exact.cpu().numpy()[:batch]
        bad = np.nonzero(~exact)[0]
        self.last_certified_stats = {"batch": batch, "pass1_bad": int(bad.size)}
        if bad.size:
            # dense residual, padded to a power of two (and the data axis)
            width = max(self._data_size, 1 << (int(bad.size) - 1).bit_length())
            width += -width % self._data_size
            retry = torch.zeros((width, self.dim), device=self.mesh.lead)
            retry[: bad.size] = queries[torch.from_numpy(bad).to(self.mesh.lead)].float()
            s, p = sharded_topk(
                retry.to(self._query_dtype),
                self.corpus,
                top_k,
                self.mesh,
                true_num_items=self._true_num_items,
                scales=self.scales,
            )
            scores[bad] = s.cpu().numpy()[: bad.size]
            positions[bad] = p.cpu().numpy()[: bad.size]
        return scores, self._ids_at(scores, positions)

    # -- persistence (RetrievalIndex's layout) ---------------------------
    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        # dequantized: re-quantizing these exact values gives the same
        # int8 rows (round is idempotent on the grid)
        embeddings = self.dequantized(torch.device("cpu")).numpy()
        np.savez(path / "corpus.npz", embeddings=embeddings, ids=self.ids)
        meta = {
            "id_col": self.id_col,
            "dtype": self.dtype,
            "chunk_size": None,
            "method": "scan",
            "scan_kernel": "packed",
            "kind": "sharded",
            "metadata": self.metadata,
        }
        (path / "index.json").write_text(json.dumps(meta))

    @classmethod
    def load(
        cls,
        path: str | pathlib.Path,
        *,
        mesh: Mesh | None = None,
        model_parallel: int | None = None,
    ) -> ShardedRetrievalIndex:
        """Load any `RetrievalIndex`-layout artifact onto the mesh (both
        kinds of index, in both packages, share one layout)."""
        path = pathlib.Path(path)
        with np.load(path / "corpus.npz", allow_pickle=False) as arrays:
            embeddings, ids = arrays["embeddings"], arrays["ids"]
        meta = json.loads((path / "index.json").read_text())
        dtype = meta.get("dtype", "bfloat16")
        if dtype not in ("bfloat16", "float32", "int8"):
            dtype = "bfloat16"
        return cls(
            embeddings,
            ids,
            metadata=meta["metadata"],
            mesh=mesh,
            model_parallel=model_parallel,
            id_col=meta["id_col"],
            dtype=dtype,
        )
