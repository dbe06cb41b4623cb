"""IVF-partitioned MIPS for latency-bound small-batch queries.

Port of `xfmr_rec_tpu/index/ivf.py`, the counterpart of the upstream
LanceDB IVF index (nlist ~= 4 * sqrt(n), `nprobes`):

- `kmeans`: spherical Lloyd iterations over corpus tiles on the card.
  The initial rows come from the reference's numpy draw, so both
  packages start from the same rows. The centroid update is the
  reference's one-hot product in f32 (no atomics), so two builds of one
  corpus on one card give one layout.
- `assign_with_spill`: each item takes its nearest centroid with room,
  trying its top-`prefs` centroids in order; the greedy fill runs on the
  host in item order, as the reference's does.
- `IVFIndex`: a cluster-major dense layout on the card, `buckets (K,
  bucket, D)` in the serving dtype and `positions (K, bucket)` (pad =
  N), built with a stable argsort and per-cluster offsets. A probe
  gathers the `nprobe` best clusters of each query and scores their rows
  exactly, in f32 (the query is rounded to the bucket dtype first, as the
  reference's einsum does); `search_certified` adds the triangle-bound
  certificate that no unprobed cluster holds a better item.

Ties are broken as `jax.lax.top_k` breaks them, lower index first
(`ops/topk.py` `topk_stable`, a stable sort), for the probed centroids,
the candidates and the spill's preferences: `torch.topk` promises no
order among ties.

Exclusions: an excluded candidate comes back as id -1 (score -inf), like
an empty bucket slot. The reference maps only empty slots to -1, so when
the probed pool minus the exclusions holds fewer than `top_k` items it
returns the excluded ids themselves, against its own NOT-IN prefilter
(ROADMAP.md, Queue 3).

The saved files are the reference's (`ivf.npz`: the build's f32 corpus,
`ids`, `centroids`, `assign`; `ivf.json`: `nprobe` and the dtype as
"bfloat16" / "float32"), so a cache written by either package loads in
the other.
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import torch

from xfmr_rec_torch.device import resolve_device
from xfmr_rec_torch.ops.topk import topk_stable

NEG_INF = float("-inf")
# RELATIVE certificate slack: the probe scores the bucket rows against
# the query rounded to the bucket dtype (a <= 2^-9 relative change of q
# at bf16), accumulated in f32, so a computed score can sit up to about
# ||q|| * ||x|| * 2^-9 from the exact dot with the served row. The
# certificate uses CERT_SLACK * ||q|| * max_row_norm (4x margin), which
# stays sound on corpora with bias / CF columns whose rows exceed unit
# norm. Sound only if the bucket scores are never rounded below f32.
CERT_SLACK = 2.0**-7
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# f32 bytes of the (queries, nprobe, bucket, D) gather one probe chunk
# may hold
_PROBE_CHUNK_BYTES = 256 << 20
# f32 bytes of the buckets copied to the host at once for the radii
_RADII_BLOCK_BYTES = 64 << 20
# columns of the dense f32 scores `recall_probe` holds at once
_RECALL_COLUMNS = 1 << 18


def _as_f32(corpus, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(corpus).to(device, torch.float32)


def kmeans(
    corpus: np.ndarray | torch.Tensor,
    num_clusters: int,
    *,
    iters: int = 10,
    seed: int = 0,
    tile: int = 4096,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical Lloyd iterations -> (centroids (K, D) f32, assign (N,)
    int64), both on the corpus's device (or `device`).

    Assignment by the largest dot product (the first centroid among
    ties), centroids renormalized each round; an empty cluster keeps its
    centroid; all-zero rows (the reference's tile padding) are left out
    of the sums. A final assignment is made against the final centroids.
    The sums are the one-hot product of the reference, a (tile, K) f32
    block at a time, so nothing depends on the order of atomics.
    """
    if device is None:
        device = corpus.device if torch.is_tensor(corpus) else "cuda"
    dev = resolve_device(device)
    corpus_f = _as_f32(corpus, dev)
    num_items, dim = corpus_f.shape
    rng = np.random.default_rng(seed)
    init = rng.choice(num_items, size=num_clusters, replace=False)
    centroids = corpus_f[torch.from_numpy(init).to(dev)]
    valid = (corpus_f.abs().sum(dim=-1) > 0).float()

    def assign_pass(centroids):
        sums = torch.zeros((num_clusters, dim), device=dev)
        counts = torch.zeros((num_clusters,), device=dev)
        assigns = []
        for start in range(0, num_items, tile):
            ctile = corpus_f[start : start + tile]
            assign = torch.argmax(ctile @ centroids.T, dim=-1)
            onehot = torch.zeros(
                (len(ctile), num_clusters), device=dev
            ).scatter_(1, assign[:, None], valid[start : start + tile, None])
            sums += onehot.T @ ctile
            counts += onehot.sum(dim=0)
            assigns.append(assign)
        new = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp(counts[:, None], min=1.0),
            centroids,
        )
        norm = torch.linalg.vector_norm(new, dim=-1, keepdim=True)
        return new / torch.clamp(norm, min=1e-12), torch.cat(assigns)

    for _ in range(iters):
        centroids, _ = assign_pass(centroids)
    _, assign = assign_pass(centroids)
    return centroids, assign


def assign_with_spill(
    corpus: np.ndarray | torch.Tensor,
    centroids: np.ndarray | torch.Tensor,
    cap: int,
    *,
    prefs: int = 8,
    tile: int = 4096,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Capacity-capped assignment -> (N,) int32 placement.

    Each item goes to the first of its top-`prefs` centroids (by dot
    product, the lower centroid index first among ties) that still has
    room below `cap`. Round r offers every unplaced item its r-th choice;
    a cluster admits bids in item order up to its room. Items whose
    preferred clusters are all full stay with their first choice (soft
    overflow: the bucket width absorbs them). The preferences are found
    on the card, the fill on the host.
    """
    if device is None:
        device = corpus.device if torch.is_tensor(corpus) else "cuda"
    dev = resolve_device(device)
    corpus_f = _as_f32(corpus, dev)
    centroids_f = _as_f32(centroids, dev)
    num_items = corpus_f.shape[0]
    num_clusters = centroids_f.shape[0]
    prefs = min(prefs, num_clusters)
    pref_ids = np.concatenate([
        topk_stable(corpus_f[start : start + tile] @ centroids_f.T, prefs)[
            1
        ].cpu().numpy()
        for start in range(0, num_items, tile)
    ]) if num_items else np.zeros((0, prefs), np.int64)
    placement = np.full(num_items, -1, dtype=np.int32)
    counts = np.zeros(num_clusters, dtype=np.int64)
    for r in range(prefs):
        unplaced = np.flatnonzero(placement < 0)
        if unplaced.size == 0:
            break
        cand = pref_ids[unplaced, r]
        order = np.argsort(cand, kind="stable")
        sorted_c = cand[order]
        # rank of each bid within its cluster's group
        first = np.r_[True, sorted_c[1:] != sorted_c[:-1]]
        group_start = np.maximum.accumulate(
            np.where(first, np.arange(sorted_c.size), 0)
        )
        rank = np.arange(sorted_c.size) - group_start
        fits = rank < (cap - counts[sorted_c])
        rows = unplaced[order[fits]]
        placement[rows] = sorted_c[fits]
        counts += np.bincount(sorted_c[fits], minlength=num_clusters)
    leftovers = placement < 0
    if leftovers.any():
        placement[leftovers] = pref_ids[leftovers, 0]
    return placement


class IVFIndex:
    """Probe-based MIPS over a cluster-major bucket layout on the card."""

    def __init__(
        self,
        embeddings: np.ndarray,
        ids: np.ndarray,
        *,
        num_clusters: int | None = None,
        nprobe: int = 8,
        kmeans_iters: int = 10,
        spill_factor: float | None = 4.0,
        seed: int = 0,
        dtype: str = "bfloat16",
        _restore: dict | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        if dtype not in _DTYPES:
            msg = f"dtype {dtype!r} not in {tuple(_DTYPES)}"
            raise ValueError(msg)
        self.dtype = dtype
        embeddings = np.asarray(embeddings, np.float32)
        self.ids = np.asarray(ids)
        num_items, dim = embeddings.shape
        self.nprobe = nprobe
        # the build's f32 corpus: save() writes these values (the buckets
        # hold the serving dtype) and recall_probe() scores against them
        self._embeddings_f32 = embeddings
        # host seconds of each build stage (0 for a stage not run)
        self.build_seconds = {"kmeans": 0.0, "spill": 0.0, "layout": 0.0}
        emb_dev = torch.from_numpy(embeddings).to(self.device)
        if _restore is not None:
            centroids = torch.from_numpy(
                np.array(_restore["centroids"], np.float32)
            ).to(self.device)
            assign = np.asarray(_restore["assign"])
            self.num_clusters = centroids.shape[0]
        else:
            if num_clusters is None:
                # reference heuristic nlist ~= 4 * sqrt(n), floored at 4
                num_clusters = max(4, int(4 * np.sqrt(num_items)))
            num_clusters = min(num_clusters, num_items)
            self.num_clusters = num_clusters
            t0 = time.perf_counter()
            centroids, assign_dev = kmeans(
                emb_dev, num_clusters, iters=kmeans_iters, seed=seed
            )
            assign = assign_dev.cpu().numpy().astype(np.int32)
            self.build_seconds["kmeans"] = time.perf_counter() - t0
            if spill_factor is not None:
                # cap the bucket width at spill_factor x the mean cluster
                # size; the overflow spills to next-nearest centroids
                cap = max(
                    1, int(np.ceil(spill_factor * num_items / num_clusters))
                )
                counts = np.bincount(assign, minlength=num_clusters)
                if counts.max() > cap:
                    t0 = time.perf_counter()
                    assign = assign_with_spill(emb_dev, centroids, cap)
                    self.build_seconds["spill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._assign = np.asarray(assign, np.int32)
        self.centroids = centroids.float()
        self._build_layout(emb_dev)
        self.build_seconds["layout"] = time.perf_counter() - t0
        self._id_to_pos = {int(i): p for p, i in enumerate(self.ids)}

    def _build_layout(self, emb_dev: torch.Tensor) -> None:
        """Buckets, positions, radii and the largest served row norm.

        Rows go to their cluster in item order: a stable argsort of the
        assignment and each row's rank within its cluster (its index in
        the sorted order minus the cluster's offset) give the slot the
        reference's loop would give it.
        """
        num_items, dim = emb_dev.shape
        counts = np.bincount(self._assign, minlength=self.num_clusters)
        bucket = max(int(counts.max(initial=0)), 1)
        self.bucket_size = bucket
        self.fill = float(counts.sum() / (self.num_clusters * bucket))
        order = np.argsort(self._assign, kind="stable")
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        cluster = self._assign[order].astype(np.int64)
        slot = np.arange(num_items) - offsets[cluster]
        cluster_dev = torch.from_numpy(cluster).to(self.device)
        slot_dev = torch.from_numpy(slot).to(self.device)
        order_dev = torch.from_numpy(order).to(self.device)
        serving = _DTYPES[self.dtype]
        self.buckets = torch.zeros(
            (self.num_clusters, bucket, dim), dtype=serving, device=self.device
        )
        self.buckets[cluster_dev, slot_dev] = emb_dev[order_dev].to(serving)
        self.positions = torch.full(
            (self.num_clusters, bucket), num_items, dtype=torch.int64,
            device=self.device,
        )
        self.positions[cluster_dev, slot_dev] = order_dev
        self._num_items = num_items
        # covering radius of each cluster over the SERVED rows (the values
        # the probe scores): q . x <= q . mu_c + ||q|| r_c for every x in
        # cluster c. Computed on the host in the reference's numpy
        # arithmetic, so both packages hold the same radii: the expansion
        # cancels, and another summation order moves a small radius by
        # up to about 1e-3 (sqrt of a rounding error). Each value depends
        # on its own row only, so a block of clusters at a time gives the
        # same values.
        centroids = self.centroids.cpu().numpy()
        positions = self.positions.cpu().numpy()
        radii = np.zeros(self.num_clusters, np.float32)
        max_sq = np.float32(0.0)
        step = max(1, _RADII_BLOCK_BYTES // (bucket * dim * 4))
        for start in range(0, self.num_clusters, step):
            served = self.buckets[start : start + step].float().cpu().numpy()
            mu = centroids[start : start + step]
            row_sq = (served**2).sum(-1)
            diff_sq = (
                row_sq
                - 2.0 * np.einsum("kbd,kd->kb", served, mu)
                + (mu**2).sum(-1)[:, None]
            )
            valid = positions[start : start + step] < num_items
            diff_sq = np.where(valid, np.maximum(diff_sq, 0.0), 0.0)
            radii[start : start + step] = np.sqrt(diff_sq.max(axis=1))
            max_sq = max(max_sq, np.where(valid, row_sq, 0.0).max())
        self.radii = torch.from_numpy(radii).to(self.device)
        self.max_row_norm = float(np.sqrt(max_sq)) if num_items else 1.0

    def __len__(self) -> int:
        return self._num_items

    def positions_of(
        self, id_lists: list[list[int]], width: int | None = None
    ) -> np.ndarray:
        """Per-row id lists -> padded corpus positions (pad = N), width
        rounded up to a power of two (at least 8)."""
        if width is None:
            longest = max((len(x) for x in id_lists), default=1) or 1
            width = max(8, 1 << (longest - 1).bit_length())
        out = np.full((len(id_lists), width), self._num_items, np.int32)
        for row, id_list in enumerate(id_lists):
            for col, id_val in enumerate(id_list[:width]):
                out[row, col] = self._id_to_pos.get(
                    int(id_val), self._num_items
                )
        return out

    def _probe(
        self,
        queries: np.ndarray | torch.Tensor,
        top_k: int,
        nprobe: int | None,
        exclude_ids: list[list[int]] | None,
        certify: bool,
    ):
        """(scores (B, k') f32, positions (B, k'), exact (B,) or None) on
        the card, k' = min(top_k, nprobe * bucket). Excluded candidates
        and empty slots carry position N and score -inf."""
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        nprobe = min(
            nprobe if nprobe is not None else self.nprobe, self.num_clusters
        )
        excl = None
        if exclude_ids is not None:
            excl = torch.from_numpy(self.positions_of(exclude_ids)).to(
                self.device, torch.int64
            )
        n = self._num_items
        batch, dim = q.shape
        cand_count = nprobe * self.bucket_size
        k_eff = min(top_k, cand_count)
        cluster_scores = q @ self.centroids.T
        _, probe_ids = topk_stable(cluster_scores, nprobe)
        # the reference's einsum takes q in the bucket dtype and
        # accumulates in f32: round q, then score in f32
        q_served = q.to(self.buckets.dtype).float()
        chunk = max(1, _PROBE_CHUNK_BYTES // (cand_count * dim * 4))
        top_scores, top_pos = [], []
        for start in range(0, batch, chunk):
            ids_c = probe_ids[start : start + chunk]
            cand = self.buckets[ids_c].float()  # (b, P, bucket, D)
            cand_pos = self.positions[ids_c].reshape(len(ids_c), -1)
            scores = torch.einsum(
                "bd,bpcd->bpc", q_served[start : start + chunk], cand
            ).reshape(len(ids_c), -1)
            if excl is not None:
                hit = (
                    cand_pos[:, :, None] == excl[start : start + chunk, None]
                ).any(dim=-1)
                cand_pos = torch.where(hit, n, cand_pos)
            scores = torch.where(cand_pos < n, scores, NEG_INF)
            vals, arg = topk_stable(scores, k_eff)
            top_scores.append(vals)
            top_pos.append(torch.gather(cand_pos, 1, arg))
        top_scores = torch.cat(top_scores)
        top_pos = torch.cat(top_pos)
        if not certify:
            return top_scores, top_pos, None
        q_norm = torch.linalg.vector_norm(q, dim=-1)
        upper = cluster_scores + q_norm[:, None] * self.radii[None, :]
        upper = upper.scatter(1, probe_ids, NEG_INF)
        unprobed_max = upper.amax(dim=-1)
        slack = CERT_SLACK * q_norm * max(self.max_row_norm, 1e-12)
        exact = top_scores[:, k_eff - 1] >= unprobed_max + slack
        if k_eff < top_k:
            # fewer candidates than asked for: the certificate cannot
            # prove a top-k it did not materialize
            exact = torch.zeros_like(exact)
        return top_scores, top_pos, exact

    def _item_ids(self, positions: torch.Tensor) -> np.ndarray:
        positions = positions.cpu().numpy()
        valid = positions < self._num_items
        return np.where(
            valid, self.ids[np.clip(positions, 0, self._num_items - 1)], -1
        )

    def search(
        self,
        queries: np.ndarray | torch.Tensor,
        *,
        top_k: int,
        nprobe: int | None = None,
        exclude_ids: list[list[int]] | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Probe search -> (scores (B, k) f32, item_ids (B, k)).

        Exact within the probed clusters; recall against exhaustive
        search rises with `nprobe` (default 8, the upstream default).
        `exclude_ids` is the NOT-IN prefilter: an excluded item never
        comes back; a slot with no item left is id -1, score -inf.
        """
        scores, positions, _ = self._probe(
            queries, top_k, nprobe, exclude_ids, certify=False
        )
        return scores.cpu().numpy(), self._item_ids(positions)

    def search_certified(
        self,
        queries: np.ndarray | torch.Tensor,
        *,
        top_k: int,
        nprobe: int | None = None,
        exclude_ids: list[list[int]] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Probe search with a per-row exactness certificate -> (scores,
        item_ids, exact).

        `exact[b]` is True when the triangle bound proves no unprobed
        cluster holds an item above row b's k-th found score: for every
        item x of cluster c, q . x <= q . mu_c + ||q|| r_c over the
        covering radius of the served rows, so

            kth_found >= max over unprobed c of (q . mu_c + ||q|| r_c)
                         + CERT_SLACK * ||q|| * max_row_norm

        means the probed top-k is the exhaustive top-k over the served
        corpus at the declared quantum (the slack covers the rounding of
        q to the bucket dtype). With fewer candidates than `top_k` the
        row is never exact. Exclusions only lower what an unprobed
        cluster could give, so they keep the certificate sound. Callers
        answer uncertified rows exhaustively (the engine's
        `ivf_certified` mode).
        """
        scores, positions, exact = self._probe(
            queries, top_k, nprobe, exclude_ids, certify=True
        )
        return (
            scores.cpu().numpy(),
            self._item_ids(positions),
            exact.cpu().numpy(),
        )

    def recall_probe(
        self,
        *,
        top_k: int = 10,
        nprobe: int | None = None,
        num_queries: int = 256,
        seed: int = 0,
    ) -> float:
        """Recall@k of the probe against exhaustive search on perturbed
        corpus rows (the reference's sampling, noise and normalization,
        in numpy from `seed`).

        The exact top-k comes from the f32 scores over the build corpus
        on the card, `_RECALL_COLUMNS` columns at a time with a running
        top-k. The recall is a set intersection, so it can differ from
        the reference's (`np.argpartition` on the host) only where items
        tie exactly at the k-th score.
        """
        rng = np.random.default_rng(seed)
        n = self._num_items
        num_queries = min(num_queries, n)
        take = rng.choice(n, num_queries, replace=False)
        queries = self._embeddings_f32[take]
        noise = rng.normal(scale=0.1, size=queries.shape).astype(np.float32)
        queries = queries + noise * np.linalg.norm(
            queries, axis=-1, keepdims=True
        )
        queries /= np.maximum(
            np.linalg.norm(queries, axis=-1, keepdims=True), 1e-12
        )
        k = min(top_k, n)
        q = torch.from_numpy(queries).to(self.device)
        best_vals = torch.full((num_queries, 0), NEG_INF, device=self.device)
        best_pos = torch.zeros(
            (num_queries, 0), dtype=torch.int64, device=self.device
        )
        for start in range(0, n, _RECALL_COLUMNS):
            block = torch.from_numpy(
                self._embeddings_f32[start : start + _RECALL_COLUMNS]
            ).to(self.device)
            vals, pos = torch.topk(q @ block.T, min(k, len(block)), dim=-1)
            vals = torch.cat([best_vals, vals], dim=1)
            pos = torch.cat([best_pos, pos + start], dim=1)
            best_vals, arg = torch.topk(vals, min(k, vals.shape[1]), dim=-1)
            best_pos = torch.gather(pos, 1, arg)
        exact_ids = self.ids[best_pos.cpu().numpy()]
        _, got_ids = self.search(queries, top_k=k, nprobe=nprobe)
        hits = sum(
            len(np.intersect1d(got_ids[i], exact_ids[i]))
            for i in range(num_queries)
        )
        return hits / (num_queries * k)

    # -- persistence ------------------------------------------------------
    def save(self, path: str | pathlib.Path) -> None:
        """`ivf.npz` (the build's f32 corpus, not the served rows) and
        `ivf.json`, as the reference writes them."""
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez(
            path / "ivf.npz",
            embeddings=self._embeddings_f32,
            ids=self.ids,
            centroids=self.centroids.cpu().numpy(),
            assign=self._assign,
        )
        meta = {"nprobe": self.nprobe, "dtype": self.dtype}
        (path / "ivf.json").write_text(json.dumps(meta))

    @classmethod
    def load(
        cls, path: str | pathlib.Path, *, device: str | torch.device = "cuda"
    ) -> IVFIndex:
        path = pathlib.Path(path)
        meta = json.loads((path / "ivf.json").read_text())
        with np.load(path / "ivf.npz", allow_pickle=False) as arrays:
            embeddings, ids = arrays["embeddings"], arrays["ids"]
            restore = {
                "centroids": arrays["centroids"],
                "assign": arrays["assign"],
            }
        return cls(
            embeddings,
            ids,
            nprobe=meta["nprobe"],
            dtype=meta["dtype"],
            _restore=restore,
            device=device,
        )
