"""Factorized item-CF channel: co-occurrence factors that ride the index.

Own copy of `xfmr_rec_tpu/models/cf.py` (numpy + scipy): rank-r factors
of the degree-normalized train co-occurrence

    cos[i, j] = co[i, j] / (sqrt(pop_i) * sqrt(pop_j)),  cos[i, i] = 0

by randomized subspace iteration on the sparse user-item incidence
(cos = B^T B - D), never materializing an n_items x n_items matrix. The
factors ride the retrieval index as extra columns:

    query  q = [e_u, w_cf * cf_u / ||cf_u||, w_pop]
    item   c = [e_i, item_factors_i,         pop_i ]
    score  = learned_dot + w_cf * cf_dot + w_pop * pop_i

so every search path, exclusion included, works unchanged. For a seed
the factors are the reference's, bit for bit (the same numpy and scipy
calls in the same order); `cf.npz` is read and written by both packages.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

__all__ = ["CFChannel", "factorize_item_cf"]


@dataclasses.dataclass
class CFChannel:
    """Rank-r factorization of the normalized item co-occurrence.

    - `item_factors` (n_items, rank): index-side columns, appended to the
      corpus embedding matrix.
    - `hist_factors` (n_items, rank): query-side columns — the same
      eigenvectors with eigenvalue signs folded in, so that
      hist_factors[h] . item_factors[i] ~= cos[h, i].
    - `pop_prior` (n_items,): max-normalized train popularity (the
      probe's additive prior), appended as one more index column paired
      with a constant w_pop on the query side.
    """

    item_factors: np.ndarray
    hist_factors: np.ndarray
    pop_prior: np.ndarray

    @property
    def rank(self) -> int:
        return int(self.item_factors.shape[1])

    @property
    def num_items(self) -> int:
        return int(self.item_factors.shape[0])

    def user_vectors(
        self,
        positions: np.ndarray,
        mask: np.ndarray | None = None,
        *,
        normalize: bool = True,
    ) -> np.ndarray:
        """Batched user CF vectors from (B, H) history item positions.

        Padded slots are masked out; rows with empty histories (or only
        pads) return zero vectors — the CF channel contributes nothing
        for cold users, by construction.
        """
        positions = np.asarray(positions)
        squeeze = positions.ndim == 1
        if squeeze:
            positions = positions[None]
        if mask is None:
            mask = (positions >= 0) & (positions < self.num_items)
        safe = np.where(mask, np.clip(positions, 0, self.num_items - 1), 0)
        vecs = (self.hist_factors[safe] * mask[..., None]).sum(axis=1)
        if normalize:
            norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
            vecs = np.where(norms > 0, vecs / np.maximum(norms, 1e-12), vecs)
        return vecs[0] if squeeze else vecs

    # ------------------------------------------------------------------
    def grown(self, extra_items: int) -> CFChannel:
        """Factors for a corpus grown by `extra_items` cold rows.

        New catalog items have no train interactions: zero factors and
        zero popularity — the learned channel alone ranks them (matches
        the mutable-catalog contract in serving/engine.add_items)."""
        if extra_items <= 0:
            return self
        zf = np.zeros((extra_items, self.rank), self.item_factors.dtype)
        return CFChannel(
            item_factors=np.concatenate([self.item_factors, zf]),
            hist_factors=np.concatenate([self.hist_factors, zf]),
            pop_prior=np.concatenate(
                [self.pop_prior, np.zeros(extra_items, self.pop_prior.dtype)]
            ),
        )

    def take(self, keep: np.ndarray) -> CFChannel:
        """Factors for a corpus filtered to `keep` positions (removals)."""
        return CFChannel(
            item_factors=self.item_factors[keep],
            hist_factors=self.hist_factors[keep],
            pop_prior=self.pop_prior[keep],
        )

    # ------------------------------------------------------------------
    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            item_factors=self.item_factors,
            hist_factors=self.hist_factors,
            pop_prior=self.pop_prior,
        )

    @classmethod
    def load(cls, path: str | pathlib.Path) -> CFChannel:
        with np.load(path) as data:
            return cls(
                item_factors=data["item_factors"],
                hist_factors=data["hist_factors"],
                pop_prior=data["pop_prior"],
            )


def factorize_item_cf(
    train_items_by_user: dict[int, list[int]],
    n_items: int,
    rank: int = 128,
    *,
    oversample: int = 16,
    iters: int = 6,
    seed: int = 0,
) -> CFChannel:
    """Randomized rank-r eigendecomposition of the normalized co-occurrence.

    Never materializes the n_items x n_items matrix: every product with
    cos = B^T B - D is two sparse incidence products, O(nnz * (rank +
    oversample)) per iteration. Subspace iteration + Rayleigh-Ritz gives
    the dominant-|lambda| eigenpairs; with `iters` power steps the top
    eigenpairs (the CF signal — measured spectrum decays fast) are
    converged to probe-equivalent quality.

    Deterministic for a fixed seed.
    """
    rank = min(rank, n_items)
    import scipy.sparse as sp

    rows, cols = [], []
    pop = np.zeros(n_items, np.float64)
    for user, items in train_items_by_user.items():
        rows.extend([user] * len(items))
        cols.extend(items)
        for it in items:
            pop[it] += 1
    pop_prior = (pop / pop.max() if pop.max() > 0 else pop).astype(np.float32)
    inv_sqrt = np.zeros(n_items, np.float64)
    nz = pop > 0
    inv_sqrt[nz] = 1.0 / np.sqrt(pop[nz])
    n_users = (max(train_items_by_user) + 1) if train_items_by_user else 1
    vals = inv_sqrt[np.asarray(cols, dtype=np.int64)] if cols else []
    b_mat = sp.csr_matrix(
        (vals, (rows, cols)), shape=(n_users, n_items), dtype=np.float64
    )
    diag = nz.astype(np.float64)

    def cos_matmul(q: np.ndarray) -> np.ndarray:
        return b_mat.T @ (b_mat @ q) - diag[:, None] * q

    rng = np.random.default_rng(seed)
    k = min(rank + oversample, n_items)
    q = rng.standard_normal((n_items, k))
    for _ in range(iters):
        q, _ = np.linalg.qr(cos_matmul(q))
    t_small = q.T @ cos_matmul(q)
    t_small = (t_small + t_small.T) / 2
    lam, u_small = np.linalg.eigh(t_small)
    order = np.argsort(-np.abs(lam))[:rank]
    lam, u_small = lam[order], u_small[:, order]
    vecs = q @ u_small
    item_f = (vecs * np.sqrt(np.abs(lam))).astype(np.float32)
    hist_f = (item_f * np.sign(lam)).astype(np.float32)
    return CFChannel(
        item_factors=item_f, hist_factors=hist_f, pop_prior=pop_prior
    )
