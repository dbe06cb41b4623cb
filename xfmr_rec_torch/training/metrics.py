"""Vectorized retrieval metrics @ k.

Port of `xfmr_rec_tpu/training/metrics.py`: every user is scored in one
tensor computation by matching the predicted top-k id matrix against the
0-padded target id matrix (real ids are >= 1, so padding never matches).

- NDCG@k: graded gains = target ratings, linear gain, ideal DCG from the
  user's ratings sorted descending, truncated at k.
- Recall@k = hits / num_targets; Precision@k = hits / k; HitRate@k = 1
  if any hit; MRR@k = 1 / rank of the first hit (0 if none);
  MAP@k = sum_j rel_j * precision@j / min(k, num_targets).
- Means run over users with at least one target (`mean_valid`), so rows
  whose targets the caller zeroed (padding) drop out.
"""

from __future__ import annotations

import torch

METRIC_NAMES = (
    "RetrievalNormalizedDCG",
    "RetrievalRecall",
    "RetrievalPrecision",
    "RetrievalMAP",
    "RetrievalHitRate",
    "RetrievalMRR",
)


def retrieval_metrics(
    pred_ids: torch.Tensor,
    target_ids: torch.Tensor,
    target_ratings: torch.Tensor,
    *,
    top_k: int,
    prefix: str = "",
) -> dict[str, torch.Tensor]:
    """All metrics at once: `pred_ids` (users, >= top_k) ranked
    descending, `target_ids` / `target_ratings` (users, max_targets)
    0-padded. Returns scalar f32 tensors keyed `prefix + name`."""
    pred_ids = pred_ids[:, :top_k]
    k = pred_ids.shape[1]
    target_ratings = target_ratings.float()

    target_valid = target_ids > 0
    num_targets = target_valid.sum(dim=-1)
    user_valid = num_targets > 0

    match = (pred_ids[:, :, None] == target_ids[:, None, :]) & target_valid[
        :, None, :
    ]
    rel = match.any(dim=-1)
    gains = torch.where(match, target_ratings[:, None, :], 0.0).amax(dim=-1)

    positions = torch.arange(k, device=pred_ids.device, dtype=torch.float32)
    discounts = 1.0 / torch.log2(positions + 2.0)

    dcg = (gains * discounts[None, :]).sum(dim=-1)
    sorted_ratings = torch.sort(
        torch.where(target_valid, target_ratings, 0.0),
        dim=-1,
        descending=True,
    ).values
    ideal_len = min(k, target_ids.shape[1])
    idcg = (
        sorted_ratings[:, :ideal_len] * discounts[None, :ideal_len]
    ).sum(dim=-1)
    ndcg = torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-10), 0.0)

    hits = rel.sum(dim=-1)
    recall = hits / torch.clamp(num_targets, min=1)
    precision = hits / k
    hit_rate = (hits > 0).float()

    # argmax of a bool row: the first relevant rank (0 when none; guarded)
    first_rank = torch.argmax(rel.to(torch.uint8), dim=-1)
    mrr = torch.where(hits > 0, 1.0 / (first_rank + 1.0), 0.0)

    cum_rel = torch.cumsum(rel, dim=-1)
    prec_at = cum_rel / (positions[None, :] + 1.0)
    ap = (rel * prec_at).sum(dim=-1) / torch.clamp(
        torch.clamp(num_targets, max=k), min=1
    )

    count = torch.clamp(user_valid.sum(), min=1)

    def mean_valid(values: torch.Tensor) -> torch.Tensor:
        return torch.where(user_valid, values.float(), 0.0).sum() / count

    results = {
        "RetrievalNormalizedDCG": mean_valid(ndcg),
        "RetrievalRecall": mean_valid(recall),
        "RetrievalPrecision": mean_valid(precision),
        "RetrievalMAP": mean_valid(ap),
        "RetrievalHitRate": mean_valid(hit_rate),
        "RetrievalMRR": mean_valid(mrr),
    }
    return {f"{prefix}{name}": value for name, value in results.items()}
