"""Embedding similarity primitives.

Port of `xfmr_rec_tpu/ops/similarity.py`: similarity is half the squared
euclidean distance, computed through one matmul plus rank-1 norm
corrections, and reductions over mined negatives use a sample-weighted
mean with a 1e-10 denominator guard. The matmul runs in f32 (the loss
path is the numerical-parity surface); callers keep TF32 off on the card.
"""

from __future__ import annotations

import torch


def squared_distance(
    query_embed: torch.Tensor, candidate_embed: torch.Tensor
) -> torch.Tensor:
    """(num_queries, num_candidates) matrix of ||q - c||^2 / 2, clamped at
    0 (the quadratic-form expansion can go slightly negative)."""
    q = query_embed.float()
    c = candidate_embed.float()
    q_sq = (q * q).sum(dim=-1)
    c_sq = (c * c).sum(dim=-1)
    dist = 0.5 * (q_sq[:, None] + c_sq[None, :]) - q @ c.T
    return torch.clamp(dist, min=0.0)


def weighted_mean(
    values: torch.Tensor,
    sample_weights: torch.Tensor,
    *,
    dim: int | None = None,
    keepdim: bool = False,
) -> torch.Tensor:
    """Weighted mean; the denominator is the weight sum + 1e-10, so
    all-zero weights give ~0 instead of NaN."""
    weights = sample_weights.to(values.dtype)
    if dim is None:
        return (values * weights / (weights.sum() + 1e-10)).sum()
    denominator = weights.sum(dim=dim, keepdim=True) + 1e-10
    return (values * weights / denominator).sum(dim=dim, keepdim=keepdim)
