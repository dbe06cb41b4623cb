"""Exact maximum-inner-product top-k and the gap that judges an answer.

`exact_topk` scores queries against the whole corpus in float32 (TF32 off)
in blocks of rows and keeps the k best.
`answer_gap` judges a returned list: the widest amount by which a returned
item's exact score lies below the exact k-th best score of its row. A list
that holds an item twice, an item outside the corpus or fewer than k items
reads infinite.
"""

from __future__ import annotations

import math

import torch


def _scored(queries, corpus):
    return queries.float() @ corpus.float().T


def exact_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    block: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores (B, k) descending, positions (B, k))."""
    values, positions = [], []
    for start in range(0, queries.shape[0], block):
        rows = slice(start, start + block)
        top = torch.topk(_scored(queries[rows], corpus), k, dim=1)
        values.append(top.values)
        positions.append(top.indices)
    return torch.cat(values), torch.cat(positions)


def answer_gap(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    answers: torch.Tensor,
    k: int,
    *,
    block: int = 512,
) -> float:
    """The widest gap over rows of `answers` ((B, k) corpus positions, -1
    for a missing item) below the exact k-th best score."""
    worst = 0.0
    num_items = corpus.shape[0]
    if answers.shape[1] != k:
        return math.inf
    for start in range(0, queries.shape[0], block):
        rows = slice(start, start + block)
        got = answers[rows].long()
        if bool(((got < 0) | (got >= num_items)).any()):
            return math.inf
        ordered = torch.sort(got, dim=1).values
        if bool((ordered[:, 1:] == ordered[:, :-1]).any()):
            return math.inf
        scores = _scored(queries[rows], corpus)
        picked = scores.gather(1, got)
        kth = torch.topk(scores, k, dim=1).values[:, -1:]
        worst = max(worst, float((kth - picked).amax()))
    return max(worst, 0.0)
