"""Pairwise ranking losses over in-batch and sampled negatives.

Each user row is scored against 2B candidates (the batch's positives, then
its sampled negatives) by logits = -sigma * sign(target) * ||u - i||^2 / 2.
A candidate is a valid negative for a row unless it is the row's own item
(any duplicate of it in the batch) or one of the user's positives
(`pos_idx`, 0-padded). Semi-hard mining keeps `num_negatives` of them a
row: those below the row's positive logit first, closest first, then those
above it, closest first; equal scores keep the lower column. The row's loss
is the mean of f(logit_neg - logit_pos + margin) over the kept negatives,
f = relu (hinge) or softplus (logistic, BPR), weighted by |target| and
summed over rows.
"""

from __future__ import annotations

import torch

_SCORE = {
    "PairwiseHingeLoss": torch.relu,
    "PairwiseLogisticLoss": torch.nn.functional.softplus,
}


def half_squared_distance(users: torch.Tensor, items: torch.Tensor):
    sq = 0.5 * ((users * users).sum(-1)[:, None] + (items * items).sum(-1)[None])
    return torch.clamp(sq - users @ items.T, min=0.0)


def valid_negatives(item_idx: torch.Tensor, pos_idx: torch.Tensor, rows: int):
    own = item_idx[:rows, None] == item_idx[None, :]
    positive = torch.zeros_like(own)
    for start in range(0, rows, 128):
        chunk = pos_idx[start : start + 128]
        positive[start : start + 128] = (
            item_idx[None, :, None] == chunk[:, None, :]
        ).any(-1)
    return ~(own | positive)


def semi_hard(logits: torch.Tensor, valid: torch.Tensor, count: int):
    """Boolean (rows, candidates): the kept negatives of each row."""
    if count <= 0 or count >= logits.shape[1]:
        return valid
    rel = logits - torch.diagonal(logits)[:, None]
    lowest = rel.min(dim=-1, keepdim=True).values
    pref = torch.where(rel < 0, rel - lowest, -rel)
    pref = torch.where(valid, pref, torch.full_like(pref, float("-inf")))
    order = torch.sort(pref, dim=-1, descending=True, stable=True).indices
    kept = torch.zeros_like(valid)
    kept.scatter_(1, order[:, :count], True)
    return kept & valid


def alignment(users: torch.Tensor, items: torch.Tensor, target: torch.Tensor,
              sigma: float) -> torch.Tensor:
    """DirectAU's alignment term: each row's ||u - i_pos||^2 / 2 (its
    positive is the row's own column), times its target and sigma,
    summed."""
    rows = users.shape[0]
    pos = 0.5 * ((users - items[:rows]) ** 2).sum(-1)
    return (pos * target.float() * sigma).sum()


def pairwise_loss(
    name: str,
    users: torch.Tensor,
    items: torch.Tensor,
    target: torch.Tensor,
    item_idx: torch.Tensor,
    pos_idx: torch.Tensor,
    *,
    num_negatives: int,
    sigma: float,
    margin: float,
) -> torch.Tensor:
    rows = users.shape[0]
    target = target.float()
    sign = torch.sign(target)
    logits = -half_squared_distance(users, items) * sign[:, None] * sigma
    with torch.no_grad():
        kept = semi_hard(
            logits.detach(), valid_negatives(item_idx, pos_idx, rows),
            num_negatives,
        )
    scores = logits - torch.diagonal(logits)[:, None] + margin
    weights = kept.float()
    per_row = (_SCORE[name](scores) * weights).sum(-1) / (
        weights.sum(-1) + 1e-10
    )
    return (per_row * torch.abs(target)).sum()
