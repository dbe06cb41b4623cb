"""Accidental-hit masking and hard / semi-hard negative mining.

Port of `xfmr_rec_tpu/ops/masking.py`. Masks are boolean tensors and the
mined selection is the same set `lax.top_k` picks: k argmax-and-knockout
passes for k <= 32 (`torch.argmax` returns the first maximum, as
`jnp.argmax` does, also on rows that are entirely -inf), a stable sort
above that. Ragged positive sets arrive 0-padded; real item indices
(`movie_rn`) start at 1, so the pad never matches a candidate.
"""

from __future__ import annotations

import torch

from xfmr_rec_torch.ops.topk import topk_stable

NEG_INF = float("-inf")

# above this the successive-argmax selection stops paying for itself and
# the sort takes over (the reference's threshold)
_ARGMAX_SELECT_MAX_K = 32


def mask_log(mask: torch.Tensor) -> torch.Tensor:
    """log of a boolean mask: 0 where True, -inf where False."""
    zero = torch.zeros((), device=mask.device)
    return torch.where(mask, zero, NEG_INF)


def negative_masks(
    logits: torch.Tensor,
    *,
    item_idx: torch.Tensor,
    pos_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """True where a candidate is a valid negative for a row: not the
    row's own item index (in-batch duplicates) and not in the row's
    0-padded positive set `pos_idx` (batch, num_positives).

    Set membership runs as a binary search of each candidate in the
    row's sorted positives: the same booleans as comparing every pair,
    without the (batch, num_items, num_positives) boolean intermediate
    (15.6 GB at batch 4096 with 465 positives a row, the widest row of a
    synthetic corpus at ML-1M's size).
    """
    batch_size = logits.shape[0]
    hits = item_idx[:batch_size, None] == item_idx[None, :]
    if pos_idx is not None:
        positives = torch.sort(pos_idx, dim=-1).values
        candidates = item_idx[None, :].expand(batch_size, -1).contiguous()
        slot = torch.searchsorted(positives, candidates)
        slot = torch.clamp(slot, max=positives.shape[1] - 1)
        hits |= positives.gather(1, slot) == candidates
    return ~hits


def _restrict_to_topk(
    masks: torch.Tensor, scores: torch.Tensor, k: int
) -> torch.Tensor:
    """Keep only the top-k scoring entries of each row of `masks`; equal
    scores resolve to the lowest index first."""
    selected = torch.zeros_like(masks)
    if k > _ARGMAX_SELECT_MAX_K:
        _, indices = topk_stable(scores, k)
        selected.scatter_(1, indices, True)
        return masks & selected
    cols = torch.arange(scores.shape[-1], device=scores.device)
    for _ in range(k):
        best = torch.argmax(scores, dim=-1)
        hit = cols[None, :] == best[:, None]
        selected |= hit
        scores = torch.where(hit, NEG_INF, scores)
    return masks & selected


def hard_mining(
    logits: torch.Tensor, masks: torch.Tensor, *, num_negatives: int
) -> torch.Tensor:
    """Keep the `num_negatives` highest-logit valid negatives per row."""
    if num_negatives <= 0 or num_negatives >= logits.shape[1]:
        return masks
    return _restrict_to_topk(masks, logits + mask_log(masks), num_negatives)


def semi_hard_mining(
    logits: torch.Tensor, masks: torch.Tensor, *, num_negatives: int
) -> torch.Tensor:
    """Prefer semi-hard negatives (below the row's positive logit, closest
    first), then hard ones (above it, closest first), never masked ones."""
    if num_negatives <= 0 or num_negatives >= logits.shape[1]:
        return masks
    diag = torch.diagonal(logits)
    logits_mod = logits - diag[:, None]
    logits_min = logits_mod.min(dim=-1, keepdim=True).values
    logits_mod = torch.where(
        logits_mod < 0, logits_mod - logits_min, -logits_mod
    )
    return _restrict_to_topk(
        masks, logits_mod + mask_log(masks), num_negatives
    )
