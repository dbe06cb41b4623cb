"""Contrastive / pairwise embedding loss family.

Port of `xfmr_rec_tpu/ops/losses.py`: the nine losses of `LOSSES`, under
the reference's names, as functions over a frozen `LossConfig`, with the
LogQ sampled-softmax correction (`log_q`, per-candidate sampling
log-probability, subtracted from the softmax losses' logits).

Conventions shared by all losses:
- logits = -squared_distance(user, item) * sign(target) * sigma;
- rows are weighted by |target|; sign(target) flips the objective for
  negative-feedback rows;
- `item_embed` holds 2 * batch rows: in-batch positives first, then the
  sampled corpus negatives;
- mined masks (accidental hits removed, then semi-hard mining) carry no
  gradient.

`compute_losses` computes every loss of a step from one `_Terms`, so the
(B, 2B) distance matrix, the logits, the mined masks and the uniformity
terms are computed once and shared, as XLA shares them in one jit region.
Rows with no valid negative contribute 0 with finite gradients.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from xfmr_rec_torch.ops.masking import (
    mask_log,
    negative_masks,
    semi_hard_mining,
)
from xfmr_rec_torch.ops.similarity import squared_distance, weighted_mean


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss hyperparameters."""

    num_negatives: int = 0
    sigma: float = 1.0
    margin: float = 1.0
    # DirectAU uniformity weight (not margin: HPO samples margin in [-1, 1])
    gamma: float = 1.0
    # MAWU user-side uniformity weight; None = gamma for both sides
    gamma_user: float | None = None
    use_logq_correction: bool = False


class _Terms:
    """One step's inputs and the intermediate terms the losses share,
    each computed on first use."""

    def __init__(
        self,
        user_embed: torch.Tensor,
        item_embed: torch.Tensor,
        target: torch.Tensor,
        item_idx: torch.Tensor,
        pos_idx: torch.Tensor | None,
        config: LossConfig,
        log_q: torch.Tensor | None,
    ) -> None:
        self.user = user_embed
        self.item = item_embed
        self.target = target.float()
        self.item_idx = item_idx
        self.pos_idx = pos_idx
        self.config = config
        self.log_q = log_q
        self.batch = user_embed.shape[0]

    @functools.cached_property
    def sign(self) -> torch.Tensor:
        return torch.sign(self.target)

    @functools.cached_property
    def weight(self) -> torch.Tensor:
        return torch.abs(self.target)

    @functools.cached_property
    def dist(self) -> torch.Tensor:
        return squared_distance(self.user, self.item)

    @functools.cached_property
    def pos_dist(self) -> torch.Tensor:
        """Distance of each user to its own positive (the diagonal)."""
        return torch.diagonal(self.dist)

    @functools.cached_property
    def logits(self) -> torch.Tensor:
        return -self.dist * self.sign[:, None] * self.config.sigma

    @functools.cached_property
    def masks(self) -> torch.Tensor:
        logits = self.logits.detach()  # cache `logits` with its graph
        with torch.no_grad():
            masks = negative_masks(
                logits, item_idx=self.item_idx, pos_idx=self.pos_idx
            )
            return semi_hard_mining(
                logits, masks, num_negatives=self.config.num_negatives
            )

    @functools.cached_property
    def corrected(self) -> torch.Tensor:
        """Logits with the LogQ correction, where it is on."""
        if self.config.use_logq_correction and self.log_q is not None:
            return self.logits - self.log_q[None, :].float()
        return self.logits

    @functools.cached_property
    def positive_weight(self) -> torch.Tensor:
        """Row weights of the DirectAU / MAWU alignment: positive targets."""
        return torch.clamp(self.target, min=0.0)

    @functools.cached_property
    def uniformity_user(self) -> torch.Tensor:
        return _uniformity(self.user)

    @functools.cached_property
    def uniformity_item(self) -> torch.Tensor:
        return _uniformity(self.item[: self.batch])


def _uniformity(embed: torch.Tensor) -> torch.Tensor:
    """log E[exp(-2||x - x'||^2)] over distinct in-batch pairs (Wang &
    Isola); squared_distance is ||.||^2 / 2, so the exponent is -4 d."""
    n = embed.shape[0]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=embed.device)
    logits = -4.0 * squared_distance(embed, embed) + mask_log(off_diag)
    return torch.logsumexp(logits.reshape(-1), dim=0) - math.log(n * (n - 1))


def _alignment(t: _Terms) -> torch.Tensor:
    """Pull each user towards its positive item (DirectAU alignment)."""
    return (t.pos_dist * t.target * t.config.sigma).sum()


def _contrastive(t: _Terms) -> torch.Tensor:
    """Margin hinge over mined negatives (~ CCL)."""
    losses = torch.relu(t.logits + t.sign[:, None] * t.config.margin)
    return (weighted_mean(losses, t.masks, dim=-1) * t.weight).sum()


def _infonce(t: _Terms) -> torch.Tensor:
    """Masked sampled-softmax cross-entropy, positive on the diagonal."""
    batch, num_items = t.logits.shape
    eye = torch.eye(batch, num_items, dtype=torch.bool, device=t.masks.device)
    masked = t.corrected + mask_log(t.masks | eye)
    loss = -torch.diagonal(masked) + torch.logsumexp(masked, dim=-1)
    return (loss * t.weight).sum()


def _mine(t: _Terms) -> torch.Tensor:
    """MINE bound: -pos + logsumexp(neg). A row with no valid negative
    contributes 0; its logsumexp reads a dummy first column so that it
    stays finite and backpropagates no NaN."""
    has_neg = t.masks.any(dim=-1)
    first_col = torch.zeros_like(t.masks)
    first_col[:, 0] = True
    safe = t.masks | (~has_neg[:, None] & first_col)
    negative_score = torch.logsumexp(t.corrected + mask_log(safe), dim=-1)
    loss = (-torch.diagonal(t.logits) + negative_score) * has_neg
    return (loss * t.weight).sum()


def _pairwise(t: _Terms, score_loss_fn) -> torch.Tensor:
    scores = t.logits - torch.diagonal(t.logits)[:, None] + t.config.margin
    loss = weighted_mean(score_loss_fn(scores), t.masks, dim=-1)
    return (loss * t.weight).sum()


def _pairwise_hinge(t: _Terms) -> torch.Tensor:
    """Hinge on (neg - pos + margin). The reference's train loss."""
    return _pairwise(t, torch.relu)


def _pairwise_logistic(t: _Terms) -> torch.Tensor:
    """BPR: softplus(neg - pos + margin), as logaddexp(x, 0)."""
    return _pairwise(t, lambda x: torch.logaddexp(x, torch.zeros_like(x)))


def _alignment_contrastive(t: _Terms) -> torch.Tensor:
    return _alignment(t) + _contrastive(t)


def _direct_au(t: _Terms) -> torch.Tensor:
    """DirectAU (Wang et al., SIGIR'22): the rating-weighted mean of
    ||u - i||^2 over positive-target rows + gamma * the mean of the user
    and item uniformities (see the reference's docstring for the scale)."""
    align = weighted_mean(
        2.0 * t.pos_dist * t.config.sigma, t.positive_weight
    )
    if t.batch < 2:
        return align
    uniform = 0.5 * (t.uniformity_user + t.uniformity_item)
    return align + t.config.gamma * uniform


def _mawu(t: _Terms) -> torch.Tensor:
    """MAWU (Park et al., CIKM'23): margin-aware alignment
    E_pos[1 - cos(theta + m)] (margin in radians) + each side's
    uniformity at its own weight (gamma_user falls back to gamma)."""
    cos = torch.clamp(1.0 - t.pos_dist, -1.0 + 1e-6, 1.0 - 1e-6)
    theta = torch.arccos(cos)
    align = weighted_mean(
        (1.0 - torch.cos(theta + t.config.margin)) * t.config.sigma,
        t.positive_weight,
    )
    if t.batch < 2:
        return align
    cfg = t.config
    g_user = cfg.gamma if cfg.gamma_user is None else cfg.gamma_user
    return align + g_user * t.uniformity_user + cfg.gamma * t.uniformity_item


_TERM_LOSSES = {
    "AlignmentLoss": _alignment,
    "ContrastiveLoss": _contrastive,
    "AlignmentContrastiveLoss": _alignment_contrastive,
    "DirectAULoss": _direct_au,
    "MAWULoss": _mawu,
    "InfomationNoiseContrastiveEstimationLoss": _infonce,
    "MutualInformationNeuralEstimationLoss": _mine,
    "PairwiseHingeLoss": _pairwise_hinge,
    "PairwiseLogisticLoss": _pairwise_logistic,
}
LOSS_NAMES = tuple(_TERM_LOSSES)


def compute_loss(
    name: str,
    user_embed: torch.Tensor,
    item_embed: torch.Tensor,
    target: torch.Tensor,
    *,
    item_idx: torch.Tensor,
    pos_idx: torch.Tensor | None,
    config: LossConfig,
    log_q: torch.Tensor | None = None,
) -> torch.Tensor:
    """One loss of the family by its registered name."""
    terms = _Terms(
        user_embed, item_embed, target, item_idx, pos_idx, config, log_q
    )
    return _TERM_LOSSES[name](terms)


# Registry with the reference's names and call signature:
# LOSSES[name](user_embed, item_embed, target, *, item_idx, pos_idx,
# config, log_q=None)
LOSSES = {name: functools.partial(compute_loss, name) for name in LOSS_NAMES}


def compute_losses(
    user_embed: torch.Tensor,
    item_embed: torch.Tensor,
    target: torch.Tensor,
    *,
    item_idx: torch.Tensor,
    pos_idx: torch.Tensor | None,
    config: LossConfig,
    log_q: torch.Tensor | None = None,
    names: tuple[str, ...] | None = None,
) -> dict[str, torch.Tensor]:
    """The losses in `names` (default: all), sharing one `_Terms`."""
    terms = _Terms(
        user_embed, item_embed, target, item_idx, pos_idx, config, log_q
    )
    return {
        name: _TERM_LOSSES[name](terms)
        for name in (LOSS_NAMES if names is None else names)
    }
