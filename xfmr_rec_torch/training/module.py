"""Training module: configs, train state, train and eval steps.

Port of `xfmr_rec_tpu/training/module.py`, in plain PyTorch with autograd
(the training step has no hand-written kernel in either package).

- `TrainConfig` extends the encoder config with the training knobs and
  the reference's trained-config defaults (hidden 32, 1 layer, 4 heads,
  intermediate 32, PairwiseHingeLoss, num_negatives 4, sigma / margin
  1.0, lr 1e-4, top_k 20).
- `train_step` computes the loss family for logging and differentiates
  only `train_loss`; the user, positive and negative towers run as one
  (3B, L) encoder pass. Two-tower configs (`needs_two_tower`: the
  history user tower, item-identity channels) train a `TwoTowerModel`
  through `train_embeds`, one text pass over (3 + H) * B rows.
- The optimizer is `optax.adamw(lr, weight_decay)`: AdamW with
  b1 0.9, b2 0.999, eps 1e-8 outside the square root, decay on every
  parameter. That is `torch.optim.AdamW` with one group over all
  parameters; a parameter with no gradient gets a zero one, so it is
  decayed as optax decays it.
- Schedules (`learning_rate_at`): constant; linear warmup from 0; or
  warmup-cosine from 0 to lr and down to 0.01 lr at `total_steps`. As in
  optax, the value is read at the update count before the update, so a
  warmup's first step has lr 0.
- `train/grad_norm` is the global L2 norm of the gradients (no clipping).

`dropout_rng_impl` is accepted for config compatibility and ignored:
dropout masks come from the state's `torch.Generator` and never match
JAX's. `remat=True` is refused: `torch.utils.checkpoint` restores the
global RNG, not an explicit generator, so a replayed forward of the text
or the fusion layers would draw other masks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from xfmr_rec_torch.device import resolve_device
from xfmr_rec_torch.models.encoder import (
    ModelConfig,
    TextEncoder,
    init_encoder,
    needs_two_tower,
    uses_item_ids,
)
from xfmr_rec_torch.models.history import TwoTowerModel, init_two_tower
from xfmr_rec_torch.ops.losses import LOSS_NAMES, LossConfig, compute_losses
from xfmr_rec_torch.params import TOP_K

_TRAIN_CHOICES = {
    "train_loss": LOSS_NAMES,
    "dropout_rng_impl": ("rbg", "threefry"),
    "index_dtype": ("bfloat16", "float32", "int8"),
    "lr_schedule": ("constant", "cosine"),
}

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
COSINE_END_FRACTION = 0.01


@dataclasses.dataclass
class TrainConfig(ModelConfig):
    """The reference's `TrainConfig` fields and defaults."""

    hidden_size: int = 32
    num_hidden_layers: int = 1
    num_attention_heads: int = 4
    intermediate_size: int = 32

    train_loss: str = "PairwiseHingeLoss"
    num_negatives: int = 4
    sigma: float = 1.0
    margin: float = 1.0
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    top_k: int = TOP_K
    use_logq_correction: bool = False
    gamma: float = 1.0
    gamma_user: float | None = None
    dropout_rng_impl: str = "rbg"
    index_dtype: str = "bfloat16"
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int | None = None

    def __post_init__(self) -> None:
        super().__post_init__()
        for name, allowed in _TRAIN_CHOICES.items():
            if getattr(self, name) not in allowed:
                msg = f"{name}={getattr(self, name)!r} not in {allowed}"
                raise ValueError(msg)


def loss_config(config: TrainConfig) -> LossConfig:
    return LossConfig(
        num_negatives=config.num_negatives,
        sigma=config.sigma,
        margin=config.margin,
        gamma=config.gamma,
        gamma_user=config.gamma_user,
        use_logq_correction=config.use_logq_correction,
    )


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule(init, end, steps) at `count`."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def learning_rate_at(config: TrainConfig, count: int) -> float:
    """The optax schedule of the reference's `create_train_state` at
    update count `count` (the count before the update)."""
    lr = config.learning_rate
    if config.lr_schedule != "cosine" and not config.warmup_steps:
        return lr
    warmup = config.warmup_steps
    if config.lr_schedule != "cosine":
        return _linear(0.0, lr, max(warmup, 1), count)
    if count < warmup:
        return _linear(0.0, lr, warmup, count)
    total = config.total_steps or max(warmup + 1, 1000)
    decay = total - warmup
    # optax's alpha is end_value / peak_value, end_value = 0.01 * lr
    alpha = 0.0 if lr == 0.0 else lr * COSINE_END_FRACTION / lr
    steps = min(count - warmup, decay)
    cosine = 0.5 * (1.0 + math.cos(math.pi * steps / decay))
    return lr * ((1.0 - alpha) * cosine + alpha)


def check_supported(config: TrainConfig) -> None:
    """Refuse what the port does not train (yet): `remat`."""
    if config.remat:
        msg = (
            "remat=True is not supported by the port: "
            "torch.utils.checkpoint restores the global RNG, not the "
            "explicit dropout generator, so the replayed masks of the text "
            "and fusion layers would differ (ROADMAP.md, Queue 1 item 6)"
        )
        raise NotImplementedError(msg)


class TrainState:
    """The model (a `TextEncoder`, or a `TwoTowerModel` for two-tower
    configs), its AdamW state, the update count and the dropout generator.

    Parameters are drawn on the CPU from `seed` (`init_encoder` /
    `init_two_tower`), so every
    device starts from the same values, then live on `device` (the card
    unless the caller passes "cpu"); the dropout generator lives there
    too, seeded from `seed + 1`.
    """

    def __init__(
        self,
        config: TrainConfig,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        check_supported(config)
        if config.lr_schedule == "cosine":
            total = config.total_steps or max(config.warmup_steps + 1, 1000)
            if total - config.warmup_steps <= 0:
                msg = (
                    "the cosine schedule needs total_steps > warmup_steps "
                    f"(got {total} <= {config.warmup_steps})"
                )
                raise ValueError(msg)
        self.config = config
        self.device = resolve_device(device)
        init = init_two_tower if needs_two_tower(config) else init_encoder
        self.model: TextEncoder | TwoTowerModel = init(config, seed).to(
            self.device
        )
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(),
            lr=learning_rate_at(config, 0),
            betas=ADAM_BETAS,
            eps=ADAM_EPS,
            weight_decay=config.weight_decay,
        )
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1
        )


def batch_to_device(
    batch: dict[str, np.ndarray], device: torch.device
) -> dict[str, torch.Tensor]:
    return {
        key: torch.from_numpy(np.ascontiguousarray(value)).to(device)
        for key, value in batch.items()
    }


def _two_tower_inputs(
    batch: dict[str, torch.Tensor], config: TrainConfig
) -> dict[str, torch.Tensor]:
    """The batch fields `TwoTowerModel.train_embeds` takes for `config`."""
    names = []
    if config.user_tower == "history":
        names += ["hist_tokens", "hist_mask", "hist_ratings"]
        if uses_item_ids(config):
            names.append("hist_rns")
    if config.max_bag > 0:
        names += ["bag_rns", "bag_ratings", "bag_mask"]
    out = {name: batch[name] for name in names}
    if uses_item_ids(config):
        out["item_rns"] = batch["item_idx"]
    return out


def compute_batch_losses(
    model: TextEncoder | TwoTowerModel,
    batch: dict[str, torch.Tensor],
    config: TrainConfig,
    generator: torch.Generator | None = None,
    names: tuple[str, ...] | None = None,
) -> dict[str, torch.Tensor]:
    """Encode user + positive + negative (+ history) rows in one pass and
    run the loss family (dropout on when `generator` is given)."""
    towers = (
        batch["user_tokens"], batch["item_tokens"], batch["neg_item_tokens"]
    )
    if needs_two_tower(config):
        user_embed, item_embed = model.train_embeds(
            *towers, generator=generator, **_two_tower_inputs(batch, config)
        )
    else:
        batch_size = towers[0].shape[0]
        embeds = model(torch.cat(towers), generator)
        user_embed = embeds[:batch_size]
        item_embed = embeds[batch_size:]  # positives then sampled negatives
    return compute_losses(
        user_embed,
        item_embed,
        batch["target"],
        item_idx=batch["item_idx"],
        pos_idx=batch["pos_idx"],
        config=loss_config(config),
        log_q=batch.get("log_q"),
        names=names,
    )


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all entries together."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


def train_step(
    state: TrainState,
    batch: dict[str, torch.Tensor],
    *,
    log_all_losses: bool = True,
) -> dict[str, torch.Tensor]:
    """One AdamW update on `train_loss`; returns the step's metrics
    (device tensors, no host sync). `log_all_losses=False` computes only
    the train loss: the same update, fewer metrics."""
    config = state.config
    names = None if log_all_losses else (config.train_loss,)
    lr = learning_rate_at(config, state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)
    losses = compute_batch_losses(
        state.model, batch, config, generator=state.generator, names=names
    )
    losses[config.train_loss].backward()
    params = list(state.model.parameters())
    for param in params:
        if param.grad is None:
            param.grad = torch.zeros_like(param)
    grad_norm = global_norm([param.grad for param in params])
    state.optimizer.step()
    state.step += 1
    metrics = {f"train/{name}": loss.detach() for name, loss in losses.items()}
    metrics["train/grad_norm"] = grad_norm
    return metrics


@torch.no_grad()
def eval_losses(
    state: TrainState, batch: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """The full loss family with the deterministic encoder (raw names;
    the caller adds the `val/` / `test/` prefix)."""
    return compute_batch_losses(state.model, batch, state.config)


@torch.no_grad()
def encode(
    model: TextEncoder | TwoTowerModel, tokens: torch.Tensor
) -> torch.Tensor:
    """Deterministic batched text encoding (corpus / query embedding)."""
    return model(tokens)
