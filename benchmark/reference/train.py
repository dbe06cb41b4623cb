"""The first training steps of the text tower, in plain PyTorch.

Each step encodes the batch's users, positives and sampled negatives in
one pass (with dropout), takes the pairwise loss and its gradient, and
applies AdamW as `torch.optim.AdamW` defines it (decoupled weight decay on
every weight, then the bias-corrected Adam step with eps outside the
square root).
"""

from __future__ import annotations

import torch

from benchmark.reference import bert
from benchmark.reference.losses import alignment, pairwise_loss

BETAS = (0.9, 0.999)
EPS = 1e-8


def run_steps(
    weights0: dict[str, torch.Tensor],
    batches: list[dict[str, torch.Tensor]],
    config: dict,
    *,
    dropout_seed: int,
    precision: str = "float32",
) -> dict:
    """Losses of each step and the alignment term of its forward, each
    weight's first gradient, and each weight after the last step."""
    device = next(iter(weights0.values())).device
    weights = {k: v.detach().clone().float().requires_grad_(True)
               for k, v in weights0.items()}
    first = {k: torch.zeros_like(v) for k, v in weights.items()}
    second = {k: torch.zeros_like(v) for k, v in weights.items()}
    generator = torch.Generator(device=device).manual_seed(dropout_seed)
    lr = config["learning_rate"]
    decay = config["weight_decay"]
    losses, aligned, first_grad = [], [], None
    for step, batch in enumerate(batches, start=1):
        rows = batch["user_tokens"].shape[0]
        tokens = torch.cat([batch["user_tokens"], batch["item_tokens"],
                            batch["neg_item_tokens"]])
        embeds = bert.encode(weights, tokens, config, precision=precision,
                             generator=generator)
        loss = pairwise_loss(
            config["train_loss"], embeds[:rows], embeds[rows:],
            batch["target"], batch["item_idx"], batch["pos_idx"],
            num_negatives=config["num_negatives"], sigma=config["sigma"],
            margin=config["margin"],
        )
        with torch.no_grad():
            aligned.append(alignment(embeds[:rows], embeds[rows:],
                                     batch["target"], config["sigma"]).item())
        grads = torch.autograd.grad(loss, list(weights.values()))
        loss = loss.detach()
        del embeds
        if first_grad is None:
            first_grad = {k: g.detach().clone()
                          for k, g in zip(weights, grads, strict=True)}
        with torch.no_grad():
            fix1 = 1 - BETAS[0] ** step
            fix2 = 1 - BETAS[1] ** step
            for (name, w), g in zip(weights.items(), grads, strict=True):
                w.mul_(1 - lr * decay)
                first[name].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                second[name].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (second[name].sqrt() / fix2 ** 0.5).add_(EPS)
                w.addcdiv_(first[name], denom, value=-lr / fix1)
        losses.append(loss.item())
    return {
        "losses": losses,
        "alignment": aligned,
        "first_grad": first_grad,
        "weights": {k: v.detach() for k, v in weights.items()},
    }
