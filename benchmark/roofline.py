"""Peaks of one NVIDIA H100 SXM and the least time of the work a cell does.

The peaks are the data sheet's dense rates at the full 700 W power limit
(the same table as `chip_smoke.py`): 989 TFLOP/s in bf16 on the tensor
cores and 3.35 TB/s of HBM bandwidth. Every share against them is printed
with the card's power limit beside it, since a card set below 700 W runs
slower under load.

Work is counted from the shapes of a call's inputs, whatever code carries
it out: each input byte read once, each output byte written once.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

BF16_BYTES = 2
ID_BYTES = 8  # int64 ids of the answers
SCORE_BYTES = 4  # f32 scores of the answers


def search_flops(batch: int, items: int, dim: int) -> float:
    """Multiply-adds of scoring every query against every item, 2·B·N·D."""
    return 2.0 * batch * items * dim


def search_bytes(batch: int, items: int, dim: int, top_k: int) -> float:
    """The bf16 corpus and queries read once, the (B, k) ids and scores
    written once."""
    read = (items + batch) * dim * BF16_BYTES
    written = batch * top_k * (ID_BYTES + SCORE_BYTES)
    return float(read + written)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def search_least_seconds(batch: int, items: int, dim: int, top_k: int) -> float:
    return least_seconds(
        search_flops(batch, items, dim), search_bytes(batch, items, dim, top_k)
    )


def encoder_forward_flops(config: dict, tokens: int, tokens_sq: int) -> float:
    """Forward multiply-adds of the BERT encoder over texts holding `tokens`
    non-padding tokens in all, `tokens_sq` the sum of each text's count
    squared.

    Per layer and token: the Q, K, V and output projections (4·H²) and the
    two FFN matrices (2·H·I), two operations each; per layer and text of n
    tokens: the scores Q·Kᵀ and the weighted sum of V, 2·n²·H each. The
    embedding gathers, LayerNorms, softmax and pooling are not matrix
    products and are left out.
    """
    hidden = config["hidden_size"]
    inter = config["intermediate_size"]
    layers = config["num_hidden_layers"]
    per_token = 2.0 * (4 * hidden * hidden + 2 * hidden * inter)
    per_square = 2.0 * 2 * hidden
    return layers * (per_token * tokens + per_square * tokens_sq)


def train_step_flops(config: dict, tokens: int, tokens_sq: int) -> float:
    """Model FLOPs of one training step: the encoder's forward over every
    text of the step, and its backward at twice the forward."""
    return 3.0 * encoder_forward_flops(config, tokens, tokens_sq)
