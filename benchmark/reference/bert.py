"""The published BERT encoder with mean pooling and L2 normalisation.

Post-LN BERT (Devlin et al., arXiv:1810.04805): token and position
embeddings, LayerNorm, then per layer multi-head self-attention with a
residual and LayerNorm and a GELU feed-forward block with a residual and
LayerNorm; the sentence vector is the mean over the non-padding tokens,
scaled to unit length. Every text is one segment, so BERT's segment table
adds one constant row, which the position table absorbs: it is left out.
Dropout sits where BERT puts it (after the embedding LayerNorm, on the
attention probabilities, on the attention output and on the feed-forward
output); its masks come from `generator`, drawn as `torch.rand(shape) >=
rate` in that order, with kept values scaled by 1 / (1 - rate).

`precision` rounds every value that the configuration computes in its
compute dtype (matrix products, activations, the pooled sum); LayerNorm
statistics, the softmax and the normalisation stay in float32.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.precision import rounder


def layout(config: dict) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every weight, in this module's own layout."""
    hidden = config["hidden_size"]
    inter = config["intermediate_size"]
    shapes = {
        "word": (config["vocab_size"], hidden),
        "pos": (config["max_position_embeddings"], hidden),
        "emb_ln.w": (hidden,),
        "emb_ln.b": (hidden,),
    }
    for i in range(config["num_hidden_layers"]):
        for proj in ("q", "k", "v", "o"):
            shapes[f"l{i}.{proj}.w"] = (hidden, hidden)
            shapes[f"l{i}.{proj}.b"] = (hidden,)
        shapes[f"l{i}.ln1.w"] = (hidden,)
        shapes[f"l{i}.ln1.b"] = (hidden,)
        shapes[f"l{i}.ffn1.w"] = (hidden, inter)
        shapes[f"l{i}.ffn1.b"] = (inter,)
        shapes[f"l{i}.ffn2.w"] = (inter, hidden)
        shapes[f"l{i}.ffn2.b"] = (hidden,)
        shapes[f"l{i}.ln2.w"] = (hidden,)
        shapes[f"l{i}.ln2.b"] = (hidden,)
    return shapes


def make_weights(
    config: dict, seed: int, device: torch.device
) -> dict[str, torch.Tensor]:
    """Seeded f32 weights, drawn on `device` in one call: matrices, tables
    and biases normal(0, 0.02), LayerNorm scales 1 + normal(0, 0.1)."""
    shapes = layout(config)
    total = sum(math.prod(shape) for shape in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    weights = {}
    start = 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        piece = flat[start : start + size].view(shape)
        start += size
        if name.endswith("ln1.w") or name.endswith("ln2.w") or name == "emb_ln.w":
            weights[name] = 1.0 + 0.1 * piece
        else:
            weights[name] = 0.02 * piece
    return weights


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _dropout(x, rate, generator):
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def encode(
    weights: dict[str, torch.Tensor],
    tokens: torch.Tensor,
    config: dict,
    *,
    precision: str = "float32",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """(n, L) token ids -> (n, hidden) unit vectors in f32."""
    r = rounder(precision)
    rate = config.get("dropout_rate", 0.0)
    eps = config["layer_norm_eps"]
    heads = config["num_attention_heads"]
    hidden = config["hidden_size"]
    head_dim = hidden // heads
    n, length = tokens.shape
    tokens = tokens.long()
    mask = tokens != 0

    def dense(x, name):
        return r(r(x @ r(weights[f"{name}.w"])) + r(weights[f"{name}.b"]))

    x = r(r(weights["word"][tokens]) + r(weights["pos"][:length])[None])
    x = r(_layer_norm(x, weights["emb_ln.w"], weights["emb_ln.b"], eps))
    x = r(_dropout(x, rate, generator))
    bias = torch.where(mask, 0.0, -1e9)[:, None, None, :]
    for i in range(config["num_hidden_layers"]):
        q = dense(x, f"l{i}.q").view(n, length, heads, head_dim)
        k = dense(x, f"l{i}.k").view(n, length, heads, head_dim)
        v = dense(x, f"l{i}.v").view(n, length, heads, head_dim)
        scores = r(torch.einsum("bqhd,bkhd->bhqk", q, k)) / math.sqrt(head_dim)
        probs = r(torch.softmax(scores + bias, dim=-1))
        probs = r(_dropout(probs, rate, generator))
        context = r(torch.einsum("bhqk,bkhd->bqhd", probs, v))
        attn = dense(context.reshape(n, length, hidden), f"l{i}.o")
        attn = r(_dropout(attn, rate, generator))
        x = r(_layer_norm(r(x + attn), weights[f"l{i}.ln1.w"],
                          weights[f"l{i}.ln1.b"], eps))
        ffn = r(torch.nn.functional.gelu(dense(x, f"l{i}.ffn1")))
        ffn = dense(ffn, f"l{i}.ffn2")
        ffn = r(_dropout(ffn, rate, generator))
        x = r(_layer_norm(r(x + ffn), weights[f"l{i}.ln2.w"],
                          weights[f"l{i}.ln2.b"], eps))
    weight = mask[..., None].float()
    total = r((x * weight).sum(dim=1))
    pooled = r(total / torch.clamp(weight.sum(dim=1), min=1e-9))
    norm = torch.sqrt(torch.clamp((pooled * pooled).sum(-1, keepdim=True),
                                  min=1e-24))
    return pooled / norm
