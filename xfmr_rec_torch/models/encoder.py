"""Text encoder: BERT-style post-LN transformer + pooling + L2 normalize.

Port of `xfmr_rec_tpu/models/encoder.py` `TextEncoder`. Parameters keep
the flax layouts and names (a Dense kernel is (in, out); the attention
projections are (hidden, heads, head_dim) and (heads, head_dim, hidden)),
so `models/convert.py` only renames. Parameters are f32; the forward
computes in `compute_dtype` (bf16 by default) like the flax module:
tables, kernels and activations are cast to it, LayerNorm statistics and
the softmax run in f32, and the pooled vector is cast to f32 before the
normalize.

Training: `forward(tokens, generator=g)` applies dropout where the flax
module does (after the embedding LayerNorm, on the attention
probabilities, on the attention output and on the FFN output), as flax
does it: keep with probability 1 - p, scale kept values by 1 / (1 - p).
The masks are drawn from the explicit `torch.Generator` `g`, so a run
that restores the generator's state replays them; they never match
JAX's. With no generator the forward is deterministic. `init_encoder`
draws fresh parameters with the flax initializers of the reference.

`remat=True` (the reference's `nn.remat` of each layer) runs each
transformer layer under `torch.utils.checkpoint` (`run_layer`): its
activations are dropped after the forward and recomputed in the
backward. The recompute draws its dropout masks again from the same
generator state, so they equal the forward's, and the generator is left
where the forward left it.

The attention covers at most `max_length` (64) tokens over a few heads,
computed outside any kernel in the JAX package too, so here it is plain
einsum + softmax.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint
from torch import nn

# Multiplicative-hash constants (distinct odd 32-bit) for in-module
# bucket derivation of hash/bloom embedding tables.
_REHASH_MULTIPLIERS = (
    2654435761,
    2246822519,
    3266489917,
    668265263,
    374761393,
    3812015801,
    2176924009,
    2957588489,
)

_CHOICES = {
    "hidden_act": ("gelu", "relu", "silu", "gelu_new"),
    "pooling_mode": ("mean", "max", "cls", "pooler"),
    "compute_dtype": ("float32", "bfloat16"),
    "embedding_type": ("dense", "hash", "bloom"),
    "user_tower": ("text", "history"),
    "item_id_embedding": ("none", "bloom", "hash", "dense"),
}


@dataclasses.dataclass
class ModelConfig:
    """Encoder hyperparameters: the JAX `ModelConfig` fields and defaults.

    `from_dict` takes a whole JAX manifest entry (which also carries the
    training fields of `TrainConfig`) and keeps the fields declared here.
    """

    vocab_size: int = 30522
    hidden_size: int = 384
    num_hidden_layers: int = 3
    num_attention_heads: int = 12
    intermediate_size: int = 1536
    hidden_act: str = "gelu"
    max_position_embeddings: int = 512
    pooling_mode: str = "mean"
    normalize: bool = True
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.1
    initializer_range: float | None = 0.02
    compute_dtype: str = "bfloat16"
    remat: bool = False
    max_length: int = 64
    embedding_type: str = "dense"
    num_hashes: int = 2
    num_buckets: int = 4096
    user_tower: str = "text"
    max_history: int = 16
    history_layers: int = 1
    use_history_ratings: bool = True
    item_id_embedding: str = "none"
    item_id_buckets: int = 8192
    item_id_hashes: int = 2
    item_bias: bool = False
    max_bag: int = 0
    bag_rating_weights: bool = True
    cf_rank: int = 0
    cf_weight: float = 1.0
    cf_pop_weight: float = 0.0

    def __post_init__(self) -> None:
        for name, allowed in _CHOICES.items():
            if getattr(self, name) not in allowed:
                msg = f"{name}={getattr(self, name)!r} not in {allowed}"
                raise ValueError(msg)
        if self.max_bag > 0 and self.user_tower != "history":
            msg = "max_bag > 0 requires user_tower='history' (fusion slot)"
            raise ValueError(msg)
        if self.max_bag > 0 and self.item_id_embedding == "none":
            msg = "max_bag > 0 requires item_id_embedding (the bag IS the ID table)"
            raise ValueError(msg)

    @classmethod
    def from_dict(cls, values: dict) -> ModelConfig:
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in values.items() if k in names})

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def uses_item_ids(config: ModelConfig) -> bool:
    """True when the item tower consumes item identities (movie_rn): an
    ID embedding or a learned popularity bias."""
    return config.item_id_embedding != "none" or config.item_bias


def needs_two_tower(config: ModelConfig) -> bool:
    """True when the model is a `TwoTowerModel` (`models/history.py`):
    the history user tower or an item-identity channel."""
    return config.user_tower == "history" or uses_item_ids(config)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 normalize; rows of exactly zero stay zero."""
    sq = (x * x).sum(dim=-1, keepdim=True)
    x = torch.where(sq < 1e-24, 0.0, x)
    return x * torch.rsqrt(torch.clamp(sq, min=1e-24))


def _activation(name: str):
    return {
        "gelu": lambda x: nn.functional.gelu(x, approximate="none"),
        "gelu_new": lambda x: nn.functional.gelu(x, approximate="tanh"),
        "relu": nn.functional.relu,
        "silu": nn.functional.silu,
    }[name]


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator | None
) -> torch.Tensor:
    """flax `nn.Dropout`: identity without a generator (deterministic),
    else keep each value with probability 1 - rate, scaled by
    1 / (1 - rate), the mask drawn from `generator`."""
    if generator is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = (
        torch.rand(x.shape, generator=generator, device=x.device) >= rate
    )
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Embed(nn.Module):
    """Lookup table (flax `nn.Embed`: param `embedding`).

    Rows are gathered in f32 and then cast, which gives flax's values (a
    cast commutes with a gather) and lets the backward accumulate
    repeated ids in f32 through `embedding_dense_backward`. Indexing
    (`table[ids]`) backpropagates through a scatter that serializes
    repeated ids: 169 ms of a 204 ms step at batch 4096 on an H100,
    where every row repeats the CLS id and the JSON keys.
    """

    def __init__(self, num: int, features: int) -> None:
        super().__init__()
        self.embedding = _param(num, features)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return nn.functional.embedding(ids, self.embedding).to(dtype)


class Dense(nn.Module):
    """flax `nn.Dense` / `nn.DenseGeneral`: kernel of shape in + out."""

    def __init__(self, in_shape: tuple, out_shape: tuple) -> None:
        super().__init__()
        self.kernel = _param(*in_shape, *out_shape)
        self.bias = _param(*out_shape)
        self._in_dims = len(in_shape)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        dims = self._in_dims
        out = torch.tensordot(
            x.to(dtype),
            self.kernel.to(dtype),
            dims=(list(range(x.dim() - dims, x.dim())), list(range(dims))),
        )
        return out + self.bias.to(dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`: f32 statistics with the fast variance
    E[x^2] - E[x]^2 (clamped at 0), output cast to the compute dtype."""

    def __init__(self, features: int, eps: float) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = _param(features)
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp(
            (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0
        )
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean) * mul + self.bias).to(dtype)


class CompressedEmbed(nn.Module):
    """Hash / Bloom table over a compressed bucket space.

    bloom: e(t) = sum_i B[h_i(t)]; hash: e(t) = sum_i w_i(t) * B[h_i(t)].
    Bucket ids: h = (id * m_i) mod 2^32, xor-folded with its high 16 bits,
    mod num_buckets, in uint32 arithmetic done in int64 with a 32-bit
    mask.
    """

    def __init__(self, config: ModelConfig) -> None:
        super().__init__()
        self.mode = config.embedding_type
        self.num_buckets = config.num_buckets
        self.buckets = Embed(config.num_buckets, config.hidden_size)
        if self.mode == "hash":
            self.importance = Embed(config.vocab_size, config.num_hashes)
        self.register_buffer(
            "mults",
            torch.tensor(
                _REHASH_MULTIPLIERS[: config.num_hashes], dtype=torch.int64
            ),
            persistent=False,
        )

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        prod = ((ids.to(torch.int64) & 0xFFFFFFFF)[..., None] * self.mults) & (
            0xFFFFFFFF
        )
        mixed = prod ^ (prod >> 16)
        hashed = mixed % self.num_buckets
        vecs = self.buckets(hashed, dtype)  # (..., num_hashes, features)
        if self.mode == "hash":
            weights = self.importance(ids, dtype)  # (..., num_hashes)
            return torch.einsum("...hf,...h->...f", vecs, weights)
        return vecs.sum(dim=-2)


class TransformerLayer(nn.Module):
    """Post-LN BERT block: self-attention + FFN, residuals, LayerNorms."""

    def __init__(self, config: ModelConfig) -> None:
        super().__init__()
        hidden = config.hidden_size
        heads = config.num_attention_heads
        head_dim = hidden // heads
        self.head_dim = head_dim
        self.query = Dense((hidden,), (heads, head_dim))
        self.key = Dense((hidden,), (heads, head_dim))
        self.value = Dense((hidden,), (heads, head_dim))
        self.attn_out = Dense((heads, head_dim), (hidden,))
        self.attn_norm = LayerNorm(hidden, config.layer_norm_eps)
        self.ffn_in = Dense((hidden,), (config.intermediate_size,))
        self.ffn_out = Dense((config.intermediate_size,), (hidden,))
        self.ffn_norm = LayerNorm(hidden, config.layer_norm_eps)
        self.act = _activation(config.hidden_act)
        self.rate = config.dropout_rate

    def forward(
        self,
        hidden: torch.Tensor,
        mask_bias: torch.Tensor,
        dtype: torch.dtype,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        q = self.query(hidden, dtype)
        k = self.key(hidden, dtype)
        v = self.value(hidden, dtype)
        # the reference divides by a numpy f64 scalar, which promotes the
        # scores to f32 (x64 off): the mask add and softmax run in f32
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(
            self.head_dim
        )
        scores = scores + mask_bias
        probs = torch.softmax(scores.float(), dim=-1).to(dtype)
        probs = dropout(probs, self.rate, generator)
        context = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        attn_out = dropout(self.attn_out(context, dtype), self.rate, generator)
        hidden = self.attn_norm(hidden + attn_out, dtype)
        ffn = self.act(self.ffn_in(hidden, dtype))
        ffn = dropout(self.ffn_out(ffn, dtype), self.rate, generator)
        return self.ffn_norm(hidden + ffn, dtype)


def run_layer(
    layer: nn.Module,
    hidden: torch.Tensor,
    mask_bias: torch.Tensor,
    dtype: torch.dtype,
    generator: torch.Generator | None,
    *,
    remat: bool,
) -> torch.Tensor:
    """`layer(hidden, mask_bias, dtype, generator)`; with `remat`, its
    activations are recomputed in the backward (`torch.utils.checkpoint`,
    non-reentrant).

    `checkpoint(preserve_rng_state=True)` saves only the default CPU and
    CUDA generators, and dropout draws from the explicit `generator`. So
    its state is saved before the forward, set back before the recompute
    (the masks repeat), and the state it had then is restored after the
    recompute (later draws are those of a run without remat). Without
    gradients there is nothing to recompute and the layer runs as is.
    """
    if not remat or not torch.is_grad_enabled():
        return layer(hidden, mask_bias, dtype, generator)
    if generator is None:
        return torch.utils.checkpoint.checkpoint(
            layer, hidden, mask_bias, dtype, None,
            use_reentrant=False, preserve_rng_state=False,
        )
    before = generator.get_state()
    forward_done = False

    def run(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        nonlocal forward_done
        if not forward_done:
            forward_done = True
            return layer(h, m, dtype, generator)
        after = generator.get_state()
        generator.set_state(before)
        try:
            return layer(h, m, dtype, generator)
        finally:
            generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(
        run, hidden, mask_bias, use_reentrant=False, preserve_rng_state=False
    )


class TextEncoder(nn.Module):
    """Token ids (batch, seq) -> unit-norm embeddings (batch, hidden) f32."""

    def __init__(self, config: ModelConfig) -> None:
        super().__init__()
        self.config = config
        if config.embedding_type == "dense":
            self.word_embed = Embed(config.vocab_size, config.hidden_size)
        else:
            self.word_embed = CompressedEmbed(config)
        self.position_embed = Embed(
            config.max_position_embeddings, config.hidden_size
        )
        self.embed_norm = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.layers = nn.ModuleList(
            TransformerLayer(config) for _ in range(config.num_hidden_layers)
        )
        if config.pooling_mode == "pooler":
            self.pooler = Dense((config.hidden_size,), (config.hidden_size,))

    def forward(
        self,
        token_ids: torch.Tensor,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Unit-norm embeddings; dropout on when `generator` is given."""
        cfg = self.config
        dtype = cfg.torch_dtype
        token_ids = token_ids.long()
        mask = token_ids != 0  # PAD_ID == 0
        embeds = self.word_embed(token_ids, dtype)
        positions = torch.arange(token_ids.shape[-1], device=token_ids.device)
        embeds = embeds + self.position_embed(positions, dtype)[None]
        hidden = self.embed_norm(embeds, dtype)
        hidden = dropout(hidden, cfg.dropout_rate, generator)
        mask_bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :]
        for layer in self.layers:
            hidden = run_layer(
                layer, hidden, mask_bias, dtype, generator, remat=cfg.remat
            )
        pooled = self._pool(hidden, mask, dtype).float()
        if cfg.normalize:
            pooled = l2_normalize(pooled)
        return pooled

    def _pool(
        self, hidden: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype
    ) -> torch.Tensor:
        mode = self.config.pooling_mode
        if mode == "cls":
            return hidden[:, 0]
        if mode == "pooler":
            return torch.tanh(self.pooler(hidden[:, 0], dtype))
        if mode == "max":
            # -1e9, not -inf: an all-PAD row must pool to a finite value
            masked = torch.where(mask[..., None], hidden, -1e9)
            return masked.amax(dim=1)
        weights = mask[..., None].to(hidden.dtype)
        total = (hidden * weights).sum(dim=1)
        count = torch.clamp(weights.sum(dim=1), min=1e-9)
        return total / count


def _truncated_normal(
    shape: tuple, std: float, generator: torch.Generator
) -> torch.Tensor:
    """jax.random.truncated_normal(-2, 2) * std."""
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, std=1.0, a=-2.0, b=2.0, generator=generator)
    return out * std


def init_params_(
    model: nn.Module, config: ModelConfig, generator: torch.Generator
) -> None:
    """Draw every `Dense`, `Embed` and `LayerNorm` of `model` in place with
    the reference's initializers: with `initializer_range` set,
    normal(initializer_range) for Dense kernels and tables; with None,
    flax's defaults, lecun-normal kernels (truncated normal, variance
    1 / fan_in over the flattened input axes) and normal(1 / sqrt(features))
    tables. Biases and LayerNorm offsets are 0, LayerNorm scales 1."""
    std = config.initializer_range
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Dense):
                fan_in = math.prod(module.kernel.shape[: module._in_dims])
                if std is None:
                    stddev = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    value = _truncated_normal(
                        module.kernel.shape, stddev, generator
                    )
                else:
                    value = torch.randn(
                        module.kernel.shape, generator=generator
                    ) * std
                module.kernel.copy_(value)
                module.bias.zero_()
            elif isinstance(module, Embed):
                table_std = (
                    std
                    if std is not None
                    else 1.0 / math.sqrt(module.embedding.shape[1])
                )
                module.embedding.copy_(
                    torch.randn(module.embedding.shape, generator=generator)
                    * table_std
                )
            elif isinstance(module, LayerNorm):
                module.scale.fill_(1.0)
                module.bias.zero_()


def init_encoder(config: ModelConfig, seed: int = 0) -> TextEncoder:
    """A `TextEncoder` with fresh parameters, drawn on the CPU from `seed`
    (so every device starts from the same values) by `init_params_`;
    hash importances start at 1."""
    encoder = TextEncoder(config)
    init_params_(encoder, config, torch.Generator().manual_seed(seed))
    if isinstance(encoder.word_embed, CompressedEmbed) and hasattr(
        encoder.word_embed, "importance"
    ):
        with torch.no_grad():
            encoder.word_embed.importance.embedding.fill_(1.0)
    return encoder
