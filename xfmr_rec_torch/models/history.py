"""History-aware user tower and item-identity channels.

Port of `xfmr_rec_tpu/models/history.py`:

    user_embed = Fusion([profile_text_emb, hist_item_emb_1..H (, bag)])

- `IdEmbed`: a per-item table keyed by movie_rn (1-based, 0 = pad):
  "dense" (a direct table), "bloom" (the sum of `num_hashes` bucket rows)
  or "hash" (bucket rows weighted by a learned importance keyed by a
  separate hash). Bucket ids are the reference's uint32 multiplicative
  hash with an xor-fold of the high bits, computed in int64 with a 32-bit
  mask (multiplication modulo 2^64 keeps the low 32 bits exact).
  rn == 0 gives exactly the zero vector.
- `HistoryFusion`: slot (recency) and rating embeddings, LayerNorm,
  dropout, `history_layers` post-LN transformer layers with the -1e9
  mask bias, masked mean pooling and the gradient-safe L2 normalize.
- `TwoTowerModel`: the shared `TextEncoder` plus the channels. The item
  tower adds an ID embedding before the normalize and a popularity-bias
  column after it (user vectors carry a constant 1 beside it); the CF
  bag is a fusion slot holding the normalized, rating-weighted mean of
  the ID embeddings of the user's train items.

Parameters keep the flax names (`models/convert.py` maps them), are f32,
and compute as the flax modules do. Dropout draws from the explicit
`torch.Generator` passed as `generator` (none: deterministic). The
fusion has no Pallas kernel in the reference; it is plain PyTorch with
autograd here too.
"""

from __future__ import annotations

import torch
from torch import nn

from xfmr_rec_torch.models.encoder import (
    _REHASH_MULTIPLIERS,
    Embed,
    LayerNorm,
    ModelConfig,
    TextEncoder,
    TransformerLayer,
    dropout,
    init_params_,
    l2_normalize,
    needs_two_tower,
    uses_item_ids,
)

__all__ = [
    "HistoryFusion",
    "IdEmbed",
    "TwoTowerModel",
    "init_two_tower",
    "needs_two_tower",
    "uses_item_ids",
]

# rating vocabulary: 0 = n/a (profile slot, padding, bag), 1..5 = stars
RATING_VOCAB = 8
_MASK32 = 0xFFFFFFFF


def _fold_hash(rns: torch.Tensor, mults: torch.Tensor, buckets: int):
    """((rn * m) mod 2^32, xor-folded with its high 16 bits) mod buckets."""
    prod = ((rns & _MASK32)[..., None] * mults) & _MASK32
    return (prod ^ (prod >> 16)) % buckets


class IdEmbed(nn.Module):
    """Item-ID embedding (flax names: `table`, or `buckets` and, in hash
    mode, `importance`); computes in f32."""

    def __init__(
        self, mode: str, num_buckets: int, num_hashes: int, features: int
    ) -> None:
        super().__init__()
        self.mode = mode
        self.num_buckets = num_buckets
        if mode == "dense":
            self.table = Embed(num_buckets, features)
            return
        self.buckets = Embed(num_buckets, features)
        if mode == "hash":
            self.importance = Embed(num_buckets, num_hashes)
        self.register_buffer(
            "mults",
            torch.tensor(_REHASH_MULTIPLIERS[:num_hashes], dtype=torch.int64),
            persistent=False,
        )
        self.register_buffer(
            "importance_mult",
            torch.tensor(_REHASH_MULTIPLIERS[-1:], dtype=torch.int64),
            persistent=False,
        )

    def forward(self, rns: torch.Tensor) -> torch.Tensor:
        rns = rns.long()
        f32 = torch.float32
        if self.mode == "dense":
            vec = self.table(torch.clamp(rns, max=self.num_buckets - 1), f32)
        else:
            vecs = self.buckets(
                _fold_hash(rns, self.mults, self.num_buckets), f32
            )
            if self.mode == "hash":
                key = _fold_hash(rns, self.importance_mult, self.num_buckets)
                weights = self.importance(key[..., 0], f32)
                vec = torch.einsum("...hf,...h->...f", vecs, weights)
            else:
                vec = vecs.sum(dim=-2)
        return torch.where((rns > 0)[..., None], vec, 0.0)


class HistoryFusion(nn.Module):
    """Fuse a profile embedding with H history-item embeddings (slot 0 =
    profile, slots 1..H most-recent-first, then the optional bag slot);
    padded slots are masked out of attention and pooling."""

    def __init__(self, config: ModelConfig) -> None:
        super().__init__()
        self.config = config
        dim = config.hidden_size
        self.slot_embed = Embed(
            config.max_history + (2 if config.max_bag > 0 else 1), dim
        )
        if config.use_history_ratings:
            self.rating_embed = Embed(RATING_VOCAB, dim)
        self.fusion_embed_norm = LayerNorm(dim, config.layer_norm_eps)
        self.layers = nn.ModuleList(
            TransformerLayer(config) for _ in range(config.history_layers)
        )

    def forward(
        self,
        text_emb: torch.Tensor,  # (B, d)
        hist_embs: torch.Tensor,  # (B, H, d)
        hist_mask: torch.Tensor,  # (B, H) bool
        hist_ratings: torch.Tensor | None = None,  # (B, H)
        bag_emb: torch.Tensor | None = None,  # (B, d)
        bag_valid: torch.Tensor | None = None,  # (B,) bool
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cfg = self.config
        dtype = cfg.torch_dtype
        batch, hist_len, _ = hist_embs.shape
        dev = hist_embs.device
        has_bag = bag_emb is not None
        parts = [text_emb[:, None, :], hist_embs]
        slot_ids = torch.arange(hist_len + 1, device=dev)
        if has_bag:
            parts.append(bag_emb[:, None, :])
            slot_ids = torch.cat(
                [slot_ids, torch.tensor([cfg.max_history + 1], device=dev)]
            )
        seq = torch.cat(parts, dim=1).to(dtype)
        seq = seq + self.slot_embed(slot_ids, dtype)[None]
        if cfg.use_history_ratings:
            ratings = (
                torch.zeros((batch, hist_len), dtype=torch.long, device=dev)
                if hist_ratings is None
                else torch.clamp(hist_ratings.long(), 0, RATING_VOCAB - 1)
            )
            pad = torch.zeros((batch, 1), dtype=torch.long, device=dev)
            ratings = torch.cat(
                [pad, ratings, pad] if has_bag else [pad, ratings], dim=1
            )
            seq = seq + self.rating_embed(ratings, dtype)
        mask_parts = [
            torch.ones((batch, 1), dtype=torch.bool, device=dev),
            hist_mask.bool(),
        ]
        if has_bag:
            valid = (
                torch.ones(batch, dtype=torch.bool, device=dev)
                if bag_valid is None
                else bag_valid.bool()
            )
            mask_parts.append(valid[:, None])
        mask = torch.cat(mask_parts, dim=1)
        seq = self.fusion_embed_norm(seq, dtype)
        seq = dropout(seq, cfg.dropout_rate, generator)
        mask_bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :]
        for layer in self.layers:
            seq = layer(seq, mask_bias, dtype, generator)
        weights = mask[..., None].to(seq.dtype)
        pooled = (seq * weights).sum(dim=1) / torch.clamp(
            weights.sum(dim=1), min=1e-9
        )
        pooled = pooled.float()
        return l2_normalize(pooled) if cfg.normalize else pooled


class TwoTowerModel(nn.Module):
    """Shared text encoder + item-identity channels + history fusion.

    `forward(tokens)` is the plain text path (raw queries), so the model
    stands in for a `TextEncoder` in every query-encode call; the towers
    are `encode_items`, `fuse_user` (eval / serving: history embeddings
    gathered from the corpus), `encode_user` (history re-encoded) and
    `train_embeds` (one text pass over every role).
    """

    def __init__(self, config: ModelConfig) -> None:
        super().__init__()
        self.config = config
        self.text = TextEncoder(config)
        if config.user_tower == "history":
            self.fusion = HistoryFusion(config)
        if config.item_id_embedding != "none":
            self.item_id = IdEmbed(
                config.item_id_embedding,
                config.item_id_buckets,
                config.item_id_hashes,
                config.hidden_size,
            )
        if config.item_bias:
            self.bias_table = IdEmbed(
                config.item_id_embedding
                if config.item_id_embedding != "none"
                else "bloom",
                config.item_id_buckets,
                config.item_id_hashes,
                1,
            )
        if config.max_bag > 0 and config.bag_rating_weights:
            self.bag_rating_weight = nn.Parameter(torch.ones(RATING_VOCAB))

    def forward(
        self, token_ids: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """Raw-text query embedding (no item identity, no bias column)."""
        return self.text(token_ids, generator)

    # -- item tower ----------------------------------------------------
    def _item_d(
        self, text_emb: torch.Tensor, rns: torch.Tensor | None
    ) -> torch.Tensor:
        if self.config.item_id_embedding == "none" or rns is None:
            return text_emb
        return l2_normalize(text_emb + self.item_id(rns))

    def _append_bias(
        self, item_d: torch.Tensor, rns: torch.Tensor | None
    ) -> torch.Tensor:
        if not self.config.item_bias:
            return item_d
        bias = (
            self.bias_table(rns)
            if rns is not None
            else torch.zeros_like(item_d[..., :1])
        )
        return torch.cat([item_d, bias], dim=-1)

    def _append_one(self, user_emb: torch.Tensor) -> torch.Tensor:
        if not self.config.item_bias:
            return user_emb
        return torch.cat([user_emb, torch.ones_like(user_emb[..., :1])], -1)

    def encode_items(
        self,
        item_tokens: torch.Tensor,
        item_rns: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        text_emb = self.text(item_tokens, generator)
        return self._append_bias(self._item_d(text_emb, item_rns), item_rns)

    # -- CF bag ----------------------------------------------------------
    def _bag_vec(
        self,
        bag_rns: torch.Tensor,
        bag_ratings: torch.Tensor,
        bag_mask: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        bag_mask = bag_mask.bool()
        vecs = self.item_id(torch.where(bag_mask, bag_rns.long(), 0))
        weights = bag_mask.float()
        if self.config.bag_rating_weights:
            levels = torch.clamp(bag_ratings.long(), 0, RATING_VOCAB - 1)
            weights = weights * self.bag_rating_weight[levels]
        vec = (vecs * weights[..., None]).sum(dim=1)
        return l2_normalize(vec), bag_mask.any(dim=1)

    # -- user tower ------------------------------------------------------
    def fuse_user(
        self,
        text_emb: torch.Tensor,
        hist_embs: torch.Tensor,
        hist_mask: torch.Tensor,
        hist_ratings: torch.Tensor | None = None,
        bag_rns: torch.Tensor | None = None,
        bag_ratings: torch.Tensor | None = None,
        bag_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        bag_emb = bag_valid = None
        if self.config.max_bag > 0 and bag_rns is not None:
            bag_emb, bag_valid = self._bag_vec(bag_rns, bag_ratings, bag_mask)
        fused = self.fusion(
            text_emb, hist_embs, hist_mask, hist_ratings, bag_emb, bag_valid,
            generator,
        )
        return self._append_one(fused)

    def _hist_embs(
        self, embs: torch.Tensor, hist_rns: torch.Tensor | None, shape
    ) -> torch.Tensor:
        rns = None if hist_rns is None else hist_rns.reshape(-1)
        return self._item_d(embs, rns).reshape(*shape, -1)

    def encode_user(
        self,
        user_tokens: torch.Tensor,  # (B, L)
        hist_tokens: torch.Tensor,  # (B, H, L)
        hist_mask: torch.Tensor,
        hist_ratings: torch.Tensor | None = None,
        hist_rns: torch.Tensor | None = None,
        bag_rns: torch.Tensor | None = None,
        bag_ratings: torch.Tensor | None = None,
        bag_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        if self.config.user_tower != "history":
            return self._append_one(self.text(user_tokens, generator))
        batch, hist_len, seq_len = hist_tokens.shape
        embs = self.text(
            torch.cat(
                [user_tokens, hist_tokens.reshape(batch * hist_len, seq_len)]
            ),
            generator,
        )
        hist_embs = self._hist_embs(embs[batch:], hist_rns, (batch, hist_len))
        return self.fuse_user(
            embs[:batch], hist_embs, hist_mask, hist_ratings,
            bag_rns, bag_ratings, bag_mask, generator,
        )

    @torch.no_grad()
    def encode_users_from_corpus(
        self,
        user_tokens: torch.Tensor,  # (B, L)
        corpus: torch.Tensor,  # (N, d) f32 item embeddings, no extra columns
        hist_positions: torch.Tensor,  # (B, H), padded slots clipped to 0
        hist_mask: torch.Tensor,
        hist_ratings: torch.Tensor,
        bag_rns: torch.Tensor | None = None,
        bag_ratings: torch.Tensor | None = None,
        bag_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """The eval / serving user tower of the history model: one text
        encode, history embeddings gathered from the corpus matrix (rows
        the same encoder made from the same item tokens), one fusion
        block."""
        return self.fuse_user(
            self(user_tokens), corpus[hist_positions.long()], hist_mask,
            hist_ratings, bag_rns, bag_ratings, bag_mask,
        )

    def train_embeds(
        self,
        user_tokens: torch.Tensor,  # (B, L)
        item_tokens: torch.Tensor,  # (B, L) positives
        neg_item_tokens: torch.Tensor,  # (B, L) sampled negatives
        hist_tokens: torch.Tensor | None = None,  # (B, H, L)
        hist_mask: torch.Tensor | None = None,
        hist_ratings: torch.Tensor | None = None,
        item_rns: torch.Tensor | None = None,  # (2B,) positives then negatives
        hist_rns: torch.Tensor | None = None,  # (B, H)
        bag_rns: torch.Tensor | None = None,  # (B, G)
        bag_ratings: torch.Tensor | None = None,
        bag_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One text-encoder pass over every role -> user (B, d[+1]) and
        item (2B, d[+1]) embeddings, positives then negatives. The bag
        must already have the row's own positive masked out."""
        batch = user_tokens.shape[0]
        history = self.config.user_tower == "history"
        parts = [user_tokens, item_tokens, neg_item_tokens]
        if history:
            hist_len, seq_len = hist_tokens.shape[1:]
            parts.append(hist_tokens.reshape(batch * hist_len, seq_len))
        embs = self.text(torch.cat(parts), generator)
        item_d = self._item_d(embs[batch : 3 * batch], item_rns)
        item_embed = self._append_bias(item_d, item_rns)
        if not history:
            return self._append_one(embs[:batch]), item_embed
        hist_embs = self._hist_embs(
            embs[3 * batch :], hist_rns, (batch, hist_len)
        )
        user_embed = self.fuse_user(
            embs[:batch], hist_embs, hist_mask, hist_ratings,
            bag_rns, bag_ratings, bag_mask, generator,
        )
        return user_embed, item_embed


def init_two_tower(config: ModelConfig, seed: int = 0) -> TwoTowerModel:
    """A `TwoTowerModel` with fresh parameters drawn on the CPU from
    `seed` with the reference's initializers (`init_params_`); hash
    importances and the bag's rating weights start at 1 and the
    popularity bias at exactly 0."""
    model = TwoTowerModel(config)
    init_params_(model, config, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, IdEmbed) and hasattr(module, "importance"):
                module.importance.embedding.fill_(1.0)
        text_embed = model.text.word_embed
        if hasattr(text_embed, "importance"):
            text_embed.importance.embedding.fill_(1.0)
        if config.item_bias:
            for name, param in model.bias_table.named_parameters():
                if not name.startswith("importance"):
                    param.zero_()
        if hasattr(model, "bag_rating_weight"):
            model.bag_rating_weight.fill_(1.0)
    return model
