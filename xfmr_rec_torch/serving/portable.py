"""Portable (numpy-only) inference of the text encoder.

Port of `xfmr_rec_tpu/serving/portable.py`. `PortableEncoder` runs the
`TextEncoder` forward (deterministic, f32 throughout) in numpy from an
artifact's `encoder.npz` + `portable.json`, written by either package's
`Trainer.save` or by `export_portable`. Its contract is a host with no
accelerator framework: importing this module imports neither torch nor
JAX, and it runs nothing on a card (it is not an entry point that takes
a device). The hashing tokenizer is numpy too (with its native library,
`native/tokenizer.cpp`, built by `g++` at first use), so `embed(texts)`
is portable end to end.

Scope: the text encode path (item text, user profile text, raw
queries). History fusion and identity channels stay on the serving
engine; for a two-tower artifact the export holds the shared text tower
(its parameters live under `text/`).
"""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np

from xfmr_rec_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from xfmr_rec_torch.params import (
    ENCODER_MSGPACK,
    PORTABLE_JSON,
    PORTABLE_NPZ,
    PROCESSORS_JSON,
)

# the multiplicative-hash constants of `models/encoder.py`
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


def export_portable(
    artifact_dir: str | pathlib.Path,
    out_dir: str | pathlib.Path | None = None,
) -> pathlib.Path:
    """Write `encoder.npz` + `portable.json` from a serving artifact's
    `encoder.msgpack` (the text tower's subtree for a two-tower model),
    through `models/convert.py` `write_portable`. Runs at packaging time
    and imports torch; the output needs numpy only."""
    import torch

    from xfmr_rec_torch.models import convert
    from xfmr_rec_torch.models.encoder import ModelConfig, needs_two_tower

    path = pathlib.Path(artifact_dir)
    out = pathlib.Path(out_dir) if out_dir else path
    manifest = json.loads((path / PROCESSORS_JSON).read_text())
    flat = convert.read_msgpack(path / ENCODER_MSGPACK)
    if needs_two_tower(ModelConfig.from_dict(manifest["model"])):
        flat = {
            name.removeprefix("text/"): value
            for name, value in flat.items()
            if name.startswith("text/")
        }
    state = {
        convert.torch_name(name): torch.from_numpy(value)
        for name, value in flat.items()
    }
    return convert.write_portable(
        state, manifest["model"], manifest.get("data", {}), out
    )


def _layer_norm(x: np.ndarray, scale, bias, eps: float) -> np.ndarray:
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * scale + bias


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _act(name: str):
    if name == "relu":
        return lambda x: np.maximum(x, 0.0)
    if name == "silu":
        return lambda x: x / (1.0 + np.exp(-x))
    if name == "gelu_new":
        c = np.sqrt(2.0 / np.pi)
        return lambda x: 0.5 * x * (1.0 + np.tanh(c * (x + 0.044715 * x**3)))
    # exact gelu
    try:
        from scipy.special import erf
    except ImportError:  # a host without scipy
        erf = np.vectorize(math.erf)
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    return lambda x: 0.5 * x * (1.0 + erf(x * inv_sqrt2))


class PortableEncoder:
    """numpy mirror of `models/encoder.py` `TextEncoder` (dropout off,
    f32 throughout)."""

    def __init__(self, config: dict, params: dict[str, np.ndarray]) -> None:
        self.config = config
        self.params = params
        tok = config.get("tokenizer")
        self.tokenizer = None
        if tok and tok.get("kind", "hashing") == "hashing":
            self.tokenizer = HashingTokenizer(
                TokenizerConfig(
                    vocab_size=tok["vocab_size"], max_length=tok["max_length"]
                )
            )

    @classmethod
    def load(cls, artifact_dir: str | pathlib.Path) -> PortableEncoder:
        path = pathlib.Path(artifact_dir)
        meta = json.loads((path / PORTABLE_JSON).read_text())
        with np.load(path / PORTABLE_NPZ, allow_pickle=False) as npz:
            params = {key: npz[key].astype(np.float32) for key in npz.files}
        config = dict(meta["model"])
        config["tokenizer"] = meta.get("tokenizer")
        return cls(config, params)

    def _word_embed(self, ids: np.ndarray) -> np.ndarray:
        cfg, p = self.config, self.params
        etype = cfg.get("embedding_type", "dense")
        if etype == "dense":
            return p["word_embed/embedding"][ids]
        buckets = p["word_embed/buckets/embedding"]
        num_buckets = np.uint32(cfg.get("num_buckets", 4096))
        num_hashes = int(cfg.get("num_hashes", 2))
        mults = np.asarray(_REHASH_MULTIPLIERS[:num_hashes], dtype=np.uint32)
        with np.errstate(over="ignore"):
            prod = ids.astype(np.uint32)[..., None] * mults
        mixed = prod ^ (prod >> np.uint32(16))
        hashed = (mixed % num_buckets).astype(np.int64)
        vecs = buckets[hashed]  # (..., num_hashes, hidden)
        if etype == "hash":
            weights = p["word_embed/importance/embedding"][ids]
            return np.einsum("...hf,...h->...f", vecs, weights)
        return vecs.sum(axis=-2)

    def _layer(self, idx: int, hidden: np.ndarray, bias4: np.ndarray):
        cfg, p = self.config, self.params
        eps = cfg.get("layer_norm_eps", 1e-12)
        heads = cfg["num_attention_heads"]
        head_dim = cfg["hidden_size"] // heads
        pre = f"layer_{idx}"

        def dense_general(name, x):  # (b, s, h) -> (b, s, heads, hd)
            kernel = p[f"{pre}/{name}/kernel"]  # (h, heads, hd)
            bias = p[f"{pre}/{name}/bias"]  # (heads, hd)
            return np.einsum("bsh,hnd->bsnd", x, kernel) + bias

        q = dense_general("query", hidden)
        k = dense_general("key", hidden)
        v = dense_general("value", hidden)
        scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(head_dim)
        probs = _softmax(scores + bias4)
        context = np.einsum("bhqk,bkhd->bqhd", probs, v)
        attn_out = (
            np.einsum("bqnd,ndh->bqh", context, p[f"{pre}/attn_out/kernel"])
            + p[f"{pre}/attn_out/bias"]
        )
        hidden = _layer_norm(
            hidden + attn_out,
            p[f"{pre}/attn_norm/scale"],
            p[f"{pre}/attn_norm/bias"],
            eps,
        )
        ffn = hidden @ p[f"{pre}/ffn_in/kernel"] + p[f"{pre}/ffn_in/bias"]
        ffn = _act(cfg.get("hidden_act", "gelu"))(ffn)
        ffn = ffn @ p[f"{pre}/ffn_out/kernel"] + p[f"{pre}/ffn_out/bias"]
        return _layer_norm(
            hidden + ffn,
            p[f"{pre}/ffn_norm/scale"],
            p[f"{pre}/ffn_norm/bias"],
            eps,
        )

    def encode(self, token_ids: np.ndarray) -> np.ndarray:
        """(batch, seq) int token ids -> (batch, hidden) f32 embeddings."""
        cfg, p = self.config, self.params
        ids = np.asarray(token_ids)
        mask = ids != 0  # PAD_ID == 0
        hidden = self._word_embed(ids)
        hidden = hidden + p["position_embed/embedding"][: ids.shape[-1]]
        hidden = _layer_norm(
            hidden,
            p["embed_norm/scale"],
            p["embed_norm/bias"],
            cfg.get("layer_norm_eps", 1e-12),
        )
        bias4 = np.where(mask, 0.0, -1e9).astype(np.float32)[
            :, None, None, :
        ]
        for idx in range(cfg["num_hidden_layers"]):
            hidden = self._layer(idx, hidden, bias4)
        pooled = self._pool(hidden, mask)
        if cfg.get("normalize", True):
            sq = np.sum(pooled * pooled, axis=-1, keepdims=True)
            pooled = np.where(sq < 1e-24, 0.0, pooled)
            pooled = pooled / np.sqrt(np.maximum(sq, 1e-24))
        return pooled.astype(np.float32)

    def _pool(self, hidden: np.ndarray, mask: np.ndarray) -> np.ndarray:
        cfg, p = self.config, self.params
        mode = cfg.get("pooling_mode", "mean")
        if mode == "cls":
            return hidden[:, 0]
        if mode == "pooler":
            return np.tanh(
                hidden[:, 0] @ p["pooler/kernel"] + p["pooler/bias"]
            )
        if mode == "max":
            return np.max(np.where(mask[..., None], hidden, -1e9), axis=1)
        weights = mask[..., None].astype(hidden.dtype)
        total = (hidden * weights).sum(axis=1)
        count = np.maximum(weights.sum(axis=1), 1e-9)
        return total / count

    def embed(self, texts: list[str]) -> np.ndarray:
        """Raw texts -> unit embeddings (tokenize + encode, numpy only)."""
        if self.tokenizer is None:
            msg = (
                "artifact uses a corpus-trained vocab tokenizer; pass "
                "token ids to encode() instead"
            )
            raise ValueError(msg)
        return self.encode(np.asarray(self.tokenizer.encode_batch(texts)))
