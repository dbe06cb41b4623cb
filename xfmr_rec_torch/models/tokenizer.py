"""Hashing and vocab tokenizers: text -> fixed-shape token-id arrays.

Own copy of the pure-Python path of `xfmr_rec_tpu/models/tokenizer.py`:
the same regex, the same signed-seed 64-bit FNV-1a, the same reserved
ids and the same corpus-frequency vocab (`build_vocab`), so both
packages give identical id arrays for the same text. The config is a
dataclass with the reference's field names and defaults.

`encode_batch` runs the C++ tokenizer (`native/tokenizer.cpp`, built at
first use) where it builds; the Python path is its oracle, and the two
give the same ids on every input. `native=None` (the default) falls
back to the Python path, with one logged warning, where the library
cannot be built (no `g++`); `native=True` raises there; `native=False`
runs the Python path. `encode` (one text) stays Python.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import re

import numpy as np

from xfmr_rec_torch import native as native_lib
from xfmr_rec_torch.native import tokenizer_native

# Reserved token ids. PAD must be 0: attention masks and pooling treat
# id 0 as padding.
PAD_ID = 0
CLS_ID = 1
NUM_RESERVED = 2

_TOKEN_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?")

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1
# Distinct per-hash-function seeds (arbitrary odd 64-bit constants).
_HASH_SEEDS = (
    0x9E3779B97F4A7C15,
    0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9,
    0x27D4EB2F165667C5,
    0x85EBCA77C2B2AE63,
    0x2545F4914F6CDD1D,
    0xFF51AFD7ED558CCD,
    0xC4CEB9FE1A85EC53,
)


def fnv1a_64(token: str, seed: int = 0) -> int:
    """64-bit FNV-1a over the UTF-8 bytes, xor-folded with a seed."""
    h = _FNV_OFFSET ^ seed
    for byte in token.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return h


def build_vocab(
    texts: list[str],
    *,
    vocab_size: int,
    oov_buckets: int,
    lowercase: bool = True,
) -> list[str]:
    """Corpus-frequency vocab: all corpus tokens ranked by count (ties
    lexicographic), the top `vocab_size - NUM_RESERVED - oov_buckets`."""
    counts: collections.Counter[str] = collections.Counter()
    for text in texts:
        counts.update(_tokenize(text, lowercase))
    keep = max(vocab_size - NUM_RESERVED - oov_buckets, 0)
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    return [token for token, _ in ranked[:keep]]


@dataclasses.dataclass
class TokenizerConfig:
    vocab_size: int = 30522
    max_length: int = 64
    num_hashes: int = 1
    lowercase: bool = True
    add_cls: bool = True


def _tokenize(text: str, lowercase: bool) -> list[str]:
    if lowercase:
        text = text.lower()
    return _TOKEN_RE.findall(text)


class HashingTokenizer:
    """Stateless feature-hashing tokenizer producing fixed-shape batches."""

    def __init__(self, config: TokenizerConfig | None = None, **kwargs) -> None:
        self.config = config if config is not None else TokenizerConfig(**kwargs)
        if self.config.num_hashes > len(_HASH_SEEDS):
            msg = f"num_hashes must be <= {len(_HASH_SEEDS)}"
            raise ValueError(msg)

    def tokenize(self, text: str) -> list[str]:
        return _tokenize(text, self.config.lowercase)

    def token_ids(self, token: str) -> list[int]:
        """`num_hashes` independent ids in [NUM_RESERVED, vocab_size)."""
        space = self.config.vocab_size - NUM_RESERVED
        return [
            NUM_RESERVED + fnv1a_64(token, _HASH_SEEDS[i]) % space
            for i in range(self.config.num_hashes)
        ]

    def encode(self, text: str, max_length: int | None = None) -> np.ndarray:
        """One text -> (max_length, num_hashes) int32, 0-padded."""
        max_length = max_length or self.config.max_length
        out = np.zeros((max_length, self.config.num_hashes), dtype=np.int32)
        pos = 0
        if self.config.add_cls:
            out[0, :] = CLS_ID
            pos = 1
        for token in self.tokenize(text):
            if pos >= max_length:
                break
            out[pos, :] = self.token_ids(token)
            pos += 1
        return out

    def encode_batch(
        self,
        texts: list[str],
        max_length: int | None = None,
        *,
        native: bool | None = None,
    ) -> np.ndarray:
        """Texts -> (batch, max_length, num_hashes) int32 (squeezed to
        (batch, max_length) when num_hashes == 1); `native` as in the
        module docstring."""
        cfg = self.config
        max_length = max_length or cfg.max_length
        if native_lib.choose(native, tokenizer_native.load, "tokenizer"):
            out = tokenizer_native.encode_batch(
                texts,
                max_length=max_length,
                num_hashes=cfg.num_hashes,
                vocab_size=cfg.vocab_size,
                lowercase=cfg.lowercase,
                add_cls=cfg.add_cls,
            )
        else:
            out = np.zeros(
                (len(texts), max_length, cfg.num_hashes), dtype=np.int32
            )
            for i, text in enumerate(texts):
                out[i] = self.encode(text, max_length)
        if self.config.num_hashes == 1:
            return out[..., 0]
        return out

    def __call__(self, texts: list[str]) -> np.ndarray:
        return self.encode_batch(texts)


class VocabTokenizer:
    """Corpus-trained vocab tokenizer with hashed OOV buckets.

    Ids: PAD=0, CLS=1, vocab tokens at NUM_RESERVED + rank, out-of-vocab
    tokens FNV-hashed into the trailing `oov_buckets` ids.
    """

    def __init__(
        self,
        vocab: list[str],
        config: TokenizerConfig | None = None,
        **kwargs,
    ) -> None:
        self.config = config if config is not None else TokenizerConfig(**kwargs)
        if self.config.num_hashes != 1:
            msg = "VocabTokenizer supports num_hashes=1 only"
            raise ValueError(msg)
        if NUM_RESERVED + len(vocab) >= self.config.vocab_size:
            msg = (
                f"vocab of {len(vocab)} tokens leaves no OOV buckets in "
                f"vocab_size={self.config.vocab_size}"
            )
            raise ValueError(msg)
        self.vocab = list(vocab)
        self._ids = {
            token: NUM_RESERVED + rank for rank, token in enumerate(vocab)
        }
        self.oov_start = NUM_RESERVED + len(vocab)
        self.oov_buckets = self.config.vocab_size - self.oov_start
        self._native: tokenizer_native.VocabHandle | None = None

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(
            json.dumps(
                {"vocab": self.vocab, "config": dataclasses.asdict(self.config)}
            )
        )

    @classmethod
    def load(cls, path: str | pathlib.Path) -> VocabTokenizer:
        payload = json.loads(pathlib.Path(path).read_text())
        return cls(payload["vocab"], TokenizerConfig(**payload["config"]))

    def tokenize(self, text: str) -> list[str]:
        return _tokenize(text, self.config.lowercase)

    def token_id(self, token: str) -> int:
        known = self._ids.get(token)
        if known is not None:
            return known
        return self.oov_start + fnv1a_64(token, _HASH_SEEDS[0]) % self.oov_buckets

    def encode(self, text: str, max_length: int | None = None) -> np.ndarray:
        max_length = max_length or self.config.max_length
        out = np.zeros(max_length, dtype=np.int32)
        pos = 0
        if self.config.add_cls:
            out[0] = CLS_ID
            pos = 1
        for token in self.tokenize(text):
            if pos >= max_length:
                break
            out[pos] = self.token_id(token)
            pos += 1
        return out

    def encode_batch(
        self,
        texts: list[str],
        max_length: int | None = None,
        *,
        native: bool | None = None,
    ) -> np.ndarray:
        """Texts -> (batch, max_length) int32, 0-padded; `native` as in
        the module docstring."""
        max_length = max_length or self.config.max_length
        if native_lib.choose(native, tokenizer_native.load, "tokenizer"):
            if self._native is None:
                # the token -> id map is built once, at first use
                self._native = tokenizer_native.VocabHandle(self.vocab)
            return self._native.encode_batch(
                texts,
                max_length=max_length,
                oov_start=self.oov_start,
                oov_buckets=self.oov_buckets,
                lowercase=self.config.lowercase,
                add_cls=self.config.add_cls,
            )
        out = np.zeros((len(texts), max_length), dtype=np.int32)
        for i, text in enumerate(texts):
            out[i] = self.encode(text, max_length)
        return out

    def __call__(self, texts: list[str]) -> np.ndarray:
        return self.encode_batch(texts)
