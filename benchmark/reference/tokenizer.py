"""Frozen hashing tokenizer: texts -> (n, max_length) int32 token ids.

A copy of the rule the recommender's hashing tokenizer states: lowercase,
tokens by the regex `[a-z0-9]+(?:'[a-z]+)?`, id 1 (CLS) first, each token
at 2 + its 64-bit FNV-1a hash (offset basis xor-folded with the first
hash seed) modulo vocab_size - 2, id 0 (PAD) after the last, cut at
max_length.
"""

from __future__ import annotations

import re

import numpy as np

PAD_ID = 0
CLS_ID = 1
NUM_RESERVED = 2

_TOKEN_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?")
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1
_SEED = 0x9E3779B97F4A7C15


def token_id(token: str, vocab_size: int) -> int:
    h = _FNV_OFFSET ^ _SEED
    for byte in token.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return NUM_RESERVED + h % (vocab_size - NUM_RESERVED)


def encode(texts: list[str], vocab_size: int, max_length: int) -> np.ndarray:
    memo: dict[str, int] = {}
    lengths = np.empty(len(texts), np.int64)
    flat: list[int] = []
    for row, text in enumerate(texts):
        tokens = _TOKEN_RE.findall(text.lower())[: max_length - 1]
        for token in tokens:
            tid = memo.get(token)
            if tid is None:
                tid = memo[token] = token_id(token, vocab_size)
            flat.append(tid)
        lengths[row] = len(tokens)
    out = np.zeros((len(texts), max_length), np.int32)
    out[:, 0] = CLS_ID
    filled = np.arange(max_length - 1)[None, :] < lengths[:, None]
    out[:, 1:][filled] = np.asarray(flat, np.int32)
    return out
