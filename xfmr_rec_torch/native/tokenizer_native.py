"""ctypes binding and marshalling for the C++ batch tokenizers
(`tokenizer.cpp`).

The text is lowercased here with `str.lower()` (when the config asks for
it) before it is encoded to UTF-8, so the ids equal the pure-Python
tokenizer's on every input; see `tokenizer.cpp`. The library is built at
first use (`native.build`).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from xfmr_rec_torch import native

_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_OFFSETS = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_OUT = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_ABI_VERSION = 3

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = native.load("tokenizer.cpp")
            lib.tokenizer_abi_version.argtypes = []
            lib.tokenizer_abi_version.restype = _I32
            if lib.tokenizer_abi_version() != _ABI_VERSION:
                msg = "tokenizer library ABI mismatch"
                raise RuntimeError(msg)
            lib.encode_batch.argtypes = [
                ctypes.c_char_p, _OFFSETS, _I64,  # texts, offsets, n
                _I32, _I32, _I32, _I32,  # max_length, hashes, vocab, cls
                _OUT,
            ]
            lib.encode_batch.restype = None
            lib.vocab_create.argtypes = [ctypes.c_char_p, _OFFSETS, _I64]
            lib.vocab_create.restype = ctypes.c_void_p
            lib.vocab_destroy.argtypes = [ctypes.c_void_p]
            lib.vocab_destroy.restype = None
            lib.vocab_encode_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, _OFFSETS, _I64,
                _I32, _I32, _I32, _I32,  # max_length, oov start/buckets, cls
                _OUT,
            ]
            lib.vocab_encode_batch.restype = None
            _lib = lib
    return _lib


def pack(strings: list[str], lowercase: bool) -> tuple[bytes, np.ndarray]:
    """One UTF-8 blob (lowercased with `str.lower()` when asked) and its
    n + 1 int64 byte offsets. A lone surrogate passes through as its
    three bytes, which, like every non-ASCII byte, match no token."""
    encoded = [
        (s.lower() if lowercase else s).encode("utf-8", "surrogatepass")
        for s in strings
    ]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def encode_batch(
    texts: list[str],
    *,
    max_length: int,
    num_hashes: int,
    vocab_size: int,
    lowercase: bool,
    add_cls: bool,
) -> np.ndarray:
    """Texts -> (n, max_length, num_hashes) int32, 0-padded."""
    lib = _load()
    blob, offsets = pack(texts, lowercase)
    out = np.zeros((len(texts), max_length, num_hashes), dtype=np.int32)
    lib.encode_batch(blob, offsets, len(texts), max_length, num_hashes,
                     vocab_size, int(add_cls), out)
    return out


class VocabHandle:
    """Owns a native token -> id map; freed with the object."""

    def __init__(self, vocab: list[str]) -> None:
        self._lib = _load()
        blob, offsets = pack(vocab, lowercase=False)
        self._ptr = self._lib.vocab_create(blob, offsets, len(vocab))

    def encode_batch(
        self,
        texts: list[str],
        *,
        max_length: int,
        oov_start: int,
        oov_buckets: int,
        lowercase: bool,
        add_cls: bool,
    ) -> np.ndarray:
        """Texts -> (n, max_length) int32, 0-padded."""
        blob, offsets = pack(texts, lowercase)
        out = np.zeros((len(texts), max_length), dtype=np.int32)
        self._lib.vocab_encode_batch(
            self._ptr, blob, offsets, len(texts), max_length, oov_start,
            oov_buckets, int(add_cls), out,
        )
        return out

    def __del__(self) -> None:
        if getattr(self, "_ptr", None):
            self._lib.vocab_destroy(self._ptr)
            self._ptr = None
