"""ctypes binding and marshalling for the C++ BM25 index (`bm25.cpp`).

`NativeBM25` owns one immutable index handle; searches only read it and
may run from several threads. The text is lowercased here with
`str.lower()` before it is encoded, and the mean document length is
computed here from the lengths the library reports, both as the Python
oracle (`index.mips.BM25Index(native=False)`) does, so the two return the
same rows and scores. The library is built at first use (`native.build`).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from xfmr_rec_torch import native
from xfmr_rec_torch.native.tokenizer_native import pack

_ABI_VERSION = 2

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = native.load("bm25.cpp")
            lib.bm25_abi_version.argtypes = []
            lib.bm25_abi_version.restype = ctypes.c_int32
            if lib.bm25_abi_version() != _ABI_VERSION:
                msg = "BM25 library ABI mismatch"
                raise RuntimeError(msg)
            lib.bm25_create.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ]
            lib.bm25_create.restype = ctypes.c_void_p
            lib.bm25_destroy.argtypes = [ctypes.c_void_p]
            lib.bm25_destroy.restype = None
            lib.bm25_search.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.c_double,
                ctypes.c_int32,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ]
            lib.bm25_search.restype = ctypes.c_int32
            _lib = lib
    return _lib


class NativeBM25:
    """Immutable native BM25 index over a list of document strings."""

    def __init__(self, docs: list[str]) -> None:
        self._lib = _load()
        blob, offsets = pack(docs, lowercase=True)
        self.doc_lens = np.zeros(len(docs), dtype=np.float32)
        self._handle = self._lib.bm25_create(
            blob, offsets, len(docs), self.doc_lens
        )
        if not self._handle:
            msg = "bm25_create returned NULL"
            raise RuntimeError(msg)
        # the oracle's mean: float32 over the float32 lengths
        self.avg_len = float(self.doc_lens.mean()) if len(docs) else 1.0

    def search(self, query: str, top_k: int = 10) -> list[tuple[int, float]]:
        rows = np.zeros(max(top_k, 1), dtype=np.int32)
        scores = np.zeros(max(top_k, 1), dtype=np.float32)
        raw = query.lower().encode("utf-8", "surrogatepass")
        count = self._lib.bm25_search(
            self._handle, raw, len(raw), self.avg_len, top_k, rows, scores
        )
        return [(int(rows[i]), float(scores[i])) for i in range(count)]

    def __del__(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.bm25_destroy(self._handle)
            self._handle = None
