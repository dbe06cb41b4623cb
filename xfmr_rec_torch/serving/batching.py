"""Adaptive request micro-batching for the serving hot path.

Port of `xfmr_rec_tpu/serving/batching.py`: concurrent search requests
enqueue into a `MicroBatcher`; a collector thread drains up to
`max_batch` of them (waiting at most `max_wait_ms` after the first) and
serves them with ONE batched tokenize -> encode -> exclusion-search
dispatch. Batches are padded to powers of two (padding rows repeat the
first request's query); per-request top_k values are served from one
search at max(top_k) and sliced. The search goes through the engine's
index kind (`RecommenderEngine.search_vectors`: exact, IVF, or the
certified IVF probe); the reference's batcher always searches the exact
index, so its IVF engine answers a batched request exhaustively.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from xfmr_rec_torch.serving.schemas import ItemCandidate

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    text: str
    exclude_item_ids: list[int]
    top_k: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Exception | None = None


def _round_up_pow2(value: int, floor: int = 1) -> int:
    value = max(value, floor)
    return 1 << (value - 1).bit_length()


class MicroBatcher:
    """Coalesces concurrent item-search requests into batched dispatches."""

    def __init__(
        self,
        engine,
        *,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
    ) -> None:
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._closed = False
        # any request accepted under the lock is enqueued before close()'s
        # None sentinel, so the worker serves it or the drain fails it
        self._submit_lock = threading.Lock()
        self.requests_served = 0
        self.batches_dispatched = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def search_items(
        self,
        text: str,
        *,
        exclude_item_ids: list[int] | None = None,
        top_k: int,
    ) -> list[ItemCandidate]:
        """Blocking per-request call; batched under the hood."""
        request = _Request(text, list(exclude_item_ids or []), top_k)
        with self._submit_lock:
            if self._closed:
                msg = "MicroBatcher is closed"
                raise RuntimeError(msg)
            self._queue.put(request)
        request.done.wait()
        if request.error is not None:
            raise request.error
        return request.result

    def close(self, timeout: float | None = None) -> None:
        with self._submit_lock:
            self._closed = True
            self._queue.put(None)  # wake the worker
        self._worker.join(timeout)

    def _collect(self) -> list[_Request]:
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        end = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = end - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while not self._closed:
            batch = self._collect()
            if not batch:
                continue
            try:
                self._dispatch(batch)
            except Exception as exc:  # noqa: BLE001 - per-batch boundary
                logger.exception("micro-batch dispatch failed")
                for request in batch:
                    if not request.done.is_set():
                        request.error = exc
                        request.done.set()
        # fail whatever is still queued so no caller waits forever
        while True:
            try:
                request = self._queue.get_nowait()
            except queue.Empty:
                return
            if request is not None:
                request.error = RuntimeError("MicroBatcher is closed")
                request.done.set()

    def _dispatch(self, batch: list[_Request]) -> None:
        engine = self.engine
        texts = [r.text for r in batch]
        k_max = max(r.top_k for r in batch)
        width = min(_round_up_pow2(len(batch)), self.max_batch)
        while len(texts) < width:
            texts.append(batch[0].text)
        excl = [r.exclude_item_ids for r in batch]
        excl += [[] for _ in range(width - len(batch))]
        embeds = engine.embed(texts)
        scores, item_ids = engine.search_vectors(embeds, excl, k_max)
        for row, request in enumerate(batch):
            request.result = engine._candidates(
                scores[row][: request.top_k], item_ids[row][: request.top_k]
            )
            request.done.set()
        self.requests_served += len(batch)
        self.batches_dispatched += 1
