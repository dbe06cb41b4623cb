"""Recommendation service: the endpoints + stdlib HTTP server.

Port of `xfmr_rec_tpu/serving/service.py`. The endpoints keep the
reference's names, arguments and JSON shapes: embed_query, search_items,
recommend_with_query, item_id, process_item, recommend_with_item,
recommend_with_item_id, user_id, process_user, recommend_with_user,
recommend_with_user_id (the user's history and target items excluded;
the query vector from the model's user tower, searched as it is),
search_items_text, search_users_text (BM25 keyword search), add_items
(live catalog growth, refused with 403 unless the service was started
with `allow_catalog_mutation=True`), model_name, model_version, plus
GET /healthz and /metrics.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from xfmr_rec_torch.params import MODEL_NAME, TOP_K
from xfmr_rec_torch.serving.engine import RecommenderEngine
from xfmr_rec_torch.serving.schemas import (
    ItemCandidate,
    ItemQuery,
    NotFoundError,
    Query,
    UserQuery,
)

logger = logging.getLogger(__name__)


class RecService:
    def __init__(
        self,
        engine: RecommenderEngine,
        model_version_str: str = "latest",
        *,
        micro_batch: int | None = None,
        micro_batch_wait_ms: float = 5.0,
        allow_catalog_mutation: bool = False,
    ) -> None:
        """`micro_batch`: when set, concurrent text-query searches
        coalesce into batched dispatches of up to this size; queries
        carrying an embedding bypass the batcher.
        `allow_catalog_mutation`: expose `add_items`, which lets any
        client of the port grow the catalog (off: it answers 403)."""
        self.engine = engine
        self._version = model_version_str
        self.allow_catalog_mutation = allow_catalog_mutation
        self.batcher = None
        if micro_batch:
            from xfmr_rec_torch.serving.batching import MicroBatcher

            self.batcher = MicroBatcher(
                engine, max_batch=micro_batch, max_wait_ms=micro_batch_wait_ms
            )

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()

    # -- embedding / search -------------------------------------------
    def embed_query(self, query: Query) -> Query:
        return self.engine.embed_query(query)

    def search_items(
        self,
        query: Query,
        exclude_item_ids: list[int] | None = None,
        top_k: int = TOP_K,
    ) -> list[ItemCandidate]:
        if self.batcher is not None and query.embedding is None:
            return self.batcher.search_items(
                query.text, exclude_item_ids=exclude_item_ids, top_k=top_k
            )
        return self.engine.search_items(
            query, exclude_item_ids=exclude_item_ids or [], top_k=top_k
        )

    def recommend_with_query(
        self,
        query: Query,
        exclude_item_ids: list[int] | None = None,
        top_k: int = TOP_K,
    ) -> list[ItemCandidate]:
        if self.batcher is not None and query.embedding is None:
            return self.batcher.search_items(
                query.text, exclude_item_ids=exclude_item_ids, top_k=top_k
            )
        query = self.embed_query(query)
        return self.search_items(
            query, exclude_item_ids=exclude_item_ids, top_k=top_k
        )

    # -- items ---------------------------------------------------------
    def item_id(self, item_id: int) -> ItemQuery:
        return self.engine.get_item(item_id)

    def process_item(self, item: ItemQuery) -> Query:
        return self.engine.process_item(item)

    def add_items(self, items: list[dict] | list[ItemQuery]) -> dict:
        """Append items to the live catalog in one batch (ids must be
        new): {"added", "num_items"}."""
        if not self.allow_catalog_mutation:
            msg = (
                "add_items is disabled: start the service with "
                "allow_catalog_mutation=True (--allow-catalog-mutation) "
                "to expose live catalog mutation"
            )
            raise PermissionError(msg)
        added = self.engine.add_items([ItemQuery.from_dict(i) for i in items])
        return {"added": added, "num_items": len(self.engine.index)}

    def recommend_with_item(
        self,
        item: ItemQuery,
        exclude_item_ids: list[int] | None = None,
        top_k: int = TOP_K,
    ) -> list[ItemCandidate]:
        if item.movie_id:
            exclude_item_ids = [*(exclude_item_ids or []), item.movie_id]
        query = self.process_item(item)
        return self.recommend_with_query(
            query, exclude_item_ids=exclude_item_ids, top_k=top_k
        )

    def recommend_with_item_id(
        self,
        item_id: int,
        exclude_item_ids: list[int] | None = None,
        top_k: int = TOP_K,
    ) -> list[ItemCandidate]:
        item = self.item_id(item_id)
        return self.recommend_with_item(
            item, exclude_item_ids=exclude_item_ids, top_k=top_k
        )

    # -- users ---------------------------------------------------------
    def user_id(self, user_id: int) -> UserQuery:
        return self.engine.get_user(user_id)

    def process_user(self, user: UserQuery) -> Query:
        return self.engine.process_user(user)

    def recommend_with_user(
        self,
        user: UserQuery,
        exclude_item_ids: list[int] | None = None,
        top_k: int = TOP_K,
    ) -> list[ItemCandidate]:
        exclude_item_ids = list(exclude_item_ids or [])
        for activity in (user.history or []) + (user.target or []):
            exclude_item_ids.append(activity.movie_id)
        # the model's own user tower (text, or the history fusion),
        # searched as it is: the reference passes it to
        # recommend_with_query, which embeds the profile text again and
        # drops the fused vector (ROADMAP.md, Queue 3)
        query = self.engine.embed_user_query(user)
        return self.search_items(
            query, exclude_item_ids=exclude_item_ids, top_k=top_k
        )

    def recommend_with_user_id(
        self,
        user_id: int,
        exclude_item_ids: list[int] | None = None,
        top_k: int = TOP_K,
    ) -> list[ItemCandidate]:
        user = self.user_id(user_id)
        return self.recommend_with_user(
            user, exclude_item_ids=exclude_item_ids, top_k=top_k
        )

    # -- keyword search ------------------------------------------------
    def search_items_text(self, query: str, top_k: int = 10) -> list[dict]:
        return self.engine.search_items_text(query, top_k=top_k)

    def search_users_text(self, query: str, top_k: int = 10) -> list[dict]:
        return self.engine.search_users_text(query, top_k=top_k)

    # -- meta ----------------------------------------------------------
    def model_name(self) -> str:
        return MODEL_NAME

    def model_version(self) -> str:
        return self._version


class RequestMetrics:
    """Per-endpoint request counters + latency histograms, rendered in
    the Prometheus text format at GET /metrics."""

    BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._requests: dict[tuple[str, int], int] = {}
        self._buckets: dict[str, list[int]] = {}
        self._sum: dict[str, float] = {}

    def observe(self, endpoint: str, status: int, seconds: float) -> None:
        with self._lock:
            key = (endpoint, status)
            self._requests[key] = self._requests.get(key, 0) + 1
            buckets = self._buckets.setdefault(
                endpoint, [0] * (len(self.BUCKETS) + 1)
            )
            for i, bound in enumerate(self.BUCKETS):
                if seconds <= bound:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            self._sum[endpoint] = self._sum.get(endpoint, 0.0) + seconds

    def render(self) -> str:
        lines = [
            "# HELP http_requests_total Requests served, by endpoint/status.",
            "# TYPE http_requests_total counter",
        ]
        with self._lock:
            for (endpoint, status), count in sorted(self._requests.items()):
                lines.append(
                    f'http_requests_total{{endpoint="{endpoint}",'
                    f'status="{status}"}} {count}'
                )
            lines += [
                "# HELP http_request_duration_seconds Request latency.",
                "# TYPE http_request_duration_seconds histogram",
            ]
            for endpoint, buckets in sorted(self._buckets.items()):
                cumulative = 0
                for bound, count in zip(self.BUCKETS, buckets, strict=False):
                    cumulative += count
                    lines.append(
                        f'http_request_duration_seconds_bucket{{endpoint='
                        f'"{endpoint}",le="{bound}"}} {cumulative}'
                    )
                cumulative += buckets[-1]
                lines.append(
                    f'http_request_duration_seconds_bucket{{endpoint='
                    f'"{endpoint}",le="+Inf"}} {cumulative}'
                )
                lines.append(
                    f'http_request_duration_seconds_sum{{endpoint='
                    f'"{endpoint}"}} {self._sum[endpoint]:.6f}'
                )
                lines.append(
                    f'http_request_duration_seconds_count{{endpoint='
                    f'"{endpoint}"}} {cumulative}'
                )
        return "\n".join(lines) + "\n"


# endpoint -> ((argument, parser or None), ...)
_ENDPOINTS = {
    "embed_query": (("query", Query.from_dict),),
    "search_items": (
        ("query", Query.from_dict),
        ("exclude_item_ids", None),
        ("top_k", None),
    ),
    "recommend_with_query": (
        ("query", Query.from_dict),
        ("exclude_item_ids", None),
        ("top_k", None),
    ),
    "item_id": (("item_id", None),),
    "process_item": (("item", ItemQuery.from_dict),),
    "add_items": (("items", None),),
    "recommend_with_item": (
        ("item", ItemQuery.from_dict),
        ("exclude_item_ids", None),
        ("top_k", None),
    ),
    "recommend_with_item_id": (
        ("item_id", None),
        ("exclude_item_ids", None),
        ("top_k", None),
    ),
    "user_id": (("user_id", None),),
    "process_user": (("user", UserQuery.from_dict),),
    "recommend_with_user": (
        ("user", UserQuery.from_dict),
        ("exclude_item_ids", None),
        ("top_k", None),
    ),
    "recommend_with_user_id": (
        ("user_id", None),
        ("exclude_item_ids", None),
        ("top_k", None),
    ),
    "search_items_text": (("query", None), ("top_k", None)),
    "search_users_text": (("query", None), ("top_k", None)),
    "model_name": (),
    "model_version": (),
}


class UnknownEndpointError(KeyError):
    """A path outside the endpoint table (404), as opposed to a KeyError
    raised inside a service method (500)."""


def dispatch(service: RecService, endpoint: str, payload: dict) -> Any:
    """Route one JSON request body to a service method."""
    if endpoint not in _ENDPOINTS:
        msg = f"unknown endpoint: {endpoint}"
        raise UnknownEndpointError(msg)
    kwargs = {}
    for name, parse in _ENDPOINTS[endpoint]:
        if name in payload:
            value = payload[name]
            kwargs[name] = parse(value) if parse is not None else value
    return _serialize(getattr(service, endpoint)(**kwargs))


def _serialize(result: Any) -> Any:
    if isinstance(result, list):
        return [_serialize(x) for x in result]
    if dataclasses.is_dataclass(result):
        return dataclasses.asdict(result)
    return result


class _Handler(BaseHTTPRequestHandler):
    service: RecService  # set by make_server
    metrics: RequestMetrics  # set by make_server

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b"{}"
        endpoint = self.path.strip("/")
        start = time.perf_counter()
        try:
            payload = json.loads(body or b"{}")
            status, response = 200, dispatch(self.service, endpoint, payload)
        except UnknownEndpointError:
            status = 404
            response = {"error": f"unknown endpoint {endpoint}"}
        except NotFoundError as exc:
            status, response = 404, {"error": str(exc)}
        except PermissionError as exc:
            # a disabled admin endpoint is the client's error, not a 500
            status, response = 403, {"error": str(exc)}
        except Exception as exc:  # noqa: BLE001 - request error boundary
            status = 500
            logger.exception("error handling %s", endpoint)
            response = {"error": f"{type(exc).__name__}: {exc}"}
        label = endpoint if endpoint in _ENDPOINTS else "_unknown"
        # record before replying: a client holding the reply may read
        # /metrics next and must see this request counted
        self.metrics.observe(label, status, time.perf_counter() - start)
        self._reply(status, response)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0].strip("/")
        if path == "metrics":
            text = self.metrics.render()
            batcher = self.service.batcher
            if batcher is not None:
                text += (
                    "# TYPE microbatch_requests_total counter\n"
                    f"microbatch_requests_total {batcher.requests_served}\n"
                    "# TYPE microbatch_dispatches_total counter\n"
                    "microbatch_dispatches_total "
                    f"{batcher.batches_dispatched}\n"
                )
            data = text.encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif path in ("healthz", "livez", "readyz"):
            self._reply(200, {"status": "ok"})
        else:
            self._reply(404, {"error": f"unknown endpoint {path}"})

    def _reply(self, status: int, payload: Any) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug(fmt, *args)


class _Server(ThreadingHTTPServer):
    # the socketserver default backlog of 5 resets connections in a burst
    # of concurrent clients, which is what the micro-batcher is for
    request_queue_size = 128
    daemon_threads = True


def make_server(
    service: RecService, host: str = "127.0.0.1", port: int = 8000
) -> ThreadingHTTPServer:
    handler = type(
        "BoundHandler",
        (_Handler,),
        {"service": service, "metrics": RequestMetrics()},
    )
    return _Server((host, port), handler)


def serve_forever(
    service: RecService, host: str = "0.0.0.0", port: int = 8000  # noqa: S104
) -> None:
    """Serve `service` over HTTP until interrupted."""
    with make_server(service, host, port) as server:
        logger.info("serving on %s:%d", host, port)
        server.serve_forever()
