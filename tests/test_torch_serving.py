"""Port parity: the serving engine on a JAX-trained artifact.

The artifact is trained and saved by the JAX package exactly as
tests/test_serving.py does; only the copy's `index/index.json` is
rewritten to `"method": "scan"`, so both engines run the packed scan at
this small size, and its `users.parquet` is converted to the port's
`users.npz` with `UserStore.from_rows`. The port loads it without JAX
(portable.json + encoder.npz + index/ + users.npz) and must answer the
same ids. After the same `add_items` on both engines they still answer
the same ids, and the port's keyword search over items and users returns
the rows of the JAX package's Python BM25.
"""

import concurrent.futures
import json
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

from tests.test_serving import build_artifact
from xfmr_rec_torch.serving.batching import MicroBatcher
from xfmr_rec_torch.serving.engine import RecommenderEngine as PortEngine
from xfmr_rec_torch.serving.schemas import ItemQuery, NotFoundError, Query
from xfmr_rec_torch.serving.service import (
    RecService,
    dispatch,
    make_server,
)
from xfmr_rec_torch.serving.users import UserStore
from xfmr_rec_tpu.index.mips import BM25Index as RefBM25
from xfmr_rec_tpu.serving.engine import RecommenderEngine as RefEngine
from xfmr_rec_tpu.serving.schemas import ItemQuery as RefItemQuery
from xfmr_rec_tpu.serving.schemas import Query as RefQuery

TEXTS = ["comedy", "action thriller", "a quiet drama about family", ""]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    trained = build_artifact(tmp_path_factory)
    path = tmp_path_factory.mktemp("scan_artifact") / "model"
    shutil.copytree(trained, path)
    index_json = path / "index" / "index.json"
    meta = json.loads(index_json.read_text())
    meta["method"] = "scan"
    index_json.write_text(json.dumps(meta))
    UserStore.from_rows(
        pd.read_parquet(path / "users.parquet").to_dict("records")
    ).save(path / "users.npz")
    return path


@pytest.fixture(scope="module")
def engines(artifact):
    return RefEngine(artifact), PortEngine(artifact, device="cpu")


def test_port_runs_the_packed_scan(engines):
    _, port = engines
    assert port.index.method == "scan"


def test_embeddings_match(engines):
    ref, port = engines
    np.testing.assert_allclose(
        port.embed(TEXTS), ref.embed(TEXTS), atol=1e-5, rtol=1e-5
    )


@pytest.mark.parametrize("text", TEXTS)
def test_text_queries_same_ids(engines, text):
    ref, port = engines
    want = ref.search_items(RefQuery(text=text), top_k=10)
    got = port.search_items(Query(text=text), top_k=10)
    assert [c.movie_id for c in got] == [c.movie_id for c in want]
    np.testing.assert_allclose(
        [c.score for c in got], [c.score for c in want], atol=1e-4
    )


def test_item_queries_same_ids_with_exclusions(engines):
    ref, port = engines
    ids = [int(i) for i in port.index.ids[:5]]
    for item_id in ids:
        item = port.get_item(item_id)
        assert item.movie_text == ref.get_item(item_id).movie_text
        excl = [item_id, ids[0]]
        want = ref.search_items(
            ref.process_item(ref.get_item(item_id)),
            exclude_item_ids=excl, top_k=8,
        )
        got = port.search_items(
            port.process_item(item), exclude_item_ids=excl, top_k=8
        )
        assert [c.movie_id for c in got] == [c.movie_id for c in want]
        assert not set(excl) & {c.movie_id for c in got}


def test_unknown_item_raises(engines):
    _, port = engines
    with pytest.raises(NotFoundError):
        port.get_item(99999)


def test_microbatcher_burst_matches_engine(engines):
    _, port = engines
    batcher = MicroBatcher(port, max_batch=8, max_wait_ms=20)
    try:
        texts = [TEXTS[i % len(TEXTS)] for i in range(16)]
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            futures = [
                pool.submit(batcher.search_items, t, top_k=5) for t in texts
            ]
            results = [f.result(timeout=60) for f in futures]
    finally:
        batcher.close(timeout=10)
    assert not batcher._worker.is_alive()
    assert batcher.requests_served == 16
    assert batcher.batches_dispatched < 16
    # a batch shares one score bound (its largest query norm), and each
    # query is rounded to bf16 after scaling by 0.25/bound: a batched
    # query rounds differently, which moves scores by up to a bf16 step
    # (2^-8 of a unit score) and may swap items that close to the k-th
    for text, got in zip(texts, results, strict=True):
        want = port.search_items(Query(text=text), top_k=5)
        np.testing.assert_allclose(
            [c.score for c in got], [c.score for c in want], atol=4e-3
        )
        kth = want[-1].score
        firm = {c.movie_id for c in want if c.score > kth + 8e-3}
        assert firm <= {c.movie_id for c in got}


def test_dispatch_and_not_ported(artifact, engines):
    """Every endpoint dispatches; keyword search answers, add_items is
    refused without the gate, and the IVF and sharded index kinds build
    (the sharded one answers as the exact one on this artifact)."""
    _, port = engines
    service = RecService(port)
    out = dispatch(service, "recommend_with_query",
                   {"query": {"text": "comedy"}, "top_k": 3})
    assert len(out) == 3 and {"movie_id", "movie_text", "score"} <= set(out[0])
    assert dispatch(service, "model_name", {}) == "xfmr_rec_tpu"
    user_id = int(port.users.arrays["user_id"][0])
    assert dispatch(service, "user_id", {"user_id": user_id})[
        "user_id"] == user_id
    hits = dispatch(service, "search_items_text",
                    {"query": "drama", "top_k": 5})
    assert hits and {"movie_id", "movie_text", "score"} <= set(hits[0])
    with pytest.raises(PermissionError, match="allow_catalog_mutation"):
        dispatch(service, "add_items", {"items": []})
    assert PortEngine(artifact, index_kind="ivf", warmup=False,
                      device="cpu").ivf is not None
    sharded = PortEngine(artifact, index_kind="sharded", model_parallel=4,
                         device="cpu")
    out = dispatch(RecService(sharded), "recommend_with_query",
                   {"query": {"text": "comedy"}, "top_k": 3})
    want = dispatch(service, "recommend_with_query",
                    {"query": {"text": "comedy"}, "top_k": 3})
    # the same packed keys on two shards: scores within a key quantum
    np.testing.assert_allclose([r["score"] for r in out],
                               [r["score"] for r in want], atol=4e-3)


def test_text_search_matches_jax_oracle(engines):
    ref, port = engines
    items = RefBM25(ref.index.metadata, native=False)
    users = list(ref._users_by_id.values())
    user_fts = RefBM25(users, text_col="user_text", native=False)
    for query in ["comedy drama", "Savage storm", "1995", "F 25", "zzz", ""]:
        want = items.search(query, top_k=10)
        got = port.search_items_text(query, top_k=10)
        assert [g["movie_id"] for g in got] == [
            int(ref.index.ids[r]) for r, _ in want]
        np.testing.assert_allclose([g["score"] for g in got],
                                   [sc for _, sc in want], rtol=1e-5)
        want = user_fts.search(query, top_k=10)
        got = port.search_users_text(query, top_k=10)
        assert [(g["user_id"], g["user_text"]) for g in got] == [
            (int(users[r]["user_id"]), users[r]["user_text"])
            for r, _ in want]
        np.testing.assert_allclose([g["score"] for g in got],
                                   [sc for _, sc in want], rtol=1e-5)


NEW_ITEMS = [
    dict(movie_rn=0, movie_id=900000 + i,
         movie_text=f'{{"title": "Zebra Nights {i} (2031)", '
                    f'"genres": ["Comedy", "Zebra{i}"]}}')
    for i in range(3)
]


def test_add_items_same_answers_as_jax_engine(artifact):
    ref = RefEngine(artifact, warmup=False)
    port = PortEngine(artifact, device="cpu", warmup=False)
    assert ref.add_items([RefItemQuery(**i) for i in NEW_ITEMS]) == 3
    assert port.add_items([ItemQuery(**i) for i in NEW_ITEMS]) == 3
    np.testing.assert_array_equal(port.index.ids, ref.index.ids)
    assert port.index.method == ref.index.method == "scan"
    assert port.index._corpus_maxnorm == pytest.approx(
        ref.index._corpus_maxnorm, rel=1e-6)
    texts = TEXTS + [i["movie_text"] for i in NEW_ITEMS]
    for text in texts:
        want = ref.search_items(RefQuery(text=text), top_k=10)
        got = port.search_items(Query(text=text), top_k=10)
        assert [c.movie_id for c in got] == [c.movie_id for c in want]
        np.testing.assert_allclose(
            [c.score for c in got], [c.score for c in want], atol=1e-4)
    for item in NEW_ITEMS:
        got = port.search_items(Query(text=item["movie_text"]), top_k=10)
        assert item["movie_id"] in [c.movie_id for c in got]
        assert port.get_item(item["movie_id"]).movie_text == item["movie_text"]
    hits = port.search_items_text("zebra1", top_k=3)
    assert [h["movie_id"] for h in hits] == [900001]


def test_http_round_trip(engines):
    ref, port = engines
    service = RecService(port)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(endpoint, payload):
        req = urllib.request.Request(
            f"{base}/{endpoint}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    try:
        item_id = int(port.index.ids[3])
        status, body = post(
            "recommend_with_item_id", {"item_id": item_id, "top_k": 4}
        )
        assert status == 200
        want = ref.search_items(
            ref.process_item(ref.get_item(item_id)),
            exclude_item_ids=[item_id], top_k=4,
        )
        assert [c["movie_id"] for c in body] == [c.movie_id for c in want]
        assert post("item_id", {"item_id": item_id})[0] == 200
        assert post("item_id", {"item_id": 99999})[0] == 404
        user_id = int(port.users.arrays["user_id"][2])
        status, body = post("recommend_with_user_id",
                            {"user_id": user_id, "top_k": 5})
        assert status == 200
        user = ref.get_user(user_id)
        seen = [a.movie_id for a in (user.history or []) + (user.target or [])]
        want = ref.search_items(ref.embed_user_query(user),
                                exclude_item_ids=seen, top_k=5)
        assert [c["movie_id"] for c in body] == [c.movie_id for c in want]
        status, body = post("search_items_text", {"query": "drama"})
        assert status == 200 and body
        assert body == port.search_items_text("drama")
        status, body = post("search_users_text", {"query": "F", "top_k": 3})
        assert status == 200 and len(body) == 3
        assert {"user_id", "user_text", "score"} <= set(body[0])
        assert post("add_items", {"items": []})[0] == 403
        assert post("drop_tables", {})[0] == 404
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
            text = resp.read().decode()
        assert 'endpoint="recommend_with_item_id",status="200"' in text
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_http_burst_of_concurrent_clients(engines):
    """64 clients at once, as chip_smoke.py sends them: every request is
    answered (the server's listen backlog holds the burst) and the
    micro-batcher coalesces them."""
    _, port = engines
    service = RecService(port, micro_batch=16, micro_batch_wait_ms=20)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/recommend_with_query"

    def post(text):
        req = urllib.request.Request(
            url,
            data=json.dumps({"query": {"text": text}, "top_k": 3}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        texts = [TEXTS[i % 3] for i in range(64)]
        with concurrent.futures.ThreadPoolExecutor(64) as pool:
            bodies = [
                f.result(timeout=120)
                for f in [pool.submit(post, t) for t in texts]
            ]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        service.close()
    assert all(len(body) == 3 for body in bodies)
    assert service.batcher.requests_served == 64
    assert service.batcher.batches_dispatched < 64
