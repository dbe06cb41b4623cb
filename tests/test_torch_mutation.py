"""Port parity: live catalog mutation, the engine's add_items and the
serve CLI.

- `RetrievalIndex.add_items` / `remove_items` on the CPU (plain kernel
  versions), the cases of the reference's `tests/test_index.py`
  (`TestMutableCatalog`): the mutated index answers as a fresh build
  (ids equal, scores within 1e-3) at f32, bf16 and int8 and for every
  search method; int8 scales stay aligned; certified search after an
  add; the failure cases; the chunked guard; save and load after a
  mutation; the text index rebuilt after a mutation. A removal keeps the
  score bound's max norm, so the surviving rows keep their packed keys.
- On exact inputs (multiples of 1/8, one row of all 1/2) the port after
  a mutation gives the JAX package's corpus, scales, max norm, search
  and certified answers bit for bit.
- The engine and service on a port-trained tiny artifact: the 403 gate,
  `{"added", "num_items"}`, refused ids, an added item's text retrieving
  it, keyword search seeing it, searches hammering the engine while
  items are added, an added item past a dense ID table counted as
  unknown in the bag, and the serve CLI (`serving/prepare.py`) parsing
  its flags and passing its golden checks.
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.index.mips import RetrievalIndex as PortIndex
from xfmr_rec_torch.ops import topk
from xfmr_rec_torch.serving import prepare
from xfmr_rec_torch.serving.engine import RecommenderEngine as PortEngine
from xfmr_rec_torch.serving.schemas import (
    Activity,
    ItemQuery,
    Query,
    UserQuery,
)
from xfmr_rec_torch.serving.service import RecService, dispatch, make_server
from xfmr_rec_torch.training.module import TrainConfig as PortTrainConfig
from xfmr_rec_torch.training.trainer import Trainer as PortTrainer
from xfmr_rec_torch.training.trainer import TrainerConfig as PortTrainerConfig
from xfmr_rec_tpu.index.mips import RetrievalIndex as RefIndex

CPU = "cpu"

# (dtype, method, scan_kernel): every dtype under every search method
VARIANTS = [
    ("bfloat16", "dense", "packed"),
    ("float32", "dense", "packed"),
    ("bfloat16", "scan", "packed"),
    ("float32", "scan", "packed"),
    ("bfloat16", "scan", "f32"),
    ("float32", "scan", "f32"),
    ("int8", "scan", "packed"),
    ("int8", "scan", "f32"),
]
VARIANT_IDS = ["-".join(v) for v in VARIANTS]


def unit_data(n=200, extra=40, d=16, seed=33):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n + extra, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = rng.normal(size=(6, d)).astype(np.float32)
    return corpus[:n], corpus[n:], queries


def port_index(corpus, ids, dtype="bfloat16", method="dense",
               scan_kernel="packed", **kw):
    return PortIndex(corpus, ids, dtype=dtype, method=method,
                     scan_kernel=scan_kernel, device=CPU, **kw)


@pytest.mark.parametrize(("dtype", "method", "scan_kernel"), VARIANTS,
                         ids=VARIANT_IDS)
def test_add_matches_fresh_build(dtype, method, scan_kernel):
    base, extra, queries = unit_data()
    n = len(base)
    idx = port_index(base, np.arange(1, n + 1), dtype, method, scan_kernel)
    idx.search(queries, top_k=5)  # builds the old scan state
    idx.add_items(extra, np.arange(n + 1, n + 1 + len(extra)),
                  metadata=[{"title": f"new-{i}"} for i in range(len(extra))])
    fresh = port_index(np.concatenate([base, extra]),
                       np.arange(1, n + 1 + len(extra)), dtype, method,
                       scan_kernel)
    excl = [[1], [], [n + 1], [5, 6], [], [n + 3]]
    s_mut, ids_mut = idx.search(queries, top_k=10, exclude_ids=excl)
    s_ref, ids_ref = fresh.search(queries, top_k=10, exclude_ids=excl)
    np.testing.assert_array_equal(ids_mut, ids_ref)
    np.testing.assert_allclose(s_mut, s_ref, rtol=1e-3, atol=1e-3)
    assert idx.get_id(n + 1)["title"] == "new-0"
    assert len(idx) == n + len(extra)
    assert idx._scan_setup()[3] == n + len(extra)


@pytest.mark.parametrize(("dtype", "method", "scan_kernel"), VARIANTS,
                         ids=VARIANT_IDS)
def test_remove_matches_fresh_build(dtype, method, scan_kernel):
    base, _, queries = unit_data()
    n = len(base)
    idx = port_index(base, np.arange(1, n + 1), dtype, method, scan_kernel)
    idx.search(queries, top_k=5)
    drop = [3, 50, 199]
    idx.remove_items(drop)
    keep = np.array([i not in drop for i in range(1, n + 1)])
    fresh = port_index(base[keep], np.arange(1, n + 1)[keep], dtype, method,
                       scan_kernel)
    s_mut, ids_mut = idx.search(queries, top_k=10)
    s_ref, ids_ref = fresh.search(queries, top_k=10)
    np.testing.assert_array_equal(ids_mut, ids_ref)
    np.testing.assert_allclose(s_mut, s_ref, rtol=1e-3, atol=1e-3)
    assert idx.get_id(3) == {}
    assert len(idx) == n - 3


def test_added_items_are_retrievable():
    base, extra, _ = unit_data()
    n = len(base)
    idx = port_index(base, np.arange(1, n + 1), "float32")
    idx.add_items(torch.from_numpy(extra), np.arange(n + 1, n + 1 + 40))
    _, ids = idx.search(extra[:3], top_k=1)
    np.testing.assert_array_equal(ids[:, 0], [n + 1, n + 2, n + 3])


def test_remove_int8_keeps_scales_aligned():
    base, _, queries = unit_data()
    n = len(base)
    idx = port_index(base, np.arange(1, n + 1), "int8")
    idx.remove_items([1, 2])
    fresh = port_index(base[2:], np.arange(3, n + 1), "int8")
    torch.testing.assert_close(idx._scales, fresh._scales, rtol=0, atol=0)
    torch.testing.assert_close(idx.corpus, fresh.corpus, rtol=0, atol=0)
    np.testing.assert_array_equal(idx.search(queries, top_k=8)[1],
                                  fresh.search(queries, top_k=8)[1])


def test_int8_add_leaves_existing_rows_untouched():
    base, extra, _ = unit_data()
    n = len(base)
    idx = port_index(base, np.arange(1, n + 1), "int8")
    rows, scales = idx.corpus.clone(), idx._scales.clone()
    idx.add_items(extra * 3.0, np.arange(n + 1, n + 41))
    torch.testing.assert_close(idx.corpus[:n], rows, rtol=0, atol=0)
    torch.testing.assert_close(idx._scales[:, :n], scales, rtol=0, atol=0)
    alone = port_index(extra * 3.0, np.arange(40), "int8")
    torch.testing.assert_close(idx.corpus[n:], alone.corpus, rtol=0, atol=0)
    assert idx._corpus_maxnorm == alone._corpus_maxnorm


@pytest.mark.parametrize("method", ["packed", "fused", "f32"])
def test_certified_search_after_add(method):
    base, extra, queries = unit_data()
    n = len(base)
    idx = port_index(base, np.arange(1, n + 1), "float32", "scan")
    idx.search_certified(queries, top_k=5, method=method)
    idx.add_items(extra, np.arange(n + 1, n + 41))
    scores, ids = idx.search_certified(queries, top_k=5, method=method,
                                       exact_scores=True)
    dense = queries @ np.concatenate([base, extra]).T
    for b in range(len(queries)):
        np.testing.assert_allclose(np.sort(scores[b])[::-1],
                                   np.sort(dense[b])[::-1][:5],
                                   rtol=1e-2, atol=1e-2)
        assert set(ids[b]) <= set(range(1, n + 41))


def test_fail_loud():
    base, extra, _ = unit_data()
    n = len(base)
    idx = port_index(base, np.arange(1, n + 1))
    with pytest.raises(ValueError, match="already in the index"):
        idx.add_items(extra[:1], [1])
    with pytest.raises(ValueError, match="duplicate ids"):
        idx.add_items(extra[:2], [n + 1, n + 1])
    with pytest.raises(ValueError, match="dim mismatch"):
        idx.add_items(extra[:1, :8], [n + 1])
    with pytest.raises(ValueError, match="not in the index"):
        idx.remove_items([99999])
    with pytest.raises(ValueError, match="must align"):
        idx.add_items(extra[:2], [n + 1, n + 2], metadata=[{}])
    with pytest.raises(ValueError, match="must align"):
        idx.add_items(extra[:2], [n + 1])
    assert len(idx) == n and idx.corpus.shape[0] == n


def test_chunked_mutation_guard():
    base, extra, queries = unit_data()
    n = len(base)
    chunk = len(extra)  # 40 divides 200 and 240
    idx = port_index(base, np.arange(1, n + 1), chunk_size=chunk)
    with pytest.raises(ValueError, match="chunk_size"):
        idx.add_items(extra[:1], [n + 1])
    with pytest.raises(ValueError, match="chunk_size"):
        idx.remove_items([1])
    assert len(idx) == n
    idx.search(queries, top_k=4)
    idx.add_items(extra[:chunk], np.arange(n + 1, n + 1 + chunk))
    assert len(idx) == n + chunk
    idx.search(queries, top_k=4)


def test_save_load_after_mutation(tmp_path):
    base, extra, queries = unit_data()
    n = len(base)
    idx = port_index(base, np.arange(1, n + 1))
    idx.add_items(extra, np.arange(n + 1, n + 1 + len(extra)))
    idx.remove_items([5])
    idx.save(tmp_path / "mut")
    loaded = PortIndex.load(tmp_path / "mut", device=CPU)
    assert len(loaded) == n + len(extra) - 1
    np.testing.assert_array_equal(idx.search(queries, top_k=10)[1],
                                  loaded.search(queries, top_k=10)[1])
    from_ref = RefIndex.load(tmp_path / "mut")
    np.testing.assert_array_equal(idx.search(queries, top_k=10)[1],
                                  from_ref.search(queries, top_k=10)[1])


def test_bm25_rebuilds_after_mutation():
    base, extra, _ = unit_data()
    n = len(base)
    meta = [{"text": f"movie number {i}"} for i in range(n)]
    idx = port_index(base, np.arange(1, n + 1), metadata=meta)
    assert idx.search_text("zebra", top_k=3) == []
    idx.add_items(extra[:1], [n + 1], metadata=[{"text": "the zebra film"}])
    hits = idx.search_text("zebra", top_k=3)
    assert hits and hits[0]["id"] == n + 1
    idx.remove_items([n + 1])
    assert idx.search_text("zebra", top_k=3) == []


def survivor_keys(index, queries, ids, idx_bits=9):
    """Packed keys (tile stamp 0, one reserved bit) of the rows `ids` for
    these queries, at the index's own score bound."""
    q = torch.from_numpy(queries).to(torch.bfloat16)
    bound = index._score_bound(queries)
    q_s = (q.float() * (0.25 / bound)).bfloat16()
    rows = torch.tensor([index._id_to_pos[i] for i in ids])
    scores = q_s.float() @ index.corpus[rows].float().T
    return topk._packed_keys(scores, 0, idx_bits, 1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_remove_keeps_survivor_keys(dtype):
    base, extra, queries = unit_data()
    n = len(base)
    idx = port_index(base, np.arange(1, n + 1), dtype, "scan")
    idx.add_items(extra * 1.5, np.arange(n + 1, n + 41))
    survivors = list(range(1, n + 1, 7))
    before = survivor_keys(idx, queries, survivors)
    maxnorm = idx._corpus_maxnorm
    idx.remove_items(np.arange(n + 1, n + 41))  # the rows that set the max
    assert idx._corpus_maxnorm == maxnorm
    torch.testing.assert_close(survivor_keys(idx, queries, survivors),
                               before, rtol=0, atol=0)
    # certified search over the compacted corpus is still exact
    scores, ids = idx.search_certified(queries, top_k=5, method="fused",
                                       exact_scores=True)
    dense = queries @ base.T
    for b in range(len(queries)):
        np.testing.assert_allclose(np.sort(scores[b])[::-1],
                                   np.sort(dense[b])[::-1][:5],
                                   rtol=1e-2, atol=1e-2)


DIM = 16


def dyadic(seed, rows):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=(rows, DIM)).astype(np.float32) / 8
    x[0] = 0.5
    return x


@pytest.mark.parametrize(
    "kw",
    [dict(method="scan"), dict(method="scan", dtype="int8"),
     dict(method="scan", dtype="float32", scan_kernel="f32"),
     dict(method="dense")],
    ids=["scan-bf16", "scan-int8", "scan-f32-f32kernel", "dense-bf16"],
)
def test_mutation_bit_equal_to_jax(kw):
    base, extra, queries = dyadic(1, 600), dyadic(2, 64), dyadic(3, 5)
    ref = RefIndex(base, np.arange(1, 601), **kw)
    port = PortIndex(base, np.arange(1, 601), device=CPU, **kw)
    for index in (ref, port):
        index.search(queries, top_k=5)
        index.add_items(extra * 2, np.arange(601, 665))
        index.remove_items([3, 50, 620, 1])
    assert port._corpus_maxnorm == ref._corpus_maxnorm
    np.testing.assert_array_equal(port.ids, ref.ids)
    np.testing.assert_array_equal(port.corpus.float().numpy(),
                                  np.asarray(ref.corpus, np.float32))
    if port._scales is not None:
        np.testing.assert_array_equal(port._scales.numpy(),
                                      np.asarray(ref._scales))
    excl = [[2, 601], [], [4000], [10, 20, 640], [5]]
    want = ref.search(queries, top_k=10, exclude_ids=excl)
    got = port.search(queries, top_k=10, exclude_ids=excl)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    if kw["method"] == "scan":
        for method in ("packed", "fused", "f32"):
            want = ref.search_certified(queries, top_k=7, method=method)
            got = port.search_certified(queries, top_k=7, method=method)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])


# -- engine, service and CLI on a port-trained artifact ----------------------
TINY = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, vocab_size=500, max_position_embeddings=32,
            max_length=16, compute_dtype="float32")
DATA = dict(batch_size=8, eval_batch_size=16, max_length=16, vocab_size=500)


def train_artifact(root, model=None, data=None):
    trainer = PortTrainer(
        PortTrainConfig(**{**TINY, **(model or {})}),
        data=PortDataModule(PortDataConfig(data_dir=str(root / "data"),
                                           **{**DATA, **(data or {})})),
        trainer_config=PortTrainerConfig(
            max_steps=3, checkpointing=False, limit_val_batches=1,
            limit_val_loss_batches=1, log_dir=str(root / "runs"),
            run_name="r"),
        device=CPU,
    )
    trainer.fit()
    trainer.save(root / "art")
    return root / "art"


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return train_artifact(tmp_path_factory.mktemp("mutation"))


def new_items(start, count):
    return [ItemQuery(movie_rn=0, movie_id=start + i,
                      movie_text=f'{{"title": "Zebra Crossing {i} (2031)", '
                                 f'"genres": ["Zebra{i}"]}}')
            for i in range(count)]


def test_service_gate_and_add(artifact):
    closed = RecService(PortEngine(artifact, device=CPU, warmup=False))
    with pytest.raises(PermissionError, match="disabled"):
        closed.add_items([new_items(900001, 1)[0]])
    service = RecService(PortEngine(artifact, device=CPU, warmup=False),
                         allow_catalog_mutation=True)
    before = len(service.engine.index)
    out = dispatch(service, "add_items", {
        "items": [vars(i) for i in new_items(900001, 3)]})
    assert out == {"added": 3, "num_items": before + 3}
    assert service.item_id(900002).movie_text.startswith('{"title": "Zebra')
    assert dispatch(service, "add_items", {"items": []}) == {
        "added": 0, "num_items": before + 3}


def test_http_maps_gate_to_403(artifact):
    engine = PortEngine(artifact, device=CPU, warmup=False)
    for allow, status in ((False, 403), (True, 200)):
        server = make_server(RecService(engine, allow_catalog_mutation=allow),
                             port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/add_items",
                data=json.dumps({"items": [vars(new_items(910000, 1)[0])]})
                .encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    got = resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as err:
                got = err.code, json.loads(err.read())
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
        assert not thread.is_alive()
        assert got[0] == status, got
    assert got[1]["added"] == 1


def test_engine_refuses_bad_ids(artifact):
    engine = PortEngine(artifact, device=CPU, warmup=False)
    before = engine.index
    dupe = new_items(900003, 1)[0]
    with pytest.raises(ValueError, match="duplicate ids"):
        engine.add_items([dupe, dupe])
    existing = ItemQuery(movie_id=int(before.ids[0]), movie_text="x")
    with pytest.raises(ValueError, match="already in the catalog"):
        engine.add_items([existing])
    assert engine.index is before


def test_added_item_retrieves_itself_and_is_searchable(artifact):
    engine = PortEngine(artifact, device=CPU, warmup=False)
    items = new_items(920000, 4)
    old = engine.index
    assert engine.add_items(items) == 4
    assert engine.index is not old and len(engine.index) == len(old) + 4
    assert engine.index._scan_state is not None or engine.index.method != (
        "scan")
    for item in items:
        got = engine.search_items(Query(text=item.movie_text), top_k=10)
        assert item.movie_id in [c.movie_id for c in got]
        hits = engine.search_items_text(f"zebra{item.movie_id - 920000}",
                                        top_k=3)
        assert hits[0]["movie_id"] == item.movie_id
    assert old.search_text("zebra0", top_k=3) == []


def test_search_hammer_while_adding(artifact):
    """Reader threads search while items are added: no errors, every id
    from some published catalog, and the adds become visible."""
    engine = PortEngine(artifact, device=CPU, warmup=False)
    base_ids = {int(i) for i in engine.index.ids}
    items = new_items(990100, 6)
    all_ids = base_ids | {i.movie_id for i in items}
    query = engine.embed_query(Query(text="Zebra Crossing 3 Zebra3"))
    errors, seen_added = [], threading.Event()
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                ids = [c.movie_id for c in engine.search_items(query, top_k=5)]
                assert len(ids) == 5 and len(set(ids)) == 5
                assert set(ids) <= all_ids
                if set(ids) - base_ids:
                    seen_added.set()
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader) for _ in range(6)]
    try:
        for t in threads:
            t.start()
        for start in range(0, len(items), 2):
            assert engine.add_items(items[start:start + 2]) == 2
        seen_added.wait(timeout=30)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert seen_added.is_set()
    assert len(engine.index) == len(base_ids) + len(items)


def test_added_item_past_dense_table_is_unknown_in_bag(tmp_path):
    art = train_artifact(tmp_path, model=dict(
        user_tower="history", max_history=4, item_id_embedding="dense",
        item_id_buckets=201, max_bag=8,
        train_loss="InfomationNoiseContrastiveEstimationLoss"),
        data=dict(max_history=4, max_bag=8))
    engine = PortEngine(art, device=CPU, warmup=False)
    engine.add_items([ItemQuery(movie_id=900100, movie_text="Live Item")])
    new_pos = engine.index._id_to_pos[900100]
    assert new_pos + 1 >= engine.model_config.item_id_buckets
    assert engine._hist_corpus.shape[0] == len(engine.index)
    user_text = '{"gender":"F","age":30,"occupation":1,"zipcode":"12345"}'
    history = [Activity(datetime=1, rating=5, movie_rn=0, movie_id=900100,
                        movie_text="")]
    served = engine.embed_user_query(
        UserQuery(user_text=user_text, history=history)).embedding
    tokens = torch.from_numpy(engine.tokenizer.encode_batch([user_text]))
    hist = torch.zeros((1, 4), dtype=torch.int64)
    hist[0, 0] = new_pos
    mask = torch.zeros((1, 4), dtype=torch.bool)
    mask[0, 0] = True
    rating = torch.zeros((1, 4), dtype=torch.int64)
    rating[0, 0] = 5
    zeros = torch.zeros((1, 8), dtype=torch.int64)
    want = engine.encoder.encode_users_from_corpus(
        tokens, engine._hist_corpus, hist, mask, rating, zeros, zeros,
        zeros.bool())[0]
    torch.testing.assert_close(torch.tensor(served), want, rtol=0, atol=0)
    # the added item's own history row is the encoded item, not a zero row
    item_row = engine._encode_items([ItemQuery(movie_id=900100,
                                               movie_text="Live Item")])
    torch.testing.assert_close(engine._hist_corpus[new_pos],
                               item_row[0, :32], rtol=0, atol=0)


def test_cli_parses_flags_and_passes_golden_checks(artifact, caplog,
                                                   capsys):
    args = prepare.parse_args(["--artifact_dir", str(artifact), "--device",
                               "cpu", "--allow-catalog-mutation"])
    assert (args.artifact_dir, args.device) == (str(artifact), "cpu")
    assert args.allow_catalog_mutation and not args.serve
    assert prepare.parse_args([]).device == "cuda"
    caplog.set_level("INFO")
    prepare.main(["--artifact_dir", str(artifact), "--device", "cpu"])
    prepare.main(["--artifact_dir", str(artifact), "--device", "cpu",
                  "--allow-catalog-mutation"])
    assert caplog.text.count("golden-value checks passed") == 2
    for kind, item in (("ivf", "item 10"), ("sharded", "item 11")):
        with pytest.raises(SystemExit):
            prepare.parse_args(["--index_kind", kind])
        assert f"Queue 1 {item}" in capsys.readouterr().err


def test_cli_trains_a_missing_artifact(tmp_path, monkeypatch):
    """No artifact: the CLI trains one on the data layer's synthetic
    corpus (nothing downloaded), in the working directory's data/."""
    monkeypatch.chdir(tmp_path)
    prepare.main(["--artifact_dir", "art", "--device", "cpu"])
    assert (tmp_path / "art" / "processors.json").exists()
    assert (tmp_path / "data" / "ml-1m").exists()


def test_cli_without_a_card_raises(artifact):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        prepare.main(["--artifact_dir", str(artifact)])
