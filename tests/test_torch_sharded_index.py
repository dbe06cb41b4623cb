"""Port parity: `ShardedRetrievalIndex` and the engine's sharded index kind.

The port's index runs on a virtual mesh of CPU devices, the reference's
on its 8 forced CPU devices. Results are held against the dense f64
reference by true-score multiset (packed keys quantize scores: ids
within one key quantum may swap, never scores) and against the
reference's index the same way; the engine's answers must be the
reference engine's ids. Save / load crosses kinds and packages.
"""

import concurrent.futures
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from tests.test_serving import build_artifact
from xfmr_rec_torch.index.mips import RetrievalIndex
from xfmr_rec_torch.index.sharded import ShardedRetrievalIndex
from xfmr_rec_torch.parallel.mesh import create_mesh
from xfmr_rec_torch.serving.batching import MicroBatcher
from xfmr_rec_torch.serving.engine import RecommenderEngine as PortEngine
from xfmr_rec_torch.serving.schemas import Query
from xfmr_rec_torch.serving.users import UserStore
from xfmr_rec_tpu.index.mips import RetrievalIndex as RefIndex
from xfmr_rec_tpu.index.sharded import ShardedRetrievalIndex as RefSharded
from xfmr_rec_tpu.parallel.mesh import create_mesh as ref_create_mesh
from xfmr_rec_tpu.serving.engine import RecommenderEngine as RefEngine
from xfmr_rec_tpu.serving.schemas import Query as RefQuery

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

DIM = 16
QUANTUM_ATOL = 1e-4
TEXTS = ["comedy", "action thriller", "a quiet drama about family", ""]


def make_corpus(n, seed=0, dim=DIM):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ids = rng.permutation(10 * n)[:n].astype(np.int64)
    metadata = [{"movie_text": f"item {int(i)}"} for i in ids]
    return emb, ids, metadata


def make_queries(b, seed=1, dim=DIM):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, dim)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def dense_scores(queries, emb, exclude_pos=None):
    scores = queries.astype(np.float64) @ emb.astype(np.float64).T
    if exclude_pos is not None:
        for row, excl in enumerate(exclude_pos):
            valid = [int(p) for p in excl if 0 <= p < emb.shape[0]]
            scores[row, valid] = -np.inf
    return scores


def assert_topk_equiv(item_ids, ids, queries, emb, exclude_pos=None, atol=QUANTUM_ATOL):
    """Returned id sets equal the exact top-k by true-score multiset."""
    ref = dense_scores(queries, emb, exclude_pos)
    id_to_pos = {int(i): p for p, i in enumerate(ids)}
    for row in range(queries.shape[0]):
        got = [id_to_pos[int(i)] for i in item_ids[row] if int(i) != -1]
        assert len(got) == len(set(got)), "duplicate ids in one row"
        got_scores = np.sort(ref[row][got])[::-1]
        want = np.sort(ref[row])[::-1][: len(got)]
        np.testing.assert_allclose(got_scores, want, atol=atol)


def port_mesh(data=1, model=8):
    return create_mesh(model_parallel=model, devices=["cpu"] * (data * model))


@pytest.fixture(scope="module")
def mesh():
    return port_mesh()


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_create_mesh(8, model_parallel=8)


def test_search_matches_dense_and_reference(mesh, ref_mesh):
    emb, ids, metadata = make_corpus(1024)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh, dtype="float32")
    ref = RefSharded(emb, ids, metadata, mesh=ref_mesh, dtype="float32")
    queries = make_queries(16)
    scores, item_ids = index.search(queries, top_k=10)
    assert item_ids.shape == (16, 10)
    assert_topk_equiv(item_ids, ids, queries, emb)
    want_scores, want_ids = ref.search(queries, top_k=10)
    np.testing.assert_allclose(scores, want_scores, atol=QUANTUM_ATOL)
    # decoded scores are quantum floors of the true scores
    true = dense_scores(queries, emb)
    id_to_pos = {int(i): p for p, i in enumerate(ids)}
    for row in range(16):
        at = true[row][[id_to_pos[int(i)] for i in item_ids[row]]]
        np.testing.assert_allclose(scores[row], at, atol=QUANTUM_ATOL)


def test_unbalanced_corpus_pads_and_masks(mesh):
    """N not divisible by the shard count: zero pad rows never surface."""
    emb, ids, metadata = make_corpus(1003)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh, dtype="float32")
    assert index.corpus.shape[0] == 1008
    queries = make_queries(8)
    _, item_ids = index.search(queries, top_k=10)
    assert (item_ids >= 0).all()
    assert_topk_equiv(item_ids, ids, queries, emb)
    for method in ("fused", "packed"):
        _, c_ids = index.search_certified(queries, top_k=10, method=method)
        assert (c_ids >= 0).all()
        assert_topk_equiv(c_ids, ids, queries, emb)


def test_exclusions_respected(mesh):
    emb, ids, metadata = make_corpus(512)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh, dtype="float32")
    queries = make_queries(4)
    _, top_ids = index.search(queries, top_k=3)
    exclude = [list(map(int, row)) for row in top_ids]
    _, item_ids = index.search(queries, top_k=10, exclude_ids=exclude)
    for row, banned in enumerate(exclude):
        assert not set(banned) & set(map(int, item_ids[row]))
    assert_topk_equiv(item_ids, ids, queries, emb, index.positions_of(exclude))


def test_exhausted_exclusions_give_minus_one(mesh):
    """Excluding all but 3 items of a 16-item corpus: the rest of the
    row is -1 (the engine's no-candidate sentinel), as in the reference."""
    emb, ids, metadata = make_corpus(16, seed=2)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=port_mesh(1, 2))
    exclude = [[int(i) for i in ids[3:]]]
    scores, item_ids = index.search(make_queries(1), top_k=8, exclude_ids=exclude)
    assert sorted(item_ids[0][:3].tolist()) == sorted(int(i) for i in ids[:3])
    assert (item_ids[0][3:] == -1).all() and np.isneginf(scores[0][3:]).all()


@pytest.mark.parametrize("method", ["fused", "packed"])
def test_search_certified_exact(mesh, method):
    emb, ids, metadata = make_corpus(2048, seed=3)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh, dtype="float32")
    queries = make_queries(8, seed=4)
    _, item_ids = index.search_certified(queries, top_k=20, method=method)
    assert_topk_equiv(item_ids, ids, queries, emb)
    assert index.last_certified_stats["batch"] == 8
    with pytest.raises(ValueError, match="unknown certified search method"):
        index.search_certified(queries, top_k=20, method="f32")


def test_dense_fallback_answers_uncertified_rows(mesh, monkeypatch):
    """Every row uncertified: the dense sharded path answers them all."""
    from xfmr_rec_torch.index import sharded as sharded_mod

    emb, ids, metadata = make_corpus(512, seed=5)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh, dtype="float32")
    real = sharded_mod.sharded_packed_certified_topk

    def never_exact(*args, **kwargs):
        scores, positions, exact = real(*args, **kwargs)
        return scores, positions, torch.zeros_like(exact)

    monkeypatch.setattr(sharded_mod, "sharded_packed_certified_topk", never_exact)
    queries = make_queries(5, seed=6)
    scores, item_ids = index.search_certified(queries, top_k=7, method="packed")
    assert index.last_certified_stats["pass1_bad"] == 5
    assert_topk_equiv(item_ids, ids, queries, emb, atol=1e-6)
    np.testing.assert_allclose(
        scores, np.sort(dense_scores(queries, emb), axis=1)[:, ::-1][:, :7],
        atol=1e-6,
    )


def test_metadata_surface(mesh):
    emb, ids, metadata = make_corpus(256)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh)
    assert len(index) == 256
    assert index.dim == DIM
    row = index.get_id(int(ids[7]))
    assert row["id"] == int(ids[7])
    assert index.get_id(999999999) == {}
    hits = index.search_text(f"item {int(ids[3])}", top_k=3)
    assert any(h["id"] == int(ids[3]) for h in hits)
    torch.testing.assert_close(
        index.dequantized(torch.device("cpu")),
        torch.from_numpy(emb).bfloat16().float(),
    )


def test_save_load_across_kinds_and_packages(mesh, ref_mesh, tmp_path):
    """Both kinds, in both packages, share one artifact layout."""
    emb, ids, metadata = make_corpus(512, seed=5)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh, dtype="float32")
    index.save(tmp_path / "port")
    queries = make_queries(4, seed=6)
    for loaded in (
        ShardedRetrievalIndex.load(tmp_path / "port", mesh=mesh),
        RetrievalIndex.load(tmp_path / "port", device="cpu"),
        RefSharded.load(tmp_path / "port", mesh=ref_mesh),
        RefIndex.load(tmp_path / "port"),
    ):
        _, item_ids = loaded.search(queries, top_k=5)
        assert_topk_equiv(np.asarray(item_ids), ids, queries, emb)
    RefSharded(emb, ids, metadata, mesh=ref_mesh, dtype="float32").save(
        tmp_path / "ref"
    )
    RetrievalIndex(emb, ids, metadata, dtype="float32", device="cpu").save(
        tmp_path / "single"
    )
    for path in ("ref", "single"):
        again = ShardedRetrievalIndex.load(tmp_path / path, mesh=mesh)
        assert again.dtype == "float32"
        _, item_ids = again.search(queries, top_k=5)
        assert_topk_equiv(item_ids, ids, queries, emb)
        assert again.get_id(int(ids[0]))["id"] == int(ids[0])


def test_int8_sharded_corpus(mesh, ref_mesh, tmp_path):
    """int8 composes with sharding: search is exact over the quantized
    corpus, equal to the reference's; artifacts round-trip."""
    emb, ids, metadata = make_corpus(515, seed=11)  # unbalanced too
    RetrievalIndex(emb, ids, metadata, dtype="int8", device="cpu").save(
        tmp_path / "q"
    )
    loaded = ShardedRetrievalIndex.load(tmp_path / "q", mesh=mesh)
    ref = RefSharded.load(tmp_path / "q", mesh=ref_mesh)
    assert loaded.dtype == "int8" and loaded.scales is not None
    np.testing.assert_array_equal(
        loaded.corpus.full(torch.device("cpu")).numpy(), np.asarray(ref.corpus)
    )
    queries = make_queries(8, seed=12)
    scores, item_ids = loaded.search(queries, top_k=10)
    assert (item_ids >= 0).all()
    quantized = loaded.dequantized(torch.device("cpu")).numpy()
    assert_topk_equiv(item_ids, ids, queries, quantized, atol=2e-3)
    want_scores, _ = ref.search(queries, top_k=10)
    np.testing.assert_allclose(scores, want_scores, atol=2e-3)
    _, c_ids = loaded.search_certified(queries, top_k=10)
    assert (c_ids >= 0).all()
    loaded.save(tmp_path / "q2")
    again = ShardedRetrievalIndex.load(tmp_path / "q2", mesh=mesh)
    _, ids2 = again.search(queries, top_k=10)
    np.testing.assert_array_equal(ids2, item_ids)


@pytest.fixture(scope="module", params=[(2, 4), (4, 2)], ids=["2x4", "4x2"])
def mesh2d(request):
    return port_mesh(*request.param)


def test_2d_mesh_search_matches_dense(mesh2d):
    emb, ids, metadata = make_corpus(512, seed=13)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh2d, dtype="float32")
    queries = make_queries(16, seed=14)
    _, item_ids = index.search(queries, top_k=10)
    assert_topk_equiv(item_ids, ids, queries, emb)


def test_2d_mesh_odd_batch_pads_over_data_axis(mesh2d):
    emb, ids, metadata = make_corpus(256, seed=15)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh2d, dtype="float32")
    queries = make_queries(7, seed=16)
    padded, _, batch = index._pad_batch(torch.from_numpy(queries))
    assert batch == 7 and padded.shape[0] % (8 * mesh2d.shape["data"]) == 0
    _, item_ids = index.search(queries, top_k=5)
    assert item_ids.shape == (7, 5)
    assert_topk_equiv(item_ids, ids, queries, emb)
    for method in ("fused", "packed"):
        _, c_ids = index.search_certified(queries, top_k=5, method=method)
        assert c_ids.shape == (7, 5)
        assert_topk_equiv(c_ids, ids, queries, emb)


def test_2d_mesh_exclusions(mesh2d):
    emb, ids, metadata = make_corpus(512, seed=17)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=mesh2d, dtype="float32")
    queries = make_queries(8, seed=18)
    _, top_ids = index.search(queries, top_k=2)
    exclude = [list(map(int, row)) for row in top_ids]
    _, item_ids = index.search(queries, top_k=6, exclude_ids=exclude)
    for row, banned in enumerate(exclude):
        assert not set(banned) & set(map(int, item_ids[row]))
    assert_topk_equiv(item_ids, ids, queries, emb, index.positions_of(exclude))


def test_pad_batch_rounds_wide_batches_to_128_a_data_row():
    emb, ids, metadata = make_corpus(64, seed=19)
    index = ShardedRetrievalIndex(emb, ids, metadata, mesh=port_mesh(2, 2))
    padded, excl, batch = index._pad_batch(
        torch.zeros(300, DIM), torch.zeros(300, 3, dtype=torch.int32)
    )
    assert (batch, padded.shape[0], excl.shape[0]) == (300, 512, 512)
    assert (excl[300:] == 64).all()


# -- the engine --------------------------------------------------------
@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = build_artifact(tmp_path_factory)
    UserStore.from_rows(
        pd.read_parquet(path / "users.parquet").to_dict("records")
    ).save(path / "users.npz")
    return path


@pytest.fixture(scope="module")
def sharded_engines(artifact, tmp_path_factory):
    ref_path = tmp_path_factory.mktemp("ref") / "model"
    shutil.copytree(artifact, ref_path)
    return (
        RefEngine(ref_path, warmup=False, index_kind="sharded", model_parallel=8),
        PortEngine(artifact, index_kind="sharded", model_parallel=8, device="cpu"),
    )


@pytest.mark.parametrize("text", TEXTS)
def test_engine_sharded_answers_as_the_reference(sharded_engines, text):
    ref, port = sharded_engines
    assert type(port.index).__name__ == "ShardedRetrievalIndex"
    assert port.index.num_shards == 8
    want = ref.search_items(RefQuery(text=text), top_k=5)
    got = port.search_items(Query(text=text), top_k=5)
    assert [c.movie_id for c in got] == [c.movie_id for c in want]
    np.testing.assert_allclose(
        [c.score for c in got], [c.score for c in want], atol=1e-4
    )
    banned = [c.movie_id for c in got[:2]]
    want = ref.search_items(RefQuery(text=text), exclude_item_ids=banned, top_k=5)
    got = port.search_items(Query(text=text), exclude_item_ids=banned, top_k=5)
    assert [c.movie_id for c in got] == [c.movie_id for c in want]
    assert not set(banned) & {c.movie_id for c in got}


def test_engine_sharded_microbatcher(sharded_engines):
    """Batched text requests go through the sharded index too."""
    _, port = sharded_engines
    batcher = MicroBatcher(port, max_batch=8, max_wait_ms=20)
    try:
        texts = [TEXTS[i % len(TEXTS)] for i in range(12)]
        with concurrent.futures.ThreadPoolExecutor(12) as pool:
            futures = [pool.submit(batcher.search_items, t, top_k=5) for t in texts]
            results = [f.result(timeout=60) for f in futures]
    finally:
        batcher.close()
    for text, got in zip(texts, results, strict=True):
        want = port.index.search(port.embed([text]), top_k=5)[1][0]
        kept = [int(i) for i in want if i != -1]
        # a batch shares one score bound: ids within a bf16 step of the
        # k-th may swap, the firm ones never
        assert set(kept[:3]) <= {c.movie_id for c in got}


def test_engine_sharded_refuses_add_items_and_defaults(artifact):
    from xfmr_rec_torch.serving.schemas import ItemQuery

    engine = PortEngine(artifact, index_kind="sharded", warmup=False, device="cpu")
    assert engine.index.mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="index_kind='exact'"):
        engine.add_items([ItemQuery(movie_rn=999, movie_id=99999, movie_text="x")])
