"""Port parity: `RetrievalIndex` on the f32 lane-max scan, and the
host-escalated certified searches (methods "f32" and "packed").

Corpus and queries hold multiples of 1/8 (see test_torch_index.py), so
every dot product is exact in f32 in any order and both packages must
return identical ids and scores, and the same `last_certified_stats`.
The index picks its own corpus tile (2048 lanes at this dim), so the
cases that must retry or fall back need more than two tiles: 8192 items.
"""

import json

import numpy as np
import pytest

from tests.test_torch_index import DIM, dyadic
from xfmr_rec_torch.index.mips import RetrievalIndex as PortIndex
from xfmr_rec_tpu.index.mips import RetrievalIndex as RefIndex

TILE = 2048  # pick_corpus_tile(8192, 16)
N = 4 * TILE
K = 13


def build(corpus, **kw):
    ids = np.arange(100, 100 + len(corpus))
    return (
        RefIndex(corpus, ids, **kw),
        PortIndex(corpus, ids, device="cpu", **kw),
    )


def planted(seed):
    """Queries and a corpus where row 0 needs the dense fallback and
    row 1 a retry.

    The corpus is scaled by 1/4 and copies of a query are planted, so the
    copies tie as that row's best items. Three copies in one lane (in
    three tiles) overflow the lane's two slots; lane l of tile t reads
    column (l - t * shuffle) mod TILE, so a triple can be placed to
    collide under one shuffle only. Row 0 gets a triple for each of the
    four passes (shuffles 0, 1, 3, 5): with k = 13 > 12 copies the k-th
    score is below the copies', every pass evicts a copy, and no pass
    certifies. Row 1 gets the shuffle-0 triple only.
    """
    queries = dyadic(seed, 5)
    corpus = dyadic(seed + 1, N) * 0.25
    for lane, shuffle in ((100, 0), (200, 1), (300, 3), (400, 5)):
        for tile in range(3):
            corpus[tile * TILE + (lane - tile * shuffle) % TILE] = queries[0]
    for tile in range(3):
        corpus[tile * TILE + 500] = queries[1]
    return queries, corpus


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_search_f32_scan_kernel_same_ids(dtype):
    corpus = dyadic(400, 5000)
    ref, port = build(corpus, method="scan", scan_kernel="f32", dtype=dtype)
    assert port.method == ref.method == "scan"
    assert port.scan_kernel == ref.scan_kernel == "f32"
    queries = dyadic(401, 5)
    excl = [[100, 101, 102], [], [4000], [110, 120, 130, 140, 150], [99999]]
    want_s, want_ids = ref.search(queries, top_k=10, exclude_ids=excl)
    got_s, got_ids = port.search(queries, top_k=10, exclude_ids=excl)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_s, want_s)
    for row, ex in enumerate(excl):
        assert not set(ex) & set(got_ids[row].tolist())
    # the f32 scan returns true f32 scores, no quantum floor
    dense = np.asarray(ref.corpus, np.float32)
    if dtype == "int8":
        dense = dense * np.asarray(ref._scales)[0][:, None]
    np.testing.assert_allclose(
        got_s[1], np.sort(queries[1] @ dense.T)[::-1][:10], rtol=1e-6
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("method", ["f32", "packed"])
def test_search_certified_same_ids(method, dtype):
    corpus = dyadic(410, 5000)
    ref, port = build(corpus, method="scan", dtype=dtype)
    queries = dyadic(411, 5)
    want_s, want_ids = ref.search_certified(queries, top_k=10, method=method)
    got_s, got_ids = port.search_certified(queries, top_k=10, method=method)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_s, want_s)
    assert port.last_certified_stats == ref.last_certified_stats
    assert set(port.last_certified_stats) == {"batch", "pass1_bad",
                                              "retry_bad"}


def test_search_certified_default_method_is_f32():
    corpus = dyadic(420, 3000)
    ref, port = build(corpus, method="scan")
    queries = dyadic(421, 3)
    got_s, got_ids = port.search_certified(queries, top_k=5)
    want_s, want_ids = ref.search_certified(queries, top_k=5)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_s, want_s)
    f32_s, f32_ids = port.search_certified(queries, top_k=5, method="f32")
    np.testing.assert_array_equal(got_ids, f32_ids)
    assert "pass1_bad" in port.last_certified_stats
    with pytest.raises(ValueError, match="unknown certified search method"):
        port.search_certified(queries, top_k=5, method="lane")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("method", ["f32", "packed"])
def test_search_certified_retry_and_dense_fallback(method, dtype):
    queries, corpus = planted(430)
    ref, port = build(corpus, method="scan", dtype=dtype)
    assert port._scan_setup()[2] == TILE
    want_s, want_ids = ref.search_certified(queries, top_k=K, method=method)
    got_s, got_ids = port.search_certified(queries, top_k=K, method=method)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_s, want_s)
    stats = port.last_certified_stats
    assert stats == ref.last_certified_stats
    # rows 0, 1 and 4 fail pass 1 (row 0's copies are all 1/2, so they
    # tie as the best items of row 4 too); the retries certify row 1;
    # rows 0 and 4 go to the dense path
    assert stats == {"batch": 5, "pass1_bad": 3, "retry_bad": 2}
    # every row is the dense exact top-k (scores as a multiset)
    dense = np.asarray(ref.corpus, np.float32)
    if dtype == "int8":
        dense = dense * np.asarray(ref._scales)[0][:, None]
    exact = np.sort(queries @ dense.T, axis=1)[:, ::-1][:, :K]
    picked = np.take_along_axis(queries @ dense.T, got_ids - 100, axis=1)
    np.testing.assert_allclose(np.sort(picked, axis=1)[:, ::-1], exact,
                               rtol=1e-6)
    assert len(set(got_ids[0].tolist())) == K


def test_search_certified_packed_exact_scores():
    queries, corpus = planted(440)
    ref, port = build(corpus, method="scan")
    want_s, want_ids = ref.search_certified(
        queries, top_k=K, method="packed", exact_scores=True
    )
    got_s, got_ids = port.search_certified(
        queries, top_k=K, method="packed", exact_scores=True
    )
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_s, want_s)
    exact = np.sort(queries @ corpus.T, axis=1)[:, ::-1][:, :K]
    np.testing.assert_allclose(got_s, exact, rtol=1e-6)


def test_search_certified_single_query_and_odd_batch():
    corpus = dyadic(450, 3000)
    ref, port = build(corpus, method="scan")
    for queries in (dyadic(451, 1)[0], dyadic(452, 11)):
        for method in ("f32", "packed"):
            want = ref.search_certified(queries, top_k=7, method=method)
            got = port.search_certified(queries, top_k=7, method=method)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_f32_scan_index_loads_across_packages(tmp_path, dtype):
    """An index saved with `scan_kernel="f32"`, and one whose index.json
    lacks the key (which both packages read as "f32"), loads in the other
    package and answers the same ids."""
    corpus = dyadic(460, 600)
    ref, port = build(corpus, method="scan", scan_kernel="f32", dtype=dtype)
    ref.save(tmp_path / "ref")
    port.save(tmp_path / "port")
    meta = json.loads((tmp_path / "ref" / "index.json").read_text())
    assert meta["scan_kernel"] == "f32"
    del meta["scan_kernel"]
    (tmp_path / "old").mkdir()
    (tmp_path / "old" / "index.json").write_text(json.dumps(meta))
    (tmp_path / "old" / "corpus.npz").write_bytes(
        (tmp_path / "ref" / "corpus.npz").read_bytes()
    )
    queries = dyadic(461, 4)
    excl = [[100], [], [101, 102], []]
    want = ref.search(queries, top_k=5, exclude_ids=excl)
    for name in ("ref", "old"):
        loaded = PortIndex.load(tmp_path / name, device="cpu")
        assert loaded.method == "scan" and loaded.scan_kernel == "f32"
        got = loaded.search(queries, top_k=5, exclude_ids=excl)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    back = RefIndex.load(tmp_path / "port")
    assert back.scan_kernel == "f32"
    np.testing.assert_array_equal(
        back.search(queries, top_k=5, exclude_ids=excl)[1], want[1]
    )
    assert DIM == loaded.dim
