"""Port parity: BM25 keyword search.

The port's `BM25Index`, in C++ (`native/bm25.cpp`) and in numpy
(`native=False`), against the JAX package's Python oracle
`BM25Index(native=False)`: the same rows in the same order (ties by row),
scores within 1e-5 relative, top-k truncation and positive scores only.
The port's two paths repeat one arithmetic and must agree bit for bit.
The cases mirror the reference's `tests/test_native.py` (its
`TestNativeBM25`), plus text whose Unicode lowercase reaches ASCII.
`RetrievalIndex.search_text` rides the same index.
"""

import numpy as np
import pytest

from xfmr_rec_torch import native
from xfmr_rec_torch.index.mips import BM25Index as PortBM25
from xfmr_rec_torch.index.mips import RetrievalIndex as PortIndex
from xfmr_rec_tpu.index.mips import BM25Index as RefBM25

DOCS = [
    {"text": '{"title": "Toy Story (1995)", "genres": ["Animation"]}'},
    {"text": '{"title": "Heat (1995)", "genres": ["Action", "Crime"]}'},
    {"text": '{"title": "Toy Story 2 (1999)", "genres": ["Animation"]}'},
    {"text": "CASE insensitive MiXeD 42 tokens-with punct!!"},
    {"text": ""},
    {"text": "story story story story"},
    {"text": "Kelvin İstanbul straße café"},
]
QUERIES = [
    "toy story",
    "heat",
    "animation 1995",
    "STORY",
    "nonexistent token",
    "42 punct",
    "",
    "story toy story heat",
    "kelvin istanbul",
    "KELVIN",
]


def assert_same(got, want):
    assert [r for r, _ in got] == [r for r, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def trio():
    return (
        RefBM25(list(DOCS), text_col="text", native=False),
        PortBM25(list(DOCS), text_col="text", native=False),
        PortBM25(list(DOCS), text_col="text"),
    )


@pytest.mark.parametrize("query", QUERIES)
def test_matches_reference_oracle(trio, query):
    ref, python, native_ = trio
    want = ref.search(query, top_k=6)
    assert_same(python.search(query, top_k=6), want)
    assert native_.search(query, top_k=6) == python.search(query, top_k=6)


def test_native_path_is_native(trio):
    _, python, native_ = trio
    assert python._native is None and native_._native is not None


@pytest.mark.parametrize("seed", range(4))
def test_randomized_corpus_same_rows_and_order(seed):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(50)]
    docs = [{"t": " ".join(rng.choice(vocab, size=rng.integers(0, 30)))}
            for _ in range(300)]
    ref = RefBM25(docs, text_col="t", native=False)
    python = PortBM25(docs, text_col="t", native=False)
    native_ = PortBM25(docs, text_col="t")
    for q in range(20):
        query = " ".join(np.random.default_rng(100 * seed + q).choice(
            vocab + ["zz"], size=3))
        want = ref.search(query, top_k=10)
        assert_same(python.search(query, top_k=10), want)
        assert native_.search(query, top_k=10) == python.search(
            query, top_k=10)


def test_tied_documents_order_by_row():
    docs = [{"t": "alpha beta"}, {"t": "gamma"}, {"t": "beta alpha"},
            {"t": "alpha beta"}]
    want = RefBM25(docs, text_col="t", native=False).search("alpha", top_k=4)
    assert [r for r, _ in want] == [0, 2, 3]
    for index in (PortBM25(docs, text_col="t"),
                  PortBM25(docs, text_col="t", native=False)):
        assert_same(index.search("alpha", top_k=4), want)


def test_topk_truncation_and_positive_only(trio):
    ref, python, native_ = trio
    for index in (python, native_):
        out = index.search("story", top_k=2)
        assert len(out) == 2 and all(s > 0 for _, s in out)
        assert_same(out, ref.search("story", top_k=2))
        everything = index.search("story", top_k=10)
        assert {r for r, _ in everything} == {0, 2, 5}


def test_text_column_detected_and_missing():
    rows = [{}, {"n": 3, "title": "heat wave"}, {"n": 4, "title": "wave"}]
    for native_flag in (True, False):
        index = PortBM25(rows, native=native_flag)
        assert index.text_col == "title"
        assert [r for r, _ in index.search("wave", top_k=5)] == [2, 1]
        assert PortBM25([{"n": 1}], native=native_flag).search("x") == []


def test_failed_native_build_raises(monkeypatch):
    """No quiet fallback: the Python path runs only under native=False."""
    from xfmr_rec_torch.native import bm25_native

    def broken(source):
        msg = f"g++ failed to build {source}"
        raise RuntimeError(msg)

    monkeypatch.setattr(bm25_native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PortBM25(list(DOCS), text_col="text")
    assert PortBM25(list(DOCS), text_col="text", native=False).search("heat")


def test_index_search_text_matches_oracle():
    rng = np.random.default_rng(5)
    n = 64
    meta = [{"movie_text": f"movie {'heat' if i % 7 == 0 else 'cold'} {i}",
             "movie_rn": i + 1} for i in range(n)]
    index = PortIndex(rng.normal(size=(n, 8)).astype(np.float32),
                      np.arange(100, 100 + n), meta, id_col="movie_id",
                      device="cpu")
    want = RefBM25(meta, native=False).search("heat movie", top_k=5)
    got = index.search_text("heat movie", top_k=5)
    assert [g["movie_id"] for g in got] == [100 + r for r, _ in want]
    assert [g["movie_text"] for g in got] == [meta[r]["movie_text"]
                                              for r, _ in want]
    np.testing.assert_allclose([g["score"] for g in got],
                               [s for _, s in want], rtol=1e-5)
    # the lazy index is kept between calls and rebuilt for another column
    fts = index._fts
    index.search_text("cold", top_k=3)
    assert index._fts is fts
    assert index.search_text("3", top_k=3, text_col="movie_text")
    assert index._fts is not fts
