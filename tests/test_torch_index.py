"""Port parity: RetrievalIndex search, guaranteed search and persistence.

Corpus and queries hold multiples of 1/8 in [-1/2, 1/2] (with one row of
all 1/2, so both max norms are exact). Every dot product the two
packages compute is then exact in f32, in any order, and so are the
score bounds and keys: item ids must be identical, in order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmr_rec_torch.index.mips import RetrievalIndex as PortIndex
from xfmr_rec_torch.index.mips import exact_topk as port_exact_topk
from xfmr_rec_tpu.index.mips import RetrievalIndex as RefIndex
from xfmr_rec_tpu.index.mips import exact_topk as ref_exact_topk

DIM = 16


def dyadic(seed, rows):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=(rows, DIM)).astype(np.float32) / 8
    x[0] = 0.5
    return x


def build(n, seed, **kw):
    corpus = dyadic(seed, n)
    ids = np.arange(10, 10 + n)
    meta = [{"movie_text": f"item {i}"} for i in ids]
    return (
        RefIndex(corpus, ids, meta, id_col="movie_id", **kw),
        PortIndex(corpus, ids, meta, id_col="movie_id", device="cpu", **kw),
    )


@pytest.mark.parametrize(
    "kw",
    [
        dict(method="scan"),
        dict(method="scan", dtype="int8"),
        dict(method="dense"),
        dict(method="dense", dtype="float32", chunk_size=1000),
    ],
    ids=["scan-bf16", "scan-int8", "dense-bf16", "dense-f32-chunked"],
)
def test_search_same_ids(kw):
    ref, port = build(5000, 1, **kw)
    assert port.method == ref.method
    queries = dyadic(2, 5)
    excl = [[10, 11, 12], [], [4000], [10, 20, 30, 40, 50], [99999]]
    want_s, want_ids = ref.search(queries, top_k=10, exclude_ids=excl)
    got_s, got_ids = port.search(queries, top_k=10, exclude_ids=excl)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_s, want_s)
    for row, ex in enumerate(excl):
        assert not set(ex) & set(got_ids[row].tolist())


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("exact_scores", [False, True])
def test_search_certified_fused_same_ids(dtype, exact_scores):
    ref, port = build(5000, 3, method="scan", dtype=dtype)
    queries = dyadic(4, 5)
    want_s, want_ids = ref.search_certified(
        queries, top_k=10, method="fused", exact_scores=exact_scores
    )
    got_s, got_ids = port.search_certified(
        queries, top_k=10, method="fused", exact_scores=exact_scores
    )
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_s, want_s)
    assert port.last_certified_stats == ref.last_certified_stats


def test_search_certified_forced_collisions_exact():
    """Planted lane collisions force retries and possibly the dense
    residual; the result must equal the dense exact top-k."""
    corpus = dyadic(5, 4096) * 0.25
    queries = dyadic(6, 8)
    for i in range(8):
        corpus[i] = queries[i]
        corpus[i + 2048] = queries[i]
    ids = np.arange(4096)
    port = PortIndex(corpus, ids, method="scan", device="cpu")
    ref = RefIndex(corpus, ids, method="scan")
    got_s, got_ids = port.search_certified(
        queries, top_k=5, method="fused", exact_scores=True
    )
    want_s, want_ids = ref.search_certified(
        queries, top_k=5, method="fused", exact_scores=True
    )
    np.testing.assert_array_equal(got_ids, want_ids)
    dense = np.sort(queries @ corpus.T, axis=1)[:, ::-1][:, :5]
    np.testing.assert_allclose(got_s, dense, rtol=1e-6)


def test_exact_topk_exclusions_drop_padding():
    corpus = dyadic(7, 64)
    queries = dyadic(8, 4)
    excl = np.array([[0, 64, -1], [5, 6, 64], [64, 64, 64], [1, 2, 3]],
                    dtype=np.int32)
    want_s, want_p = ref_exact_topk(
        jnp.asarray(queries), jnp.asarray(corpus), 6,
        exclude_positions=jnp.asarray(np.where(excl < 0, 64, excl)),
    )
    got_s, got_p = port_exact_topk(
        torch.from_numpy(queries), torch.from_numpy(corpus), 6,
        exclude_positions=torch.from_numpy(excl),
    )
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_save_load_across_packages(tmp_path, dtype):
    ref, port = build(300, 9, method="scan", dtype=dtype)
    ref.save(tmp_path / "ref")
    port.save(tmp_path / "port")
    from_ref = PortIndex.load(tmp_path / "ref", device="cpu")
    from_port = RefIndex.load(tmp_path / "port")
    for a, b in ((from_ref, ref), (from_port, port)):
        assert a.method == b.method and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
        assert a.metadata == b.metadata
    np.testing.assert_array_equal(
        from_ref.corpus.float().numpy(), np.asarray(ref.corpus, np.float32)
    )
    np.testing.assert_array_equal(
        np.asarray(from_port.corpus, np.float32), port.corpus.float().numpy()
    )
    queries = dyadic(10, 4)
    np.testing.assert_array_equal(
        from_ref.search(queries, top_k=5)[1], ref.search(queries, top_k=5)[1]
    )


def test_unported_surfaces_raise():
    """add_items / remove_items are ported: the same mutation on both
    packages leaves the same ids and answers (tests/test_torch_mutation.py
    holds the rest)."""
    ref, port = build(300, 11, method="scan")
    extra = dyadic(12, 4)
    for index in (ref, port):
        index.add_items(extra, [1, 2, 3, 4],
                        metadata=[{"movie_text": "new"}] * 4)
        index.remove_items([10, 2])
    np.testing.assert_array_equal(port.ids, np.asarray(ref.ids))
    assert port.get_id(3) == ref.get_id(3) == {"movie_text": "new",
                                               "movie_id": 3}
    queries = dyadic(13, 4)
    got, want = port.search(queries, top_k=6), ref.search(queries, top_k=6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_auto_method_picks_scan_from_65536_items():
    small = PortIndex(np.zeros((8, 4)), np.arange(8), method="auto",
                      device="cpu")
    assert small.method == "dense"
    big = PortIndex(np.zeros((65536, 4), np.float32), np.arange(65536),
                    method="auto", device="cpu")
    assert big.method == "scan"
