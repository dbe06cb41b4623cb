"""Port parity: the IVF index (`xfmr_rec_torch/index/ivf.py`) against
`xfmr_rec_tpu/index/ivf.py` on the CPU.

Same seeded numpy inputs through both packages:
- `kmeans` on separable clusters: assignments equal, centroids within
  1e-5 (f32 sums in another order);
- `assign_with_spill` from the same centroids (duplicate centroids make
  ties): equal placement;
- the layout restored from the JAX index's centroids and assignment:
  buckets, positions, radii, max_row_norm and fill equal;
- `search` / `search_certified` at f32 and bf16, with and without
  exclusions: ids equal, scores within 1e-6 (f32 dots summed in another
  order; at bf16 the same, the rows and the rounded query being equal),
  `exact` flags equal;
- `recall_probe` equal; caches written by either package load in the
  other.
The reference returns excluded ids when the probed pool minus the
exclusions is smaller than top_k (ROADMAP.md, Queue 3); the port returns
-1 there, and that fault is pinned here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmr_rec_torch.index import ivf as port
from xfmr_rec_tpu.index import ivf as ref

CPU = "cpu"


def normed(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def clustered(n=2000, d=16, centers=16, sigma=0.08, seed=0):
    """The reference certified test's recipe (tests/test_ivf.py)."""
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(centers, d))
    mus /= np.linalg.norm(mus, axis=1, keepdims=True)
    assign = rng.integers(0, centers, n)
    x = mus[assign] + sigma * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), mus


def near_queries(mus, count, seed):
    rng = np.random.default_rng(seed)
    q = mus[rng.integers(0, len(mus), count)] + 0.05 * rng.normal(
        size=(count, mus.shape[1])
    )
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("tile", [40, 64, 4096])
def test_kmeans_separable_matches_reference(tile):
    rng = np.random.default_rng(1)
    centers = normed(3, 16, seed=2) * 10
    points = np.concatenate(
        [centers[i] + 0.05 * rng.normal(size=(40, 16)) for i in range(3)]
    ).astype(np.float32)
    points /= np.linalg.norm(points, axis=-1, keepdims=True)
    want_c, want_a = ref.kmeans(jnp.asarray(points), 3, iters=8, tile=tile)
    got_c, got_a = port.kmeans(points, 3, iters=8, tile=tile, device=CPU)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)


@pytest.mark.parametrize("iters", [0, 3, 10])
def test_kmeans_clustered_and_empty_clusters(iters):
    # 24 clusters over 300 points from 6 centres: some clusters empty
    points, _ = clustered(n=300, d=8, centers=6, seed=3)
    points[17] = 0.0  # an all-zero row stays out of the sums
    want_c, want_a = ref.kmeans(jnp.asarray(points), 24, iters=iters, tile=64)
    got_c, got_a = port.kmeans(points, 24, iters=iters, tile=64, device=CPU)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)
    assert np.isfinite(got_c.numpy()).all()


@pytest.mark.parametrize("cap", [1, 30, 90])
def test_spill_matches_reference(cap):
    corpus, _ = clustered(n=600, d=8, centers=5, seed=4)
    centroids = np.asarray(ref.kmeans(jnp.asarray(corpus), 12, iters=4)[0])
    # duplicate centroids: every item ties between the copies
    centroids = np.concatenate([centroids, centroids[:4]])
    want = ref.assign_with_spill(
        jnp.asarray(corpus), jnp.asarray(centroids), cap, tile=256
    )
    got = port.assign_with_spill(corpus, centroids, cap, tile=256,
                                 device=CPU)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nprobe", [1, 2, 3, 5])
def test_probe_ties_break_like_lax(nprobe):
    """Duplicated centroids tie in every query's cluster scores: both
    packages probe the lower cluster index first (the copies' buckets are
    empty, so a wrong order finds fewer items)."""
    corpus, mus = clustered(n=400, d=8, centers=4, seed=13)
    want = ref.IVFIndex(corpus, np.arange(400), num_clusters=4,
                        dtype="float32")
    centroids = np.asarray(want.centroids)
    restore = {"centroids": np.concatenate([centroids[::-1], centroids]),
               "assign": want._assign.astype(np.int32) + 4}
    want = ref.IVFIndex(corpus, np.arange(400), nprobe=nprobe,
                        dtype="float32", _restore=restore)
    got = port.IVFIndex(corpus, np.arange(400), nprobe=nprobe,
                        dtype="float32", _restore=restore, device=CPU)
    queries = near_queries(mus, 16, seed=14)
    for search in ("search", "search_certified"):
        want_out = getattr(want, search)(queries, top_k=12)
        got_out = getattr(got, search)(queries, top_k=12)
        for w, g in zip(want_out, got_out, strict=True):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """The JAX index over a clustered corpus and the port's restored
    from its centroids and assignment (spill on: 40 clusters, factor
    1.5)."""
    corpus, mus = clustered()
    ids = np.arange(len(corpus)) + 7
    want = ref.IVFIndex(corpus, ids, num_clusters=40, nprobe=3,
                        spill_factor=1.5, dtype=request.param)
    got = port.IVFIndex(
        corpus, ids, nprobe=3, dtype=request.param, device=CPU,
        _restore={"centroids": np.asarray(want.centroids),
                  "assign": want._assign},
    )
    return want, got, mus


def test_layout_equal(pair):
    want, got, _ = pair
    np.testing.assert_array_equal(
        got.buckets.float().numpy(), np.asarray(want.buckets, np.float32)
    )
    np.testing.assert_array_equal(
        got.positions.numpy(), np.asarray(want.positions)
    )
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    assert got.max_row_norm == want.max_row_norm
    assert (got.fill, got.bucket_size) == (want.fill, want.bucket_size)


def test_radii_in_blocks_equal(pair, monkeypatch):
    """The radii and max row norm a few clusters at a time (the host copy
    is bounded) equal the reference's one-shot numpy arithmetic."""
    want, got, _ = pair
    # three clusters a block (D=16, f32)
    monkeypatch.setattr(port, "_RADII_BLOCK_BYTES",
                        3 * got.bucket_size * 16 * 4)
    blocked = port.IVFIndex(
        got._embeddings_f32, got.ids, dtype=got.dtype, device=CPU,
        _restore={"centroids": np.asarray(want.centroids),
                  "assign": want._assign},
    )
    np.testing.assert_array_equal(blocked.radii.numpy(),
                                  np.asarray(want.radii))
    assert blocked.max_row_norm == want.max_row_norm


def test_build_matches_reference_build(pair):
    """The port's own build (k-means, spill, layout) gives the
    reference's assignment from the same corpus and seed."""
    want, got, _ = pair
    built = port.IVFIndex(got._embeddings_f32, got.ids, num_clusters=40,
                          spill_factor=1.5, dtype=got.dtype, device=CPU)
    np.testing.assert_array_equal(built._assign, want._assign)
    np.testing.assert_array_equal(
        built.positions.numpy(), np.asarray(want.positions)
    )


@pytest.mark.parametrize("nprobe", [1, 3, 40])
@pytest.mark.parametrize("excluded", [False, True])
def test_search_matches_reference(pair, nprobe, excluded):
    want, got, mus = pair
    queries = near_queries(mus, 24, seed=6)
    rng = np.random.default_rng(7)
    excl = (
        [[int(i) for i in rng.choice(got.ids, 5, replace=False)]
         for _ in queries]
        if excluded
        else None
    )
    want_s, want_i = want.search(queries, top_k=10, nprobe=nprobe,
                                 exclude_ids=excl)
    got_s, got_i = got.search(queries, top_k=10, nprobe=nprobe,
                              exclude_ids=excl)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, np.asarray(want_s), atol=1e-6)
    assert got_s.dtype == np.float32
    want_s, want_i, want_x = want.search_certified(
        queries, top_k=10, nprobe=nprobe, exclude_ids=excl)
    got_s, got_i, got_x = got.search_certified(
        queries, top_k=10, nprobe=nprobe, exclude_ids=excl)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, np.asarray(want_s), atol=1e-6)
    np.testing.assert_array_equal(got_x, np.asarray(want_x))
    if nprobe == 40:
        assert got_x.all()  # every cluster probed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_certified_rows_equal_dense_top_k(dtype):
    """The reference certified test's setting (16 clusters, nprobe 4):
    each certified row is the dense top-k over the served rows."""
    corpus, mus = clustered()
    got = port.IVFIndex(corpus, np.arange(len(corpus)), num_clusters=16,
                        nprobe=4, dtype=dtype, device=CPU)
    queries = near_queries(mus, 32, seed=8)
    _, ids, exact = got.search_certified(queries, top_k=5)
    assert exact.any()
    served = torch.from_numpy(corpus).to(got.buckets.dtype).float().numpy()
    q = torch.from_numpy(queries).to(got.buckets.dtype).float().numpy()
    dense = q @ served.T
    for b in np.flatnonzero(exact):
        kth = np.sort(dense[b])[-5]
        assert (dense[b, ids[b]] >= kth - 1e-6).all()


def test_recall_probe_equal(pair):
    want, got, _ = pair
    for nprobe in (1, 3):
        assert got.recall_probe(nprobe=nprobe) == want.recall_probe(
            nprobe=nprobe)


def test_jax_cache_loads_in_port(pair, tmp_path):
    want, _, mus = pair
    want.save(tmp_path)
    got = port.IVFIndex.load(tmp_path, device=CPU)
    assert got.dtype == str(want.buckets.dtype) and got.nprobe == want.nprobe
    queries = near_queries(mus, 8, seed=9)
    np.testing.assert_array_equal(got.search(queries, top_k=6)[1],
                                  want.search(queries, top_k=6)[1])


def test_port_cache_loads_in_jax(pair, tmp_path):
    _, got, mus = pair
    got.save(tmp_path)
    want = ref.IVFIndex.load(tmp_path)
    assert str(want.buckets.dtype) == got.dtype
    np.testing.assert_array_equal(want._assign, got._assign)
    np.testing.assert_array_equal(
        np.load(tmp_path / "ivf.npz")["embeddings"], got._embeddings_f32)
    queries = near_queries(mus, 8, seed=10)
    np.testing.assert_array_equal(got.search(queries, top_k=6)[1],
                                  want.search(queries, top_k=6)[1])


def _leak_setup():
    """64 unit vectors, 8 clusters, one probed: the probed bucket holds
    fewer real items than top_k=20."""
    corpus = normed(64, 16, seed=11)
    ids = np.arange(100, 164)
    query = corpus[:1]
    return corpus, ids, query


def test_reference_ivf_exclusion_leak_pinned():
    corpus, ids, query = _leak_setup()
    index = ref.IVFIndex(corpus, ids, num_clusters=8, nprobe=1,
                         dtype="float32")
    _, got = index.search(query, top_k=20)
    pool = [int(i) for i in got[0] if i != -1]
    assert 0 < len(pool) < 20
    scores, leaked = index.search(query, top_k=20, exclude_ids=[pool])
    # the excluded ids come back, each at -inf
    assert set(pool) <= set(leaked[0].tolist())
    assert np.isneginf(np.asarray(scores)[0][np.isin(leaked[0], pool)]).all()


@pytest.mark.parametrize("certified", [False, True])
def test_port_never_returns_excluded_ids(certified):
    corpus, ids, query = _leak_setup()
    index = port.IVFIndex(corpus, ids, num_clusters=8, nprobe=1,
                          dtype="float32", device=CPU)
    want = ref.IVFIndex(corpus, ids, num_clusters=8, nprobe=1,
                        dtype="float32")
    _, got = index.search(query, top_k=20)
    np.testing.assert_array_equal(got, want.search(query, top_k=20)[1])
    pool = [int(i) for i in got[0] if i != -1]
    search = index.search_certified if certified else index.search
    out = search(query, top_k=20, exclude_ids=[pool[:-1]])
    # one column a bucket slot (k' = min(top_k, nprobe * bucket))
    assert out[1][0].tolist() == [pool[-1]] + [-1] * (got.shape[1] - 1)
    assert np.isneginf(out[0][0][1:]).all()


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    corpus = normed(32, 8, seed=12)
    with pytest.raises(RuntimeError, match="cuda"):
        port.IVFIndex(corpus, np.arange(32))
    with pytest.raises(RuntimeError, match="cuda"):
        port.kmeans(corpus, 4)
