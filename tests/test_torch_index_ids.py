"""Port parity: stored item ids and exclusion padding in `RetrievalIndex`.

`search_certified` answers with the ids in their stored dtype, like the
reference: ids at or above 2^31 come back whole. Exclusion positions
below 0 are padding and are dropped on every search path of the port,
as its `_apply_exclusions` documents (the reference's dense path wraps
them instead; that path is not held here).
"""

import numpy as np
import pytest

from tests.test_torch_index import dyadic
from xfmr_rec_torch.index.mips import RetrievalIndex as PortIndex
from xfmr_rec_tpu.index.mips import RetrievalIndex as RefIndex


@pytest.mark.parametrize("method", ["f32", "packed", "fused"])
def test_search_certified_keeps_wide_ids(method):
    corpus = dyadic(20, 3000)
    ids = (1 << 33) + np.arange(len(corpus), dtype=np.int64)
    ref = RefIndex(corpus, ids, method="scan")
    port = PortIndex(corpus, ids, method="scan", device="cpu")
    queries = dyadic(21, 4)
    want_s, want_ids = ref.search_certified(queries, top_k=7, method=method)
    got_s, got_ids = port.search_certified(queries, top_k=7, method=method)
    assert got_ids.dtype == np.int64
    assert int(got_ids.min()) >= 1 << 33
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    np.testing.assert_array_equal(got_s, np.asarray(want_s))


@pytest.mark.parametrize("method", ["dense", "scan"])
def test_negative_exclusion_positions_are_dropped(method):
    n = 3000
    corpus = dyadic(22, n)
    queries = dyadic(23, 3)
    # a wrapped -1 would exclude the last item: make it every row's best
    corpus[n - 1] = 0.5 * np.sign(queries.sum(axis=0))
    queries[:, :] = np.abs(queries) * np.sign(queries.sum(axis=0))
    port = PortIndex(corpus, np.arange(n), method=method, device="cpu")
    excl = np.array([[-1, 5, -7], [-1, -1, -1], [0, 1, -2]], np.int32)
    padded = np.where(excl < 0, n, excl)
    got = port.search(queries, top_k=9, exclude_positions=excl)
    want = port.search(queries, top_k=9, exclude_positions=padded)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1][:, 0] == n - 1).all()
    unexcluded = port.search(queries, top_k=9)[1]
    np.testing.assert_array_equal(got[1][1], unexcluded[1])
