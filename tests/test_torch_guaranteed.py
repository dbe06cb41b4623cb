"""Port parity: certified, exclusion and guaranteed packed searches.

Same f32-exact inputs as test_torch_packed_scan.py, so both packages
build the same keys; every later step (merges, selection, retries,
dedupe) is integer work with a defined tie order, so keys and `exact`
must be equal and positions equal wherever a row's key is unique.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmr_rec_torch.ops import topk as port
from xfmr_rec_tpu.ops import topk_pallas as ref
from tests.test_torch_kernels_cuda import exact_inputs


def assert_same_selection(got_keys, want_keys, got_pos, want_pos):
    got_keys, want_keys = np.asarray(got_keys), np.asarray(want_keys)
    got_pos, want_pos = np.asarray(got_pos), np.asarray(want_pos)
    np.testing.assert_array_equal(got_keys, want_keys)
    for row in range(got_keys.shape[0]):
        values, counts = np.unique(got_keys[row], return_counts=True)
        unique = np.isin(got_keys[row], values[counts == 1])
        np.testing.assert_array_equal(
            got_pos[row][unique], want_pos[row][unique]
        )


def both(q, c, scales=None):
    return (
        (jnp.asarray(q), jnp.asarray(c),
         None if scales is None else jnp.asarray(scales)),
        (torch.from_numpy(q), torch.from_numpy(c),
         None if scales is None else torch.from_numpy(scales)),
    )


@pytest.mark.parametrize(
    "levels,keep,selector",
    [(0, 2, "topk"), (1, 2, "topk"), (1, 3, "threshold"), (1, 3, "auto"),
     (2, 2, "threshold")],
)
def test_packed_certified_topk(levels, keep, selector):
    q, c, _, bound = exact_inputs(60 + levels + keep, 8, 2048, 16)
    (jq, jc, _), (tq, tc, _) = both(q, c)
    kw = dict(
        score_bound=bound, batch_tile=8, corpus_tile=256,
        merge_levels=levels, merge_keep=keep, recompute_scores=False,
        selector=selector,
    )
    want = ref.packed_certified_topk(jq, jc, 10, interpret=True, **kw)
    got = port.packed_certified_topk(tq, tc, 10, **kw)
    # decoded scores are the keys' quantum floors: exact equality
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert_same_selection(got[0], want[0], got[1], want[1])


def test_packed_certified_topk_int8_recompute():
    q, c, scales, bound = exact_inputs(70, 8, 512, 16, int8=True)
    (jq, jc, js), (tq, tc, ts) = both(q, c, scales)
    kw = dict(score_bound=bound, batch_tile=8, corpus_tile=128)
    want = ref.packed_certified_topk(
        jq.astype(jnp.bfloat16), jc, 5, scales=js, interpret=True, **kw
    )
    got = port.packed_certified_topk(tq.bfloat16(), tc, 5, scales=ts, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("keep", [2, 3])
def test_packed_topk_excluding(keep):
    q, c, _, bound = exact_inputs(80 + keep, 6, 1024, 16)
    rng = np.random.default_rng(keep)
    excl = rng.integers(0, 1100, size=(6, 8)).astype(np.int32)
    (jq, jc, _), (tq, tc, _) = both(q, c)
    kw = dict(
        score_bound=bound, batch_tile=8, corpus_tile=128,
        merge_levels=1, merge_keep=keep, true_num_items=1000,
    )
    want_s, want_p = ref.packed_topk_excluding(
        jq, jc, 12, exclude_positions=jnp.asarray(excl), interpret=True, **kw
    )
    got_s, got_p = port.packed_topk_excluding(
        tq, tc, 12, exclude_positions=torch.from_numpy(excl), **kw
    )
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert_same_selection(got_s, want_s, got_p, want_p)
    for row in range(6):
        assert not set(got_p[row].tolist()) & set(excl[row].tolist())
        assert (got_p[row] < 1000).all()


def planted_collisions(seed):
    """Exact inputs where several of each row's best items share a lane
    across tiles, so pass 1 cannot certify those rows and must retry."""
    q, c, _, bound = exact_inputs(seed, 16, 512, 16)
    ct = 64
    for row in range(4):
        for tile in range(4):
            c[row + tile * ct] = q[row]
    scores = q @ c.T
    bound = 2.0 ** np.ceil(np.log2(np.abs(scores).max() + 1e-3))
    return q, c, float(bound), ct


def test_guaranteed_forced_retry():
    q, c, bound, ct = planted_collisions(90)
    (jq, jc, _), (tq, tc, _) = both(q, c)
    pass1 = port.packed_certified_topk(
        tq, tc, 10, score_bound=bound, batch_tile=8, corpus_tile=ct,
        merge_levels=1, merge_keep=3, recompute_scores=False,
    )
    assert not pass1[2][:4].any()  # the planted rows fail pass 1
    kw = dict(
        score_bound=bound, batch_tile=8, corpus_tile=ct, retry_width=8,
        retries=2,
    )
    want = ref.packed_guaranteed_topk(jq, jc, 10, interpret=True, **kw)
    got = port.packed_guaranteed_topk(tq, tc, 10, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2][:4].all()  # retries certified them
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize(
    "retry_width", [None, 8, (16,), (16, 8), np.int64(8)]
)
def test_guaranteed_retry_width_schedule(retry_width):
    q, c, bound, ct = planted_collisions(91)
    (jq, jc, _), (tq, tc, _) = both(q, c)
    kw = dict(
        score_bound=bound, batch_tile=8, corpus_tile=ct,
        retry_width=retry_width, retries=2, recompute_scores=True,
    )
    want = ref.packed_guaranteed_topk(jq, jc, 10, interpret=True, **kw)
    got = port.packed_guaranteed_topk(tq, tc, 10, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("batch", [16, 64, 256])
def test_retry_width_schedule_values(batch):
    for levels, keep in ((1, 3), (1, 2), (0, 3)):
        widths = port._retry_widths(batch, 3, levels, keep, None)
        assert len(widths) == 3
        assert all(w % 8 == 0 and w <= batch for w in widths)
    with pytest.raises(ValueError, match="non-empty"):
        port._retry_widths(batch, 2, 1, 3, ())


def test_dedupe_pool_keys():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 50, size=(4, 20)).astype(np.int32)
    pos = rng.integers(0, 8, size=(4, 20)).astype(np.int32)
    want = ref._dedupe_pool_keys(jnp.asarray(keys), jnp.asarray(pos))
    got = port._dedupe_pool_keys(torch.from_numpy(keys), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
