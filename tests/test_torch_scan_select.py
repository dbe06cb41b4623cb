"""Port parity: the fused packed scan + lane-pair merge + select, and
`selector="fused"` through the packed top-k functions.

Same f32-exact inputs as test_torch_packed_scan.py, so both packages
build the same keys; merge and select are integer work with a defined
lane order, so the raw (B, capacity) keys, the lanes and the discard-max
must be equal bit for bit. The JAX side runs its fused Pallas kernel in
interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_guaranteed import assert_same_selection, both
from tests.test_torch_kernels_cuda import exact_inputs
from xfmr_rec_torch.ops import kernels
from xfmr_rec_torch.ops import topk as port
from xfmr_rec_tpu.ops import topk_pallas as ref

FUSED_CASES = {
    "keep2_level0": dict(merge_levels=0),
    "keep2_level1": dict(merge_levels=1),
    "keep2_level2": dict(merge_levels=2),
    "keep3": dict(merge_levels=1, merge_keep=3),
    "keep3_clamped_to_level0": dict(merge_levels=0, merge_keep=3),
    "keep3_shuffle1": dict(merge_levels=1, merge_keep=3, lane_shuffle=1),
    "keep2_level1_shuffle3": dict(merge_levels=1, lane_shuffle=3),
    "keep3_padding": dict(merge_levels=1, merge_keep=3, true_num_items=1800),
    "keep2_padding_shuffle": dict(
        merge_levels=1, true_num_items=1500, lane_shuffle=5
    ),
    "keep3_int8": dict(merge_levels=1, merge_keep=3, int8=True),
    "keep2_int8_shuffle": dict(merge_levels=2, int8=True, lane_shuffle=1),
    "keep3_bias_in_dot": dict(merge_levels=1, merge_keep=3, bias_in_dot=True),
    "keep3_bf16": dict(merge_levels=1, merge_keep=3, dtype="bfloat16"),
    "keep3_capacity256": dict(merge_levels=1, merge_keep=3, capacity=256),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_packed_lane_scan_select_bit_exact(case):
    opts = dict(FUSED_CASES[case])
    int8 = opts.pop("int8", False)
    dtype = "bfloat16" if int8 else opts.pop("dtype", "float32")
    q, c, scales, bound = exact_inputs(
        sum(map(ord, case)), 8, 2048, 16, int8=int8
    )
    if opts.get("bias_in_dot"):
        c = np.concatenate([c, np.full((len(c), 1), 1.5, c.dtype)], axis=1)
    torch_dtype = getattr(torch, dtype)
    kw = dict(score_bound=bound, batch_tile=8, corpus_tile=256, **opts)
    want = ref.packed_lane_scan_select(
        jnp.asarray(q, dtype),
        jnp.asarray(c, np.int8 if int8 else dtype),
        100,
        scales=None if scales is None else jnp.asarray(scales),
        interpret=True,
        **kw,
    )
    got = port.packed_lane_scan_select(
        torch.from_numpy(q).to(torch_dtype),
        torch.from_numpy(c).to(torch.int8 if int8 else torch_dtype),
        100,
        scales=None if scales is None else torch.from_numpy(scales),
        **kw,
    )
    names = ("sel_keys", "sel_lanes", "dmax")
    for name, g, w in zip(names, got, want, strict=True):
        assert g.shape == w.shape and g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[0].shape == (8, opts.get("capacity", 128))


def test_packed_lane_scan_select_rejects_bad_geometry():
    q = torch.zeros((8, 16))
    c = torch.zeros((2048, 16))
    with pytest.raises(ValueError, match="tile evenly"):
        port.packed_lane_scan_select(q, torch.zeros((200, 16)), 5,
                                     corpus_tile=128)
    with pytest.raises(ValueError, match="need 0 <"):
        port.packed_lane_scan_select(q, c, 200, corpus_tile=256, capacity=128)
    with pytest.raises(ValueError, match="multiples of 128"):
        port.packed_lane_scan_select(q, c, 5, corpus_tile=256, capacity=100)
    with pytest.raises(ValueError, match="mantissa"):
        port.packed_lane_scan_select(q, c, 5, corpus_tile=256, idx_bits=19,
                                     merge_levels=2)
    with pytest.raises(ValueError, match="trailing"):
        port.packed_lane_scan_select(q, c, 5, corpus_tile=256,
                                     bias_in_dot=True)
    with pytest.raises(ValueError, match="exceeds the merged pool"):
        port.packed_lane_scan_select(q, torch.zeros((128, 16)), 5,
                                     corpus_tile=64, capacity=256)


@pytest.mark.parametrize(
    "levels,keep", [(0, 2), (1, 2), (2, 2), (1, 3)]
)
def test_packed_certified_topk_fused(levels, keep):
    q, c, _, bound = exact_inputs(300 + levels + keep, 8, 2048, 16)
    (jq, jc, _), (tq, tc, _) = both(q, c)
    kw = dict(
        score_bound=bound, batch_tile=8, corpus_tile=256,
        merge_levels=levels, merge_keep=keep, recompute_scores=False,
        selector="fused",
    )
    want = ref.packed_certified_topk(jq, jc, 10, interpret=True, **kw)
    got = port.packed_certified_topk(tq, tc, 10, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert_same_selection(got[0], want[0], got[1], want[1])
    # the fused selection equals the two-kernel one at the key quantum
    two = port.packed_certified_topk(tq, tc, 10, **{**kw,
                                                    "selector": "threshold"})
    np.testing.assert_array_equal(got[0].numpy(), two[0].numpy())
    np.testing.assert_array_equal(got[2].numpy(), two[2].numpy())


def test_fused_selector_goes_through_the_fused_function(monkeypatch):
    """`selector="fused"` calls `packed_lane_scan_select` once and the
    two-kernel functions never; "auto" keeps the two-kernel path."""
    calls = {"fused": 0, "scan": 0, "select": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(port, "packed_lane_scan_select",
                        counting("fused", port.packed_lane_scan_select))
    monkeypatch.setattr(port, "packed_lane_scan",
                        counting("scan", port.packed_lane_scan))
    monkeypatch.setattr(port, "select_topk_keys",
                        counting("select", port.select_topk_keys))
    q, c, _, bound = exact_inputs(310, 8, 2048, 16)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    kw = dict(score_bound=bound, batch_tile=8, corpus_tile=256,
              merge_levels=1, merge_keep=3)
    port.packed_certified_parts(tq, tc, 10, selector="fused", **kw)
    assert calls == {"fused": 1, "scan": 0, "select": 0}
    port.packed_certified_parts(tq, tc, 10, selector="auto", **kw)
    assert calls == {"fused": 1, "scan": 1, "select": 0}  # pool 384 < 4 * 128
    port.packed_certified_parts(tq, tc, 10, selector="auto",
                                **{**kw, "corpus_tile": 512})
    assert calls == {"fused": 1, "scan": 2, "select": 1}  # pool 768
    # without discards the fused selector runs as "topk" (the fused
    # kernel always tracks them)
    keys, _, dmax = port.packed_certified_parts(
        tq, tc, 10, selector="fused", track_discards=False, **kw
    )
    assert dmax is None and calls == {"fused": 1, "scan": 3, "select": 1}
    assert kernels.launch_counts()["packed_scan_select"] == 0  # CPU: plain


@pytest.mark.parametrize("keep", [2, 3])
def test_packed_topk_excluding_fused(keep):
    q, c, _, bound = exact_inputs(320 + keep, 6, 1024, 16)
    rng = np.random.default_rng(keep)
    excl = rng.integers(0, 1100, size=(6, 8)).astype(np.int32)
    (jq, jc, _), (tq, tc, _) = both(q, c)
    kw = dict(
        score_bound=bound, batch_tile=8, corpus_tile=128, merge_levels=1,
        merge_keep=keep, true_num_items=1000, selector="fused",
    )
    want_s, want_p = ref.packed_topk_excluding(
        jq, jc, 12, exclude_positions=jnp.asarray(excl), interpret=True, **kw
    )
    got_s, got_p = port.packed_topk_excluding(
        tq, tc, 12, exclude_positions=torch.from_numpy(excl), **kw
    )
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert_same_selection(got_s, want_s, got_p, want_p)


def test_packed_guaranteed_topk_fused_forced_retry():
    """Four copies of a row's query in one lane of four tiles: pass 1
    evicts two, the shuffled retry separates them."""
    ct = 256  # a keep-3 pool of 3 * 128 lanes, a multiple of 128
    q, c, _, _ = exact_inputs(330, 16, 2048, 16)
    for row in range(4):
        for tile in range(4):
            c[row + tile * ct] = q[row]
    bound = float(2.0 ** np.ceil(np.log2(np.abs(q @ c.T).max() + 1e-3)))
    (jq, jc, _), (tq, tc, _) = both(q, c)
    kw = dict(
        score_bound=bound, batch_tile=8, corpus_tile=ct, retry_width=8,
        retries=2, selector="fused",
    )
    pass1 = port.packed_certified_topk(
        tq, tc, 10, score_bound=bound, batch_tile=8, corpus_tile=ct,
        merge_levels=1, merge_keep=3, selector="fused",
    )
    assert not pass1[2][:4].any()  # the planted rows fail pass 1
    want = ref.packed_guaranteed_topk(jq, jc, 10, interpret=True, **kw)
    got = port.packed_guaranteed_topk(tq, tc, 10, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].all()  # retries certified them
