"""Port parity: packed lane scan, lane-pair merges, position decode.

Inputs are made with numpy from a seed and fed to both packages. Every
value is a small integer times a power of two, so each product and each
partial sum is exact in f32: the accumulation order cannot move a key,
and keys and discard-maxes must agree bit for bit. The JAX side runs its
Pallas kernel in interpret mode, as tests/test_topk_pallas.py does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import exact_inputs
from xfmr_rec_torch.ops import topk as port
from xfmr_rec_tpu.ops import topk_pallas as ref


SCAN_CASES = {
    "plain": dict(),
    "shuffle1": dict(lane_shuffle=1),
    "shuffle3_reserve1": dict(lane_shuffle=3, reserve_bits=1),
    "no_discards": dict(track_discards=False),
    "shuffle1_no_discards": dict(lane_shuffle=1, track_discards=False),
    "true_num_items": dict(true_num_items=300),
    "true_num_items_shuffle": dict(true_num_items=300, lane_shuffle=1),
    "reserve2": dict(reserve_bits=2),
    "bias_in_dot": dict(bias_in_dot=True),
    "int8_scales": dict(int8=True),
    "int8_scales_shuffle": dict(int8=True, lane_shuffle=1),
    "bf16": dict(dtype="bfloat16"),
    "bf16_shuffle_padding": dict(
        dtype="bfloat16", lane_shuffle=5, true_num_items=450
    ),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_packed_lane_scan_bit_exact(case):
    opts = dict(SCAN_CASES[case])
    int8 = opts.pop("int8", False)
    dtype = opts.pop("dtype", "float32")
    q, c, scales, bound = exact_inputs(
        sum(map(ord, case)), 8, 512, 16, int8=int8
    )
    if int8:
        dtype = "bfloat16"
    if opts.get("bias_in_dot"):
        c = np.concatenate([c, np.full((len(c), 1), 1.5, c.dtype)], axis=1)
    corpus_dtype = np.int8 if int8 else dtype
    kw = dict(score_bound=bound, batch_tile=8, corpus_tile=128, **opts)
    want_keys, want_dmax = ref.packed_lane_scan(
        jnp.asarray(q, dtype),
        jnp.asarray(c, corpus_dtype),
        scales=None if scales is None else jnp.asarray(scales),
        interpret=True,
        **kw,
    )
    torch_dtype = getattr(torch, dtype)
    got_keys, got_dmax = port.packed_lane_scan(
        torch.from_numpy(q).to(torch_dtype),
        torch.from_numpy(c).to(torch.int8 if int8 else torch_dtype),
        scales=None if scales is None else torch.from_numpy(scales),
        **kw,
    )
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    if opts.get("track_discards", True):
        np.testing.assert_array_equal(
            got_dmax.numpy(), np.asarray(want_dmax)
        )
    else:
        assert got_dmax is None and want_dmax is None
    # keys are non-negative int32 throughout (no int64 promotion)
    assert got_keys.dtype == torch.int32
    assert (got_keys >= 0).all()


def test_query_rounding_matches_reference():
    """The query is scaled in f32 and rounded back to bf16 before the
    dot (topk_pallas.py:782-783); a bound that is not a power of two
    makes that rounding visible in the keys."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    c = rng.integers(-8, 9, size=(256, 16)).astype(np.float32) / 16
    kw = dict(score_bound=3.3, batch_tile=8, corpus_tile=128)
    want, _ = ref.packed_lane_scan(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
        interpret=True, **kw,
    )
    got, _ = port.packed_lane_scan(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(c).bfloat16(), **kw
    )
    # products of two bf16 values are exact in f32; sums of 16 of them
    # can round, so compare at the key quantum (2 tiles -> idx_bits 1)
    np.testing.assert_array_equal(
        got.numpy() >> 1, np.asarray(want) >> 1
    )


def test_rejects_bad_geometry():
    q = torch.zeros((8, 16))
    c = torch.zeros((200, 16))
    with pytest.raises(ValueError, match="tile evenly"):
        port.packed_lane_scan(q, c, corpus_tile=128)
    with pytest.raises(ValueError, match="trailing"):
        port.packed_lane_scan(
            q, torch.zeros((128, 16)), bias_in_dot=True, corpus_tile=128
        )


def _sorted_key_pairs(seed, batch, width):
    rng = np.random.default_rng(seed)
    raw = rng.integers(1 << 8, 1 << 30, size=(2, batch, width))
    raw = (raw & ~np.int64(3)).astype(np.int32)  # low bits for stamps
    return np.maximum(raw[0], raw[1]), np.minimum(raw[0], raw[1])


@pytest.mark.parametrize("level", [0, 1])
def test_merge_lane_pairs(level):
    key1, key2 = _sorted_key_pairs(20 + level, 4, 32)
    want = ref.merge_lane_pairs(jnp.asarray(key1), jnp.asarray(key2), level)
    got = port.merge_lane_pairs(
        torch.from_numpy(key1), torch.from_numpy(key2), level
    )
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_lane_pairs3():
    key1, key2 = _sorted_key_pairs(30, 4, 32)
    want = ref.merge_lane_pairs3(jnp.asarray(key1), jnp.asarray(key2), 0)
    got = port.merge_lane_pairs3(
        torch.from_numpy(key1), torch.from_numpy(key2), 0
    )
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "shuffle,levels", [(0, 0), (1, 0), (3, 1), (5, 2)]
)
def test_unpack_positions(shuffle, levels):
    rng = np.random.default_rng(40 + shuffle)
    ct, idx_bits = 64, 4
    keys = rng.integers(0, 1 << 30, size=(4, 10)).astype(np.int32)
    lanes = rng.integers(0, 2 * (ct >> levels), size=(4, 10)).astype(
        np.int32
    )
    kw = dict(
        corpus_tile=ct, idx_bits=idx_bits, lane_shuffle=shuffle,
        reserve_bits=levels, merge_levels=levels,
    )
    want = ref.unpack_positions(jnp.asarray(keys), jnp.asarray(lanes), **kw)
    got = port.unpack_positions(
        torch.from_numpy(keys), torch.from_numpy(lanes), **kw
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "num_items,dim", [(100, 64), (1 << 20, 64), (1 << 20, 384), (5000, 8)]
)
def test_pick_corpus_tile(num_items, dim):
    assert port.pick_corpus_tile(num_items, dim) == ref.pick_corpus_tile(
        num_items, dim
    )


def test_decode_scores_matches_reference():
    f = np.random.default_rng(50).uniform(1.25, 1.75, size=(4, 16))
    keys = f.astype(np.float32).view(np.int32)
    want = ref.decode_scores(
        jnp.asarray(keys), idx_bits=5, score_bound=2.5, reserve_bits=1
    )
    got = port.decode_scores(
        torch.from_numpy(keys), idx_bits=5, score_bound=2.5, reserve_bits=1
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
