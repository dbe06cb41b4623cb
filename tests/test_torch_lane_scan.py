"""Port parity: the f32 lane-max scan and the top-k functions on it.

Inputs are made with numpy from a seed and fed to both packages. In the
bit-exact cases every value is a small integer times a power of two, so
each product and partial sum is exact in f32: values, positions and
discard-maxes must agree bit for bit whatever the accumulation order.
Random-input cases hold values to 1e-5 (f32 sums of 16-32 terms in
another order) and ids as sets. The JAX side runs its Pallas kernel in
interpret mode, as tests/test_topk_pallas.py does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import exact_inputs
from xfmr_rec_torch.ops import topk_f32 as port
from xfmr_rec_tpu.ops import topk_pallas as ref

SCAN_CASES = {
    "slots1": dict(slots=1),
    "slots2": dict(slots=2),
    "slots1_discards": dict(slots=1, track_discards=True),
    "slots2_discards": dict(slots=2, track_discards=True),
    "slots2_shuffle1": dict(slots=2, track_discards=True, lane_shuffle=1),
    "slots1_shuffle3": dict(slots=1, track_discards=True, lane_shuffle=3),
    "slots2_padding": dict(slots=2, track_discards=True, true_num_items=300),
    "slots2_padding_shuffle": dict(
        slots=2, track_discards=True, true_num_items=300, lane_shuffle=5
    ),
    "slots1_padding": dict(slots=1, true_num_items=450),
    "slots2_int8": dict(slots=2, track_discards=True, int8=True),
    "slots2_int8_shuffle": dict(
        slots=2, track_discards=True, int8=True, lane_shuffle=1
    ),
    "slots1_int8_padding": dict(slots=1, int8=True, true_num_items=400),
    "slots2_bf16": dict(slots=2, track_discards=True, dtype="bfloat16"),
    "slots2_bf16_shuffle_padding": dict(
        slots=2, track_discards=True, dtype="bfloat16", lane_shuffle=3,
        true_num_items=333,
    ),
}


def arrays(q, c, scales, dtype, int8):
    """The same numpy inputs as JAX arrays and as torch tensors."""
    torch_dtype = getattr(torch, dtype)
    ref_args = (
        jnp.asarray(q, dtype),
        jnp.asarray(c, np.int8 if int8 else dtype),
        None if scales is None else jnp.asarray(scales),
    )
    port_args = (
        torch.from_numpy(q).to(torch_dtype),
        torch.from_numpy(c).to(torch.int8 if int8 else torch_dtype),
        None if scales is None else torch.from_numpy(scales),
    )
    return ref_args, port_args


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_lane_max_scan_bit_exact(case):
    opts = dict(SCAN_CASES[case])
    int8 = opts.pop("int8", False)
    dtype = "bfloat16" if int8 else opts.pop("dtype", "float32")
    q, c, scales, _ = exact_inputs(sum(map(ord, case)), 8, 512, 16, int8=int8)
    # many equal scores: the strict-> tie rule decides the positions
    (jq, jc, js), (tq, tc, ts) = arrays(q, c, scales, dtype, int8)
    kw = dict(batch_tile=8, corpus_tile=128, **opts)
    want = ref.lane_max_scan(jq, jc, scales=js, interpret=True, **kw)
    got = port.lane_max_scan(tq, tc, scales=ts, **kw)
    assert len(got) == len(want) == (3 if opts.get("track_discards") else 2)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("slots", [1, 2])
def test_lane_max_scan_random(slots):
    rng = np.random.default_rng(100 + slots)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    c = rng.normal(size=(1024, 32)).astype(np.float32)
    kw = dict(batch_tile=8, corpus_tile=256, slots=slots, track_discards=True,
              lane_shuffle=1)
    want = ref.lane_max_scan(jnp.asarray(q), jnp.asarray(c), interpret=True,
                             **kw)
    got = port.lane_max_scan(torch.from_numpy(q), torch.from_numpy(c), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5,
                               atol=1e-5)
    # continuous scores: no ties, so positions agree outright
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_lane_max_scan_rejects_bad_arguments():
    q = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="tile evenly"):
        port.lane_max_scan(q, torch.zeros((200, 16)), corpus_tile=128)
    with pytest.raises(ValueError, match="tile evenly"):
        port.lane_max_scan(torch.zeros((12, 16)), torch.zeros((256, 16)),
                           batch_tile=8, corpus_tile=128)
    with pytest.raises(ValueError, match="slots must be 1 or 2"):
        port.lane_max_scan(q, torch.zeros((256, 16)), corpus_tile=128,
                           slots=3)
    with pytest.raises(ValueError, match="scales length"):
        port.lane_max_scan(q, torch.zeros((256, 16)), corpus_tile=128,
                           scales=torch.ones(100))


def test_empty_slots_are_neg_inf_at_position_zero():
    """One tile and two slots: slot 2 never fills; padded lanes neither."""
    q, c, _, _ = exact_inputs(3, 8, 128, 16)
    vals, pos = port.lane_max_scan(
        torch.from_numpy(q), torch.from_numpy(c), corpus_tile=128, slots=2,
        true_num_items=100,
    )
    assert torch.isneginf(vals[:, 128:]).all() and (pos[:, 128:] == 0).all()
    assert torch.isneginf(vals[:, 100:128]).all()
    assert (pos[:, 100:128] == 0).all()
    assert torch.isfinite(vals[:, :100]).all()


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("int8", [False, True])
def test_scan_topk_bit_exact(slots, int8):
    q, c, scales, _ = exact_inputs(110 + slots, 8, 1024, 16, int8=int8)
    dtype = "bfloat16" if int8 else "float32"
    (jq, jc, js), (tq, tc, ts) = arrays(q, c, scales, dtype, int8)
    kw = dict(batch_tile=8, corpus_tile=256, slots=slots, true_num_items=1000)
    want = ref.scan_topk(jq, jc, 10, scales=js, interpret=True, **kw)
    got = port.scan_topk(tq, tc, 10, scales=ts, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("batch", [6, 8, 13])
def test_scan_topk_excluding_bit_exact(batch):
    q, c, _, _ = exact_inputs(120 + batch, batch, 1024, 16)
    rng = np.random.default_rng(batch)
    excl = rng.integers(0, 1100, size=(batch, 8)).astype(np.int32)
    kw = dict(batch_tile=8, corpus_tile=128, true_num_items=1000)
    want_s, want_p = ref.scan_topk_excluding(
        jnp.asarray(q), jnp.asarray(c), 12,
        exclude_positions=jnp.asarray(excl), interpret=True, **kw,
    )
    got_s, got_p = port.scan_topk_excluding(
        torch.from_numpy(q), torch.from_numpy(c), 12,
        exclude_positions=torch.from_numpy(excl), **kw,
    )
    assert got_s.shape == (batch, 12)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    for row in range(batch):
        assert not set(got_p[row].tolist()) & set(excl[row].tolist())
        assert (got_p[row] < 1000).all()


def test_scan_topk_excluding_random_ids_as_sets():
    rng = np.random.default_rng(130)
    q = rng.normal(size=(8, 32)).astype(np.float32)
    c = rng.normal(size=(2048, 32)).astype(np.float32)
    excl = rng.integers(0, 2048, size=(8, 4)).astype(np.int32)
    kw = dict(batch_tile=8, corpus_tile=256)
    want_s, want_p = ref.scan_topk_excluding(
        jnp.asarray(q), jnp.asarray(c), 10,
        exclude_positions=jnp.asarray(excl), interpret=True, **kw,
    )
    got_s, got_p = port.scan_topk_excluding(
        torch.from_numpy(q), torch.from_numpy(c), 10,
        exclude_positions=torch.from_numpy(excl), **kw,
    )
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)
    for row in range(8):
        assert set(got_p[row].tolist()) == set(np.asarray(want_p)[row].tolist())


def test_scan_topk_excluding_slack_error_matches_reference():
    """k + E beyond the candidate pool of a corpus wider than the pool."""
    q = np.zeros((8, 16), np.float32)
    c = np.zeros((512, 16), np.float32)
    excl = np.zeros((8, 128), np.int32)
    kw = dict(batch_tile=8, corpus_tile=64, slots=2)
    with pytest.raises(ValueError, match="exceeds the candidate pool"):
        ref.scan_topk_excluding(
            jnp.asarray(q), jnp.asarray(c), 10,
            exclude_positions=jnp.asarray(excl), interpret=True, **kw,
        )
    with pytest.raises(ValueError, match="exceeds the candidate pool"):
        port.scan_topk_excluding(
            torch.from_numpy(q), torch.from_numpy(c), 10,
            exclude_positions=torch.from_numpy(excl), **kw,
        )
    # a corpus that fits the pool is covered exhaustively: no error
    small = np.zeros((128, 16), np.float32)
    got = port.scan_topk_excluding(
        torch.from_numpy(q), torch.from_numpy(small), 10,
        exclude_positions=torch.from_numpy(excl), **kw,
    )
    assert got[0].shape == (8, 10)


@pytest.mark.parametrize("shuffle", [0, 1, 3])
@pytest.mark.parametrize("int8", [False, True])
def test_certified_topk_parts_bit_exact(shuffle, int8):
    q, c, scales, _ = exact_inputs(140 + shuffle, 8, 1024, 16, int8=int8)
    dtype = "bfloat16" if int8 else "float32"
    (jq, jc, js), (tq, tc, ts) = arrays(q, c, scales, dtype, int8)
    kw = dict(batch_tile=8, corpus_tile=128, lane_shuffle=shuffle,
              true_num_items=900)
    want = ref.certified_topk_parts(jq, jc, 10, scales=js, interpret=True,
                                    **kw)
    got = port.certified_topk_parts(tq, tc, 10, scales=ts, **kw)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
