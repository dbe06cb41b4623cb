"""The f32 lane-max scan with its corpus tiles split over blocks, on the CPU.

At small batches the CUDA kernel splits the corpus tiles into contiguous
ranges and merges the parts' slots in tile order. Here the plain PyTorch
version of that merge (`merge_lane_slots_plain`, through
`lane_max_scan_split_plain`) is held bit for bit against the unsplit
plain version and against the JAX package's Pallas kernel in interpret
mode, on inputs whose products and partial sums are exact in f32 and on
corpora built to tie; and the split plans of the lane scan's and the
count's block shapes are held to their contract. Inputs are made with
numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import exact_inputs, tied_corpus
from xfmr_rec_torch.ops import kernels
from xfmr_rec_torch.ops import topk_f32 as port
from xfmr_rec_tpu.ops import topk_pallas as ref

NUM_ITEMS, CORPUS_TILE = 1024, 128  # 8 tiles
SPLIT_CASES = {
    "slots1": dict(slots=1),
    "slots1_discards_shuffle3": dict(
        slots=1, track_discards=True, lane_shuffle=3
    ),
    "slots2": dict(slots=2),
    "slots2_discards": dict(slots=2, track_discards=True),
    "slots2_discards_shuffle1": dict(
        slots=2, track_discards=True, lane_shuffle=1
    ),
    "slots2_discards_shuffle3_padding": dict(
        slots=2, track_discards=True, lane_shuffle=3, true_num_items=900
    ),
    "slots1_padding": dict(slots=1, true_num_items=700),
    "slots2_int8_scales": dict(slots=2, track_discards=True, int8=True),
    "slots2_int8_scales_shuffle1_padding": dict(
        slots=2, track_discards=True, int8=True, lane_shuffle=1,
        true_num_items=1000,
    ),
    "slots2_f32": dict(slots=2, track_discards=True, f32=True),
}
# 1, 2, 3 (uneven: ranges of 2, 3 and 3 tiles), 5 (uneven) and one tile a
# split
SPLITS = [1, 2, 3, 5, NUM_ITEMS // CORPUS_TILE]


def scan_inputs(case, batch=8):
    opts = dict(SPLIT_CASES[case])
    int8 = opts.pop("int8", False)
    f32 = opts.pop("f32", False)
    q, c, scales, _ = exact_inputs(
        sum(map(ord, case)), batch, NUM_ITEMS, 16, int8=int8
    )
    dtype = torch.float32 if f32 else torch.bfloat16
    tq = torch.from_numpy(q).to(dtype)
    tc = torch.from_numpy(c) if int8 else torch.from_numpy(c).to(dtype)
    ts = None if scales is None else torch.from_numpy(scales)
    return tq, tc, ts, dict(corpus_tile=CORPUS_TILE, **opts)


def assert_same(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want, strict=True):
        if w is None:
            assert g is None
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_lane_split_equals_unsplit(case, splits):
    tq, tc, ts, kw = scan_inputs(case)
    want = port.lane_max_scan_plain(tq, tc, ts, **kw)
    got = port.lane_max_scan_split_plain(tq, tc, ts, splits, **kw)
    assert_same(got, want)
    if kw.get("track_discards"):
        # something was discarded, so the merge's share of dmax is tested
        assert bool(torch.isfinite(want[2]).all())


@pytest.mark.parametrize("splits", [2, 3, 4, 8])
@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_split_keeps_ties_of_repeated_rows(seed, slots, splits):
    """A corpus of three distinct rows: every lane sees the same few
    scores over its tiles, so the earlier-tile rule and the history the
    contest keeps decide most slots, across every split boundary."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 9, size=(8, 16)).astype(np.float32) / 16
    tq = torch.from_numpy(q).bfloat16()
    tc = torch.from_numpy(tied_corpus(seed, NUM_ITEMS, 16)).bfloat16()
    kw = dict(corpus_tile=CORPUS_TILE, slots=slots, track_discards=True,
              lane_shuffle=seed)
    want = port.lane_max_scan_plain(tq, tc, None, **kw)
    got = port.lane_max_scan_split_plain(tq, tc, None, splits, **kw)
    assert_same(got, want)
    if slots == 2:
        # most lanes hold two equal scores: the tie rule is exercised
        ct = CORPUS_TILE
        assert (want[0][:, :ct] == want[0][:, ct:]).float().mean() > 0.3


def test_slot_order_merge_is_not_enough():
    """The case that decides the merge's design: within one lane, equal
    scores in tiles 3 and 4 (split 0 and split 1) and a larger one in
    tile 6. The unsplit contest keeps tile 4 in slot 2 (tile 3 was
    displaced from slot 1 onto an equal slot 2); feeding split 1's slot 1
    before its slot 2 would keep tile 3. The tile-ordered merge keeps 4."""
    scores = [-0.5, -0.25, -0.125, 0.125, 0.125, -0.375, 0.375, -0.0625]
    q = torch.ones((1, 1), dtype=torch.bfloat16)
    c = torch.tensor(scores, dtype=torch.bfloat16)[:, None]
    kw = dict(corpus_tile=1, slots=2, track_discards=True)
    want = port.lane_max_scan_plain(q, c, None, **kw)
    assert want[1].tolist() == [[6, 4]]
    got = port.lane_max_scan_split_plain(q, c, None, 2, **kw)
    assert_same(got, want)


def test_merge_of_one_part_is_that_part():
    tq, tc, ts, kw = scan_inputs("slots2_discards_shuffle1")
    vals, pos, dmax, first = port._lane_scan_tiles(
        tq, tc, ts, 0, NUM_ITEMS // CORPUS_TILE, **kw
    )
    got = port.merge_lane_slots_plain([vals], [pos], [first], [dmax], slots=2)
    assert_same(got, (vals, pos, dmax))


@pytest.mark.parametrize(
    "case",
    ["slots2_discards_shuffle1", "slots2_int8_scales_shuffle1_padding",
     "slots1_discards_shuffle3"],
)
def test_lane_split_equals_pallas_interpret(case):
    tq, tc, ts, kw = scan_inputs(case)
    slots = kw["slots"]
    want = ref.lane_max_scan(
        jnp.asarray(tq.float().numpy(), "bfloat16"),
        jnp.asarray(tc.numpy()) if tc.dtype == torch.int8
        else jnp.asarray(tc.float().numpy(), "bfloat16"),
        scales=None if ts is None else jnp.asarray(ts.numpy()),
        batch_tile=8,
        interpret=True,
        **kw,
    )
    got = port.lane_max_scan_split_plain(tq, tc, ts, 3, **kw)
    for g, w in zip(got, want, strict=True):
        # the reference returns the discard-max as (B, 1)
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(w).reshape(g.shape)
        )
    assert got[0].shape == (8, slots * CORPUS_TILE)


SM_COUNT = 132  # an H100 SXM
# (rows, lanes, blocks an SM) of the block shapes the shape queries
# report: the lane scan's split instantiation (wgmma, two slots and the
# first tile of slot 2's value: two blocks) and its f32 sweep, the count's
# wgmma sweep and its f32 sweep
LANE_AND_COUNT_SHAPES = {
    "lane_mma_split": (64, 64, 2),
    "lane_fma": (32, 128, 2),
    "count_mma": (64, 64, 6),
    "count_fma": (64, 128, 1),
}


@pytest.mark.parametrize("shape", sorted(LANE_AND_COUNT_SHAPES))
@pytest.mark.parametrize("batch", [8, 64, 128, 256])
def test_small_batches_fill_the_card(shape, batch):
    rows, lanes, per_sm = LANE_AND_COUNT_SHAPES[shape]
    lane_chunks = 2048 // lanes
    splits = kernels.sweep_splits(
        batch, 512, lane_chunks, SM_COUNT, rows, per_sm
    )
    blocks = -(-batch // rows) * lane_chunks * splits
    assert splits > 1
    # every block resident at once, and the card more than half filled
    assert per_sm * SM_COUNT // 2 < blocks <= per_sm * SM_COUNT


@pytest.mark.parametrize("shape", sorted(LANE_AND_COUNT_SHAPES))
def test_pass_one_is_not_split(shape):
    """The first pass of `search_certified("f32")` (B=4096) fills the
    card with row tiles alone."""
    rows, lanes, per_sm = LANE_AND_COUNT_SHAPES[shape]
    assert kernels.sweep_splits(
        4096, 512, 2048 // lanes, SM_COUNT, rows, per_sm
    ) == 1


def test_retry_width_plan():
    """`_host_escalation` pads its retries to 128 rows: 2 row tiles x 32
    lane chunks = 64 blocks, half a wave of the split lane scan, which
    the plan splits 4 ways (256 blocks, two an SM on 132 SMs)."""
    assert kernels.sweep_splits(128, 512, 32, SM_COUNT, 64, 2) == 4
    # and never more ways than the corpus has tiles
    assert kernels.sweep_splits(128, 3, 32, SM_COUNT, 64, 2) == 3


def test_lane_wrappers_check_their_arguments():
    q = torch.zeros((8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lane_max_scan_splits(q, q, corpus_tile=8, slots=2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.count_at_least_splits(q, q, corpus_tile=8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lane_max_scan(q, q, None, corpus_tile=8, slots=2, splits=2)
