"""The packed sweep with its corpus tiles split over blocks, on the CPU.

The CUDA kernels split the corpus tiles into contiguous ranges when a
small batch would leave SMs idle, and merge the partial top-2s. Here the
plain PyTorch version of that merge (`merge_split_slots_plain`, through
`packed_lane_scan_split_plain`) is held bit for bit against the unsplit
plain version and against the JAX package's Pallas kernel in interpret
mode, and the function that chooses the number of splits is held to its
contract. Inputs are small integers times powers of two (every product
and partial sum exact in f32), made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import exact_inputs
from xfmr_rec_torch.ops import kernels
from xfmr_rec_torch.ops import topk as port
from xfmr_rec_tpu.ops import topk_pallas as ref

SPLIT_CASES = {
    "plain": dict(),
    "shuffle3": dict(lane_shuffle=3),
    "padding": dict(true_num_items=900),
    "padding_shuffle3": dict(true_num_items=900, lane_shuffle=3),
    "int8_scales": dict(int8=True),
    "int8_scales_shuffle3": dict(int8=True, lane_shuffle=3),
    "reserve1_no_discards": dict(reserve_bits=1, track_discards=False),
    "bias_in_dot": dict(bias_in_dot=True),
}


def scan_inputs(case, batch=8, num_items=1024, dim=16):
    opts = dict(SPLIT_CASES[case])
    int8 = opts.pop("int8", False)
    q, c, scales, bound = exact_inputs(
        sum(map(ord, case)), batch, num_items, dim, int8=int8
    )
    if opts.get("bias_in_dot"):
        c = np.concatenate([c, np.full((len(c), 1), 1.5, c.dtype)], axis=1)
    return q, c, scales, bound, int8, opts


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_sweep_equals_unsplit(case, splits):
    q, c, scales, bound, int8, opts = scan_inputs(case)
    tq = torch.from_numpy(q).bfloat16()
    tc = torch.from_numpy(c) if int8 else torch.from_numpy(c).bfloat16()
    ts = None if scales is None else torch.from_numpy(scales)
    q_s, s_s, geom = port.prepare_packed_scan(
        tq, tc, score_bound=bound, batch_tile=8, corpus_tile=128, scales=ts,
        **opts,
    )
    want_keys, want_dmax = port.packed_lane_scan_plain(q_s, tc, s_s, **geom)
    got_keys, got_dmax = port.packed_lane_scan_split_plain(
        q_s, tc, s_s, splits, **geom
    )
    assert torch.equal(got_keys, want_keys)
    if geom["track_discards"]:
        assert torch.equal(got_dmax, want_dmax)
        # the discards are not all zero, so the merge's share is tested
        assert int(want_dmax.max()) > 0
    else:
        assert got_dmax is None and want_dmax is None


@pytest.mark.parametrize("splits", [3, 8])
def test_split_ranges_cover_uneven_tiles(splits):
    """8 tiles split 3 ways (ranges of 2, 3 and 3 tiles) and one tile a
    split: every tile is swept exactly once."""
    q, c, _, bound, _, _ = scan_inputs("plain")
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    q_s, _, geom = port.prepare_packed_scan(
        tq, tc, score_bound=bound, batch_tile=8, corpus_tile=128,
        lane_shuffle=5,
    )
    want = port.packed_lane_scan_plain(q_s, tc, None, **geom)
    got = port.packed_lane_scan_split_plain(q_s, tc, None, splits, **geom)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_merge_is_order_independent():
    """Blocks finish in any order: merging the parts backwards gives the
    same slots and discard-max."""
    q, c, _, bound, _, _ = scan_inputs("plain")
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    q_s, _, geom = port.prepare_packed_scan(
        tq, tc, score_bound=bound, batch_tile=8, corpus_tile=128
    )
    ct = geom.pop("corpus_tile")
    parts = [
        port._scan_tiles(q_s, tc, None, 2 * s, 2 * s + 2, corpus_tile=ct, **geom)
        for s in range(4)
    ]
    keys = [k for k, _ in parts]
    dmax = [d for _, d in parts]
    forward = port.merge_split_slots_plain(keys, dmax)
    backward = port.merge_split_slots_plain(keys[::-1], dmax[::-1])
    assert torch.equal(forward[0], backward[0])
    assert torch.equal(forward[1], backward[1])


@pytest.mark.parametrize("case", ["shuffle3", "int8_scales", "padding"])
def test_split_sweep_equals_pallas_interpret(case):
    q, c, scales, bound, int8, opts = scan_inputs(case, num_items=512)
    kw = dict(score_bound=bound, batch_tile=8, corpus_tile=128, **opts)
    want_keys, want_dmax = ref.packed_lane_scan(
        jnp.asarray(q, "bfloat16"),
        jnp.asarray(c, np.int8 if int8 else "bfloat16"),
        scales=None if scales is None else jnp.asarray(scales),
        interpret=True,
        **kw,
    )
    tq = torch.from_numpy(q).bfloat16()
    tc = torch.from_numpy(c) if int8 else torch.from_numpy(c).bfloat16()
    ts = None if scales is None else torch.from_numpy(scales)
    q_s, s_s, geom = port.prepare_packed_scan(tq, tc, scales=ts, **kw)
    got_keys, got_dmax = port.packed_lane_scan_split_plain(
        q_s, tc, s_s, 4, **geom
    )
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(got_dmax.numpy(), np.asarray(want_dmax))


SM_COUNT = 132  # an H100 SXM
# (lanes of a block, blocks an SM holds) of the sweeps: wgmma with the
# asynchronous ring, wgmma with plain loads, the f32 fmaf sweep
BLOCK_SHAPES = {"mma_async": (64, 4), "mma_plain": (64, 3), "fma": (128, 1)}


@pytest.mark.parametrize("lane_chunks", [16, 32])
def test_full_batch_is_not_split(lane_chunks):
    assert kernels.sweep_splits(4096, 512, lane_chunks, SM_COUNT) == 1


@pytest.mark.parametrize("lane_chunks", [16, 32])
@pytest.mark.parametrize("batch", [1, 8, 64, 128, 256])
def test_small_batches_are_split(batch, lane_chunks):
    splits = kernels.sweep_splits(batch, 512, lane_chunks, SM_COUNT)
    blocks = -(-batch // 64) * lane_chunks * splits
    assert splits > 1
    # the card is filled, and by blocks that are all resident together
    assert SM_COUNT <= blocks <= 4 * SM_COUNT


@pytest.mark.parametrize("sweep", sorted(BLOCK_SHAPES))
@pytest.mark.parametrize("batch", [8, 64, 256])
def test_split_blocks_are_resident_for_every_sweep(batch, sweep):
    """The plan follows the block shape it is given: at ct=2048 no sweep
    gets more blocks than its SMs hold at a time."""
    lanes, per_sm = BLOCK_SHAPES[sweep]
    lane_chunks = 2048 // lanes
    splits = kernels.sweep_splits(
        batch, 512, lane_chunks, SM_COUNT, 64, per_sm
    )
    blocks = -(-batch // 64) * lane_chunks * splits
    assert blocks <= per_sm * SM_COUNT
    assert splits == 1 or blocks > per_sm * SM_COUNT // 2


@pytest.mark.parametrize("num_tiles", [1, 2, 3, 7])
@pytest.mark.parametrize("batch", [1, 64, 4096])
def test_never_more_splits_than_tiles(batch, num_tiles):
    splits = kernels.sweep_splits(batch, num_tiles, 4, SM_COUNT)
    assert 1 <= splits <= num_tiles
    if batch <= 64:
        assert splits == num_tiles  # 4 blocks: the tiles are the limit


@pytest.mark.parametrize("sm_count", [1, 20, 132, 144])
def test_splits_grow_with_the_card(sm_count):
    splits = [kernels.sweep_splits(b, 512, 32, sm_count)
              for b in (8, 64, 256, 1024, 4096)]
    assert splits == sorted(splits, reverse=True) and splits[-1] == 1
    assert splits[0] == max(1, 4 * sm_count // 32)
