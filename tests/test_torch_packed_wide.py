"""Port parity: kernel 1's plain version at the history tower's index widths.

The item-identity and CF channels widen the index rows: d + 1 = 33 with
the popularity bias, d + r + 1 = 161 with `cf_rank=128`, and 162 with
both. Rows of those widths are not a multiple of 16 bytes in bf16 (the
card's kernel loads them without `cp.async`).

- `packed_lane_scan` (the plain version the wrappers use on the CPU)
  against the reference's Pallas kernel in interpret mode, on inputs
  whose products and partial sums are exact in f32: keys and
  discard-maxes bit for bit.
- `RetrievalIndex(method="scan")` on a corpus shaped like a trained
  index (unit 32-d part, a bias column, CF factor columns of larger norm
  and a popularity column, all multiples of 1/8): ids and scores equal
  to the reference's scan index, and each returned score within one key
  quantum below the item's exact score for the scan's own query (the
  score bound is the Cauchy-Schwarz bound over the whole row, so it
  holds whatever the extra columns' scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import exact_inputs
from xfmr_rec_torch.index.mips import RetrievalIndex as PortIndex
from xfmr_rec_torch.ops import topk as port
from xfmr_rec_tpu.index.mips import RetrievalIndex as RefIndex
from xfmr_rec_tpu.ops import topk_pallas as ref

CASES = {
    "dim33": dict(dim=33),
    "dim161": dict(dim=161, lane_shuffle=1),
    "dim162": dict(dim=162, true_num_items=450),
    "dim161_bias_in_dot": dict(dim=161, bias_in_dot=True),
    "dim161_int8_scales": dict(dim=161, int8=True),
    "dim33_bf16_shuffle3": dict(dim=33, dtype="bfloat16", lane_shuffle=3,
                                reserve_bits=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_lane_scan_wide_rows_bit_exact(case):
    opts = dict(CASES[case])
    dim = opts.pop("dim")
    int8 = opts.pop("int8", False)
    dtype = "bfloat16" if int8 else opts.pop("dtype", "float32")
    q, c, scales, bound = exact_inputs(dim, 8, 512, dim, int8=int8)
    if opts.get("bias_in_dot"):
        c = np.concatenate([c, np.full((len(c), 1), 1.5, c.dtype)], axis=1)
    kw = dict(score_bound=bound, batch_tile=8, corpus_tile=128, **opts)
    want_keys, want_dmax = ref.packed_lane_scan(
        jnp.asarray(q, dtype),
        jnp.asarray(c, np.int8 if int8 else dtype),
        scales=None if scales is None else jnp.asarray(scales),
        interpret=True,
        **kw,
    )
    tdtype = getattr(torch, dtype)
    got_keys, got_dmax = port.packed_lane_scan(
        torch.from_numpy(q).to(tdtype),
        torch.from_numpy(c).to(torch.int8 if int8 else tdtype),
        scales=None if scales is None else torch.from_numpy(scales),
        **kw,
    )
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(got_dmax.numpy(), np.asarray(want_dmax))


def trained_like(seed, rows, bias, cf_rank):
    """Rows shaped like a trained two-tower index, in multiples of 1/8."""
    rng = np.random.default_rng(seed)
    parts = [rng.integers(-2, 3, size=(rows, 32)) / 8]
    if bias:
        parts.append(rng.integers(-4, 5, size=(rows, 1)) / 8)
    if cf_rank:
        parts.append(rng.integers(-16, 17, size=(rows, cf_rank)) / 8)
        parts.append(rng.integers(0, 9, size=(rows, 1)) / 8)
    return np.concatenate(parts, axis=1).astype(np.float32)


@pytest.mark.parametrize(
    "bias,cf_rank", [(True, 0), (False, 128), (True, 128)],
    ids=["d33", "d161", "d162"],
)
def test_scan_index_at_wide_rows(bias, cf_rank):
    corpus = trained_like(1, 3000, bias, cf_rank)
    queries = trained_like(2, 6, bias, cf_rank)
    ids = np.arange(100, 3100)
    excl = [[100, 101], [], [2500], [], [3099], [150, 160]]
    kw = dict(method="scan", id_col="movie_id")
    want_s, want_ids = RefIndex(corpus, ids, **kw).search(
        queries, top_k=20, exclude_ids=excl)
    index = PortIndex(corpus, ids, device="cpu", **kw)
    got_s, got_ids = index.search(queries, top_k=20, exclude_ids=excl)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_s, want_s)
    # each returned score decodes the item's own scaled score (the bf16
    # query scaled by 0.25 / bound) to within one key quantum below
    q = torch.from_numpy(queries).bfloat16()
    qnorm = torch.linalg.vector_norm(q.float(), dim=-1).max()
    bound = torch.clamp(index._corpus_maxnorm * qnorm * 1.05, min=1e-6)
    scaled = (q.float() * (0.25 / bound.float())).bfloat16().float()
    if cf_rank:  # the CF columns are not unit-norm
        assert float(bound) > 4 * float(qnorm)
    want_scaled = scaled @ index.corpus.float().T
    pos = np.vectorize(index._id_to_pos.get)(got_ids)
    got_scaled = torch.from_numpy(got_s) * (0.25 / bound.float())
    corpus_t, _, tile, _ = index._scan_setup()
    # masked low key bits: the tile index + the lane-pair merge's bit
    qbits = max((corpus_t.shape[0] // tile - 1).bit_length(), 1) + 1
    quantum = 2.0 ** (qbits - 23)
    diff = torch.gather(want_scaled, 1, torch.from_numpy(pos)) - got_scaled
    assert float(diff.min()) >= -1e-7 and float(diff.max()) <= quantum
