"""Port parity: the count cross-check and `certified_topk`.

Same seeded numpy inputs through both packages; the JAX side runs its
Pallas kernels in interpret mode. On f32-exact inputs (small integers
times powers of two) counts, values, positions and certificates are
equal outright; on random inputs the thresholds sit between scores, so
the counts are still equal while values are held to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import exact_inputs
from xfmr_rec_torch.ops import topk_f32 as port
from xfmr_rec_tpu.ops import topk_pallas as ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("true_num_items", [None, 700, 5000])
def test_count_at_least_bit_exact(dtype, true_num_items):
    q, c, _, _ = exact_inputs(200, 8, 1024, 16)
    scores = q @ c.T
    # thresholds that ARE scores (ties count) and one above every score
    tau = np.sort(scores, axis=1)[:, -20].astype(np.float32)
    tau[0] = scores.max() + 1
    kw = dict(batch_tile=8, corpus_tile=128, true_num_items=true_num_items)
    want = ref.count_at_least(
        jnp.asarray(q, dtype), jnp.asarray(c, dtype), jnp.asarray(tau),
        interpret=True, **kw,
    )
    torch_dtype = getattr(torch, dtype)
    got = port.count_at_least(
        torch.from_numpy(q).to(torch_dtype),
        torch.from_numpy(c).to(torch_dtype), torch.from_numpy(tau), **kw,
    )
    assert got.dtype == torch.int32 and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    limit = 1024 if true_num_items is None else min(true_num_items, 1024)
    np.testing.assert_array_equal(
        got.numpy(), (scores[:, :limit] >= tau[:, None]).sum(1)
    )
    assert got[0] == 0


def test_count_at_least_random_between_scores():
    rng = np.random.default_rng(201)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    c = rng.normal(size=(2048, 32)).astype(np.float32)
    ordered = np.sort(q @ c.T, axis=1)
    # midway between the 50th and 51st best: no rounding moves the count
    tau = ((ordered[:, -50] + ordered[:, -51]) / 2).astype(np.float32)
    kw = dict(batch_tile=8, corpus_tile=256)
    want = ref.count_at_least(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(tau), interpret=True, **kw
    )
    got = port.count_at_least(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(tau), **kw
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 50).all()


def test_count_at_least_rejects_uneven_tiles():
    with pytest.raises(ValueError, match="tile evenly"):
        port.count_at_least(
            torch.zeros((8, 16)), torch.zeros((200, 16)), torch.zeros(8),
            corpus_tile=128,
        )


def planted_collisions(seed):
    """Exact inputs where three copies of each of the first rows' queries
    share a lane across tiles: slots=2 evicts one, so those rows cannot
    certify, under either method."""
    q, c, _, _ = exact_inputs(seed, 8, 1024, 16)
    c *= 0.25  # planted items outscore everything else
    for row in range(3):
        for tile in range(3):
            c[5 + row + tile * 128] = q[row]
    return q, c


@pytest.mark.parametrize("method", ["discard", "count"])
@pytest.mark.parametrize("slots", [1, 2])
def test_certified_topk_bit_exact(method, slots):
    q, c = planted_collisions(210 + slots)
    kw = dict(batch_tile=8, corpus_tile=128, slots=slots, method=method,
              true_num_items=1000)
    want = ref.certified_topk(jnp.asarray(q), jnp.asarray(c), 10,
                              interpret=True, **kw)
    got = port.certified_topk(torch.from_numpy(q), torch.from_numpy(c), 10,
                              **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.bool
    if slots == 2:
        assert not got[2][:3].any()  # the planted rows lost an item


def test_certified_topk_methods_agree_without_ties():
    """On continuous scores the k-th and (k+1)-th never tie, so the
    discard certificate and the count certificate mark the same rows,
    and a certified row is the dense exact top-k."""
    rng = np.random.default_rng(220)
    q = rng.normal(size=(32, 32)).astype(np.float32)
    c = rng.normal(size=(2048, 32)).astype(np.float32)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    kw = dict(batch_tile=8, corpus_tile=128, slots=2)
    vals_d, pos_d, exact_d = port.certified_topk(tq, tc, 20, method="discard",
                                                 **kw)
    vals_c, pos_c, exact_c = port.certified_topk(tq, tc, 20, method="count",
                                                 **kw)
    torch.testing.assert_close(exact_d, exact_c)
    torch.testing.assert_close(pos_d, pos_c)
    assert 0 < int(exact_d.sum()) < 32  # both outcomes occur
    want = ref.certified_topk(jnp.asarray(q), jnp.asarray(c), 20,
                              interpret=True, **kw)
    np.testing.assert_allclose(vals_d.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(exact_d.numpy(), np.asarray(want[2]))
    dense = torch.topk(tq @ tc.T, 20, dim=1).indices
    for row in torch.nonzero(exact_d).flatten().tolist():
        assert set(pos_d[row].tolist()) == set(dense[row].tolist())


def test_certified_topk_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown certification"):
        port.certified_topk(torch.zeros((8, 16)), torch.zeros((256, 16)), 5,
                            corpus_tile=128, method="sum")
