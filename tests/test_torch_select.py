"""Port parity: threshold-select over packed-key pools.

The top-k keys must agree with the JAX `select_topk_keys` (Pallas
interpret mode) exactly, as multisets; lanes must agree wherever the key
is unique at the quantum, and every returned lane must hold its key.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmr_rec_torch.ops import topk as port
from xfmr_rec_tpu.ops import topk_pallas as ref


def check_select(pool, k, quantum_bits=0, shared_exponent=False, capacity=128):
    want_keys, want_lanes = ref.select_topk_keys(
        jnp.asarray(pool), k, capacity=capacity, quantum_bits=quantum_bits,
        shared_exponent=shared_exponent, batch_tile=8, interpret=True,
    )
    got_keys, got_lanes = port.select_topk_keys(
        torch.from_numpy(pool), k, capacity=capacity,
        quantum_bits=quantum_bits, shared_exponent=shared_exponent,
    )
    want_keys, want_lanes = np.asarray(want_keys), np.asarray(want_lanes)
    got_keys, got_lanes = got_keys.numpy(), got_lanes.numpy()
    np.testing.assert_array_equal(
        np.sort(got_keys, axis=1), np.sort(want_keys, axis=1)
    )
    # every real (key, lane) pair points at its key in the pool
    gathered = np.take_along_axis(pool, got_lanes, axis=1)
    real = got_keys > 0
    np.testing.assert_array_equal(gathered[real], got_keys[real])
    for row in range(pool.shape[0]):
        quanta = pool[row] >> quantum_bits
        values, counts = np.unique(quanta, return_counts=True)
        unique = set(values[counts == 1].tolist())
        for key, g_lane, w_lane in zip(
            got_keys[row], got_lanes[row], want_lanes[row], strict=True
        ):
            if key > 0 and int(key) >> quantum_bits in unique:
                assert g_lane == w_lane
    return got_keys, got_lanes


@pytest.mark.parametrize("k", [1, 7, 100, 128])
def test_random_pools(k):
    pool = np.random.default_rng(k).integers(0, 1 << 30, size=(8, 768))
    check_select(pool.astype(np.int32), k)


def test_heavy_ties_and_empties():
    rng = np.random.default_rng(1)
    pool = rng.integers(0, 1 << 30, size=(8, 768)).astype(np.int32)
    pool = (pool >> 20) << 20
    pool[:, ::3] = 0
    check_select(pool, 50)


def test_fewer_candidates_than_k():
    pool = np.zeros((8, 768), dtype=np.int32)
    pool[:, 5] = 1000
    pool[:, 400] = 2000
    check_select(pool, 10)


def test_tie_overflow_keeps_greater_keys():
    pool = np.zeros((8, 768), dtype=np.int32)
    pool[:, :300] = 1000
    pool[:, 700:720] = 2000
    keys, _ = check_select(pool, 100)
    assert (keys[:, :20] == 2000).all()


def packed_window_pool(seed, batch, width, quantum_bits):
    """Keys shaped like packed scan keys: bitcast floats in [1.25, 1.75),
    collapsed to few quanta so tau-quantum ties occur."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(1.25, 1.75, size=(batch, width)).astype(np.float32)
    pool = f.view(np.int32)
    pool = (pool >> (quantum_bits + 10)) << (quantum_bits + 10)
    low = rng.integers(0, 1 << quantum_bits, size=pool.shape)
    return (pool | low).astype(np.int32)


@pytest.mark.parametrize("width", [768, 3072, 4096])
def test_quantum_and_shared_exponent(width):
    pool = packed_window_pool(width, 4, width, 8)
    check_select(pool, 100 if width > 768 else 50, quantum_bits=8,
                 shared_exponent=True)


def test_main_path_geometry_distinct_keys():
    """W=3072, capacity 128, k=100, as on the guaranteed path: packed
    float keys that are distinct above the quantum select identically."""
    rng = np.random.default_rng(9)
    f = rng.uniform(1.25, 1.75, size=(4, 3072)).astype(np.float32)
    pool = (f.view(np.int32) & ~np.int32(0xFFF)) | rng.integers(
        0, 1 << 12, size=(4, 3072)
    ).astype(np.int32)
    keys, lanes = check_select(
        pool, 100, quantum_bits=12, shared_exponent=True
    )
    want = np.sort(pool, axis=1)[:, ::-1][:, :100]
    np.testing.assert_array_equal(keys >> 12, want >> 12)


def test_narrow_pool_shortcut():
    """width <= capacity returns a plain stable top-k, as the reference
    returns lax.top_k."""
    pool = np.random.default_rng(3).integers(0, 1 << 30, size=(4, 128))
    pool = pool.astype(np.int32)
    pool[:, 10] = pool[:, 3]  # a tie: the lower lane comes first
    want_k, want_l = ref.select_topk_keys(jnp.asarray(pool), 5)
    got_k, got_l = port.select_topk_keys(torch.from_numpy(pool), 5)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_plain_select_keeps_rank_order():
    """The plain kernel version writes kept keys in lane order, meta =
    lane + 1, empty slots 0."""
    pool = np.zeros((1, 256), dtype=np.int32)
    pool[0, [3, 50, 200]] = [7, 9, 8]
    keys, meta = port.select_topk_keys_plain(
        torch.from_numpy(pool), 2, capacity=128
    )
    # tau = 8: key 7 is dropped, 9 and 8 keep their lane order
    assert keys[0, :2].tolist() == [9, 8]
    assert meta[0, :2].tolist() == [51, 201]
    assert (keys[0, 2:] == 0).all() and (meta[0, 2:] == 0).all()


def test_rejects_bad_args():
    pool = torch.zeros((4, 768), dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity"):
        port.select_topk_keys(pool, 200, capacity=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        port.select_topk_keys(pool, 5, capacity=100)
