"""The threshold select's radix search for tau, on the CPU.

The Hopper kernel finds tau by 8-bit digits; the TPU kernel, and the
plain version `select_topk_keys_plain`, by one bit at a time. Greedy bit
setting over a monotone count gives tau = max(seed, kth with the bits
below the quantum cleared), where the seed is the row max's exponent
bits (shared exponent) or 0, and kth the k-th largest key counted with
multiplicity. `radix_tau_plain` must give the same tau on every input.
Then the whole select through the plain versions against the JAX
kernel in interpret mode, and the launch plan of the kernel's warps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from xfmr_rec_torch.ops import kernels
from xfmr_rec_torch.ops import topk as port
from xfmr_rec_tpu.ops import topk_pallas as ref

QUANTUM_BITS = [0, 10, 12]
SHARED = [False, True]


def float_keys(rng, shape):
    """Packed-key-like: bitcast floats in [1.25, 1.75), one exponent."""
    f = rng.uniform(1.25, 1.75, size=shape).astype(np.float32)
    return f.view(np.int32).astype(np.int64)


def pool_random(rng):
    return rng.integers(0, 1 << 31, size=(6, 384))


def pool_heavy_ties(rng):
    pool = float_keys(rng, (6, 384))
    # a handful of distinct values, many lanes on each
    return pool[:, rng.integers(0, 5, size=384)]


def pool_all_zero(rng):
    pool = pool_random(rng)
    pool[::2] = 0
    return pool


def pool_few_nonzero(rng):
    pool = np.zeros((6, 384), dtype=np.int64)
    for row in range(6):
        lanes = rng.choice(384, size=row * 7, replace=False)
        pool[row, lanes] = float_keys(rng, (lanes.size,))
    return pool


def pool_few_share_max_exponent(rng):
    """Fewer than k keys carry the max's exponent; the rest lie below."""
    pool = rng.integers(1, 1 << 23, size=(6, 384)) | (126 << 23)
    for row in range(6):
        lanes = rng.choice(384, size=3 + 11 * row, replace=False)
        pool[row, lanes] = float_keys(rng, (lanes.size,))
    return pool


POOLS = {
    "random": pool_random,
    "heavy_ties": pool_heavy_ties,
    "all_zero_rows": pool_all_zero,
    "fewer_than_k_nonzero": pool_few_nonzero,
    "fewer_than_k_share_max_exponent": pool_few_share_max_exponent,
}


def closed_form_tau(pool, k, quantum_bits, shared_exponent):
    seed = (pool.max(axis=1) & ~((1 << 23) - 1)) if shared_exponent else 0
    kth = -np.sort(-pool, axis=1)[:, k - 1]
    return np.maximum(seed, (kth >> quantum_bits) << quantum_bits)


def check_radix(pool, k, quantum_bits, shared_exponent):
    t = torch.from_numpy(pool.astype(np.int32))
    want = port.bit_tau_plain(t, k, quantum_bits, shared_exponent)
    got = port.radix_tau_plain(t, k, quantum_bits, shared_exponent)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got[:, 0].numpy(),
        closed_form_tau(pool, k, quantum_bits, shared_exponent),
    )


@pytest.mark.parametrize("shared_exponent", SHARED)
@pytest.mark.parametrize("quantum_bits", QUANTUM_BITS)
@pytest.mark.parametrize("kind", sorted(POOLS))
def test_radix_tau_equals_bit_search(kind, quantum_bits, shared_exponent):
    rng = np.random.default_rng(sorted(POOLS).index(kind))
    pool = POOLS[kind](rng)
    for k in (1, 40, 100, 128):
        check_radix(pool, k, quantum_bits, shared_exponent)


def test_radix_tau_on_packed_keys():
    """Keys shaped like the main path's: one exponent, crowded into few
    values of the first digit."""
    pool = float_keys(np.random.default_rng(5), (16, 3072))
    check_radix(pool, 100, 10, True)


def test_radix_tau_edge_rows():
    """tau = 0 (the compared keys start at 1), tau + quantum past int32,
    and a search that stops at its first digit."""
    pool = np.zeros((3, 384), dtype=np.int64)
    pool[0, :5] = 1 << 12
    pool[1, :] = (1 << 31) - 1
    pool[2, :3] = float_keys(np.random.default_rng(2), (3,))
    pool[2, 3:] = 1 << 20
    check_radix(pool, 10, 10, True)


@settings(max_examples=80, deadline=None)
@given(
    seed=st.integers(0, 2**32 - 1),
    width=st.integers(1, 300),
    rows=st.integers(1, 3),
    top=st.integers(1, 31),
    distinct=st.integers(1, 300),
    quantum_bits=st.integers(0, 30),
    shared_exponent=st.booleans(),
    k_frac=st.floats(0, 1),
)
def test_radix_tau_property(seed, width, rows, top, distinct, quantum_bits,
                            shared_exponent, k_frac):
    """Any pool of keys below 2^top drawn from `distinct` values (few
    values: heavy ties), any k, quantum and seed rule."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 1 << top, size=distinct)
    pool = values[rng.integers(0, distinct, size=(rows, width))]
    k = 1 + int(k_frac * (width - 1))
    check_radix(pool, k, quantum_bits, shared_exponent)


@pytest.mark.parametrize(
    ("kind", "quantum_bits", "shared_exponent"),
    [
        ("random", 0, False),
        ("heavy_ties", 10, True),
        ("all_zero_rows", 12, False),
        ("fewer_than_k_nonzero", 10, True),
        ("fewer_than_k_share_max_exponent", 12, True),
    ],
)
def test_plain_select_matches_jax(kind, quantum_bits, shared_exponent):
    """The whole select through the plain versions against the JAX kernel
    in interpret mode: keys and lanes equal, ties included (both keep
    tau-quantum ties in lane order and sort stably)."""
    pool = POOLS[kind](np.random.default_rng(11)).astype(np.int32)
    opts = dict(capacity=128, quantum_bits=quantum_bits,
                shared_exponent=shared_exponent)
    want_keys, want_lanes = ref.select_topk_keys(
        jnp.asarray(pool), 100, batch_tile=8, interpret=True, **opts
    )
    got_keys, got_lanes = port.select_topk_keys(torch.from_numpy(pool), 100,
                                                **opts)
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(got_lanes.numpy(), np.asarray(want_lanes))


@pytest.mark.parametrize(
    ("batch", "want"),
    [
        (1, (1, 1)),
        # a warp on each of 128 SMs
        (128, (1, 128)),
        # eight warps a block, as many blocks as the card holds
        (4096, (8, 132)),
    ],
)
def test_select_grid(batch, want):
    """H100: 132 SMs; rows of 3072 keys: eight warps a block, one such
    block an SM."""
    assert kernels.select_grid(batch, 132, 8, 1) == want


def test_select_grid_spreads_and_covers():
    for batch in range(1, 3000, 37):
        for block_warps, blocks_per_sm in ((8, 1), (3, 2), (1, 16)):
            per_block, blocks = kernels.select_grid(
                batch, 132, block_warps, blocks_per_sm
            )
            assert 1 <= per_block <= block_warps
            # never more blocks than rows need, nor than the card holds
            assert blocks <= -(-batch // per_block)
            assert blocks * per_block <= 132 * block_warps * blocks_per_sm
            # small batches: no SM gets two rows while another has none
            if batch <= 132:
                assert per_block == 1 and blocks == batch
