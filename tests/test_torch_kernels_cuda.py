"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these need an H100 (sm_90a) and nvcc, and skip elsewhere.
Run them on a card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the port does
not need.)
"""

import numpy as np
import pytest
import torch

from xfmr_rec_torch.ops import kernels, topk

pytestmark = pytest.mark.cuda


def exact_inputs(seed, batch, num_items, dim, int8=False):
    """Small integers times powers of two: every product and partial sum
    is exact in f32, and the power-of-two bound keeps the query scaling
    exact, so kernel and plain version must agree bit for bit. Shared
    with the CPU parity tests; it lives here because this file must not
    import JAX (the machine with the card has none)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 9, size=(batch, dim)).astype(np.float32) / 16
    if int8:
        c = rng.integers(-127, 128, size=(num_items, dim)).astype(np.int8)
        scales = (2.0 ** -rng.integers(8, 11, size=num_items)).astype(
            np.float32
        )
        scores = (q @ c.astype(np.float32).T) * scales
    else:
        c = rng.integers(-8, 9, size=(num_items, dim)).astype(np.float32) / 16
        scales = None
        scores = q @ c.T
    bound = 2.0 ** np.ceil(np.log2(np.abs(scores).max() + 1e-3))
    return q, c, scales, float(bound)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "opts",
    [
        dict(),
        dict(lane_shuffle=1),
        dict(lane_shuffle=3, reserve_bits=1, true_num_items=1500),
        dict(track_discards=False),
        dict(bias_in_dot=True),
        dict(int8=True),
        # the serving tower's width, and tiles narrower than a block's lanes
        dict(dim=32, corpus_tile=64),
        dict(dim=32, corpus_tile=64, bias_in_dot=True, lane_shuffle=5),
    ],
)
def test_packed_scan_matches_plain(card, opts):
    opts = dict(opts)
    int8 = opts.pop("int8", False)
    dim = opts.pop("dim", 64)
    opts.setdefault("corpus_tile", 512)
    q, c, scales, bound = exact_inputs(1, 70, 2048, dim, int8=int8)
    if opts.get("bias_in_dot"):
        c = np.concatenate([c, np.full((len(c), 1), 1.5, c.dtype)], axis=1)
    tq = torch.from_numpy(q).to(card, torch.bfloat16)
    tc = torch.from_numpy(c).to(card)
    tc = tc if int8 else tc.bfloat16()
    ts = None if scales is None else torch.from_numpy(scales).to(card)
    kw = dict(score_bound=bound, batch_tile=70, **opts)
    before = kernels.launch_counts()["packed_scan"]
    got = topk.packed_lane_scan(tq, tc, scales=ts, **kw)
    assert kernels.launch_counts()["packed_scan"] == before + 1
    want = topk.packed_lane_scan(tq.cpu(), tc.cpu(), scales=None if ts is None else ts.cpu(), **kw)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
    if want[1] is not None:
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)


@pytest.mark.parametrize("width", [384, 3072, 4096])
def test_threshold_select_matches_plain(card, width):
    rng = np.random.default_rng(width)
    f = rng.uniform(1.25, 1.75, size=(33, width)).astype(np.float32)
    pool = torch.from_numpy(f.view(np.int32) & ~np.int32(0xFF))
    for qb, shared in ((0, False), (12, True)):
        got = kernels.threshold_select(
            pool.to(card), 100, capacity=128, quantum_bits=qb,
            shared_exponent=shared,
        )
        want = topk.select_topk_keys_plain(
            pool, 100, capacity=128, quantum_bits=qb, shared_exponent=shared
        )
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
