"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these need an H100 (sm_90a) and nvcc, and skip elsewhere.
Run them on a card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the port does
not need.)
"""

import dataclasses
import math
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from xfmr_rec_torch.ops import kernels, topk, topk_f32

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
        # the history tower's index rows: + bias (33), + CF factors and
        # popularity (161), both (162); rows off the 16-byte grid
        dict(dim=33),
        dict(dim=161, lane_shuffle=1),
        dict(dim=162, true_num_items=1500),
        dict(dim=161, bias_in_dot=True),
        dict(dim=161, int8=True),
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


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize(
    "opts",
    [
        dict(),
        dict(lane_shuffle=3, reserve_bits=1, true_num_items=1500),
        dict(int8=True, lane_shuffle=1),
        dict(f32=True),
        dict(bias_in_dot=True),
        # the serving tower's width, tiles narrower than a block's lanes
        dict(dim=32, corpus_tile=64, splits_scale=8),
        dict(dim=32, int8=True),
        dict(dim=33),
        dict(dim=162, lane_shuffle=3),
    ],
)
def test_packed_scan_split_over_blocks_matches_plain(card, opts, splits):
    """The corpus tiles split over blocks (forced, and whatever the
    wrapper chooses for this small batch) give the unsplit plain keys."""
    opts = dict(opts)
    int8 = opts.pop("int8", False)
    f32 = opts.pop("f32", False)
    dim = opts.pop("dim", 64)
    splits *= opts.pop("splits_scale", 1)
    opts.setdefault("corpus_tile", 512)
    q, c, scales, bound = exact_inputs(6, 70, 2048, dim, int8=int8)
    if opts.get("bias_in_dot"):
        c = np.concatenate([c, np.full((len(c), 1), 1.5, c.dtype)], axis=1)
    dtype = torch.float32 if f32 else torch.bfloat16
    tq = torch.from_numpy(q).to(card, dtype)
    tc = torch.from_numpy(c).to(card)
    tc = tc if int8 else tc.to(dtype)
    ts = None if scales is None else torch.from_numpy(scales).to(card)
    q_s, s_s, geom = topk.prepare_packed_scan(
        tq, tc, score_bound=bound, batch_tile=70, scales=ts, **opts
    )
    want = topk.packed_lane_scan_plain(q_s.cpu(), tc.cpu(), on_cpu(s_s), **geom)
    for forced in (splits, None):
        got = kernels.packed_scan(q_s, tc, s_s, splits=forced, **geom)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
    # a small batch over several tiles is split without being asked
    assert kernels.packed_scan_splits(q_s, tc, **geom) > 1


def test_packed_scan_splits_are_bounded(card):
    tq = torch.zeros((8, 64), dtype=torch.bfloat16, device=card)
    tc = torch.zeros((1024, 64), dtype=torch.bfloat16, device=card)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="splits"):
            kernels.packed_scan(tq, tc, None, corpus_tile=256, idx_bits=2,
                                splits=bad)


def test_split_sweep_is_the_same_run_to_run(card):
    """Random inputs, the wrapper's own splits: the merge is integer max
    and min, so whichever block arrives last the outputs are equal."""
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(100, 64, device=card, generator=g).bfloat16()
    c = torch.randn(1 << 16, 64, device=card, generator=g).bfloat16()
    q_s, _, geom = topk.prepare_packed_scan(
        q, c, score_bound=64.0, batch_tile=100, corpus_tile=2048
    )
    first = kernels.packed_scan(q_s, c, None, **geom)
    assert kernels.packed_scan_splits(q_s, c, **geom) > 1
    for splits in (None, None, 1, 9):
        again = kernels.packed_scan(q_s, c, None, splits=splits, **geom)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def select_pool(seed, batch, width):
    """Packed-key-like rows (bitcast floats in [1.25, 1.75), low 8 bits
    cleared), the first rows replaced by the select's edge cases."""
    rng = np.random.default_rng(seed)

    def keys(rows):
        f = rng.uniform(1.25, 1.75, size=(rows, width)).astype(np.float32)
        return f.view(np.int32) & ~np.int32(0xFF)

    pool = keys(batch)
    extra = keys(4)
    edges = []
    # 300 lanes tied on a key above the rest: ties beyond capacity
    row = extra[0].copy()
    row[rng.choice(width, size=min(300, width), replace=False)] = (
        np.float32(1.74).view(np.int32)
    )
    edges.append(row)
    edges.append(np.zeros(width, dtype=np.int32))  # all zero
    row = np.zeros(width, dtype=np.int32)  # fewer than k non-zero keys
    row[rng.choice(width, size=37, replace=False)] = extra[1, :37]
    edges.append(row)
    # fewer than k keys share the max's exponent, the rest one below
    row = (extra[2] & ((1 << 23) - 1)) | np.int32(126 << 23)
    row[rng.choice(width, size=20, replace=False)] = extra[3, :20]
    edges.append(row)
    for i, row in enumerate(edges[:batch]):
        pool[i] = row
    return torch.from_numpy(pool)


@pytest.mark.parametrize("batch", [1, 33, 128, 4096])
@pytest.mark.parametrize("width", [384, 3072, 4096, 16384])
def test_threshold_select_matches_plain(card, width, batch):
    """Raw outputs (keys and meta in rank order) identical to the plain
    version, at the retry and full batch widths and the widest pool."""
    pool = select_pool(width + batch, batch, width).to(card)
    for qb, shared in ((0, False), (10, True), (12, True)):
        opts = dict(capacity=128, quantum_bits=qb, shared_exponent=shared)
        got = kernels.threshold_select(pool, 100, **opts)
        want = topk.select_topk_keys_plain(pool, 100, **opts)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_threshold_select_spreads_small_batches(card):
    """A retry's 128 rows run a warp on each of 128 SMs; the full batch
    fills blocks of warps, no more blocks than the card holds at a time."""
    retry = torch.zeros((128, 3072), dtype=torch.int32, device=card)
    full = torch.zeros((4096, 3072), dtype=torch.int32, device=card)
    assert kernels.threshold_select_grid(retry) == (1, 128)
    block_warps, blocks_per_sm, sms = kernels._select_shape(
        full.device.index, 3072)
    warps, blocks = kernels.threshold_select_grid(full)
    assert warps == block_warps > 1 and blocks <= sms * blocks_per_sm


def scan_tensors(card, seed, batch, num_items, dim, int8=False, f32=False):
    q, c, scales, bound = exact_inputs(seed, batch, num_items, dim, int8=int8)
    dtype = torch.float32 if f32 else torch.bfloat16
    tq = torch.from_numpy(q).to(card, dtype)
    tc = torch.from_numpy(c).to(card)
    tc = tc if int8 else tc.to(dtype)
    ts = None if scales is None else torch.from_numpy(scales).to(card)
    return tq, tc, ts, bound


def on_cpu(tensor):
    return None if tensor is None else tensor.cpu()


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize(
    "opts",
    [
        dict(),
        dict(track_discards=True),
        dict(track_discards=True, lane_shuffle=1),
        dict(track_discards=True, lane_shuffle=3, true_num_items=1500),
        dict(track_discards=True, int8=True),
        dict(track_discards=True, f32=True, lane_shuffle=1),
        # tiles narrower than a block's lanes, rows that fill no block
        dict(track_discards=True, dim=32, corpus_tile=64, lane_shuffle=5),
    ],
)
def test_lane_max_scan_matches_plain(card, slots, opts):
    opts = dict(opts)
    int8 = opts.pop("int8", False)
    f32 = opts.pop("f32", False)
    dim = opts.pop("dim", 64)
    opts.setdefault("corpus_tile", 512)
    tq, tc, ts, _ = scan_tensors(card, 2, 70, 2048, dim, int8=int8, f32=f32)
    kw = dict(batch_tile=70, slots=slots, **opts)
    before = kernels.launch_counts()["lane_max_scan"]
    got = topk_f32.lane_max_scan(tq, tc, scales=ts, **kw)
    assert kernels.launch_counts()["lane_max_scan"] == before + 1
    want = topk_f32.lane_max_scan(tq.cpu(), tc.cpu(), scales=on_cpu(ts), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("true_num_items", [None, 1500])
def test_count_at_least_matches_plain(card, f32, true_num_items):
    tq, tc, _, _ = scan_tensors(card, 3, 70, 2048, 64, f32=f32)
    scores = tq.float() @ tc.float().T
    tau = torch.sort(scores, dim=1).values[:, -20].contiguous()
    kw = dict(batch_tile=70, corpus_tile=512, true_num_items=true_num_items)
    before = kernels.launch_counts()["count_at_least"]
    got = topk_f32.count_at_least(tq, tc, tau, **kw)
    assert kernels.launch_counts()["count_at_least"] == before + 1
    want = topk_f32.count_at_least(tq.cpu(), tc.cpu(), tau.cpu(), **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_count_certifies_what_the_scan_found(card):
    """tau comes from the scan kernel: its own item must count, so a row
    whose k-th and (k+1)-th scores differ counts exactly k."""
    g = torch.Generator(device=card).manual_seed(4)
    q = torch.randn(256, 64, device=card, generator=g).bfloat16()
    c = torch.randn(1 << 15, 64, device=card, generator=g).bfloat16()
    kw = dict(batch_tile=256, corpus_tile=2048)
    vals, _, exact = topk_f32.certified_topk(q, c, 50, method="count", **kw)
    _, _, exact_d = topk_f32.certified_topk(q, c, 50, method="discard", **kw)
    dense = torch.sort(q.float() @ c.float().T, dim=1, descending=True).values
    no_tie = (dense[:, 49] - dense[:, 50]) > 1e-4
    assert bool((exact == exact_d)[no_tie].all())
    assert int(exact.sum()) > 0


@pytest.mark.parametrize(
    "opts",
    [
        dict(merge_levels=0),
        dict(merge_levels=1),
        dict(merge_levels=2),
        dict(merge_levels=1, merge_keep=3),
        dict(merge_levels=1, merge_keep=3, lane_shuffle=3),
        dict(merge_levels=1, merge_keep=3, true_num_items=1500),
        dict(merge_levels=1, merge_keep=3, int8=True),
        dict(merge_levels=1, merge_keep=3, bias_in_dot=True),
        # the serving tower's width
        dict(merge_levels=1, merge_keep=3, dim=32),
        dict(merge_levels=1, dim=32, int8=True, lane_shuffle=1),
    ],
)
def test_packed_scan_select_matches_plain(card, opts):
    opts = dict(opts)
    int8 = opts.pop("int8", False)
    tq, tc, ts, bound = scan_tensors(
        card, 5, 70, 2048, opts.pop("dim", 64), int8=int8
    )
    if opts.get("bias_in_dot"):
        tc = torch.cat([tc, torch.full_like(tc[:, :1], 1.5)], dim=1)
    kw = dict(score_bound=bound, batch_tile=70, corpus_tile=512, **opts)
    before = kernels.launch_counts()
    got = topk.packed_lane_scan_select(tq, tc, 100, scales=ts, **kw)
    after = kernels.launch_counts()
    # one launch of the fused kernel, none of the two-kernel path
    assert after["packed_scan_select"] == before["packed_scan_select"] + 1
    assert after["packed_scan"] == before["packed_scan"]
    assert after["threshold_select"] == before["threshold_select"]
    want = topk.packed_lane_scan_select(
        tq.cpu(), tc.cpu(), 100, scales=on_cpu(ts), **kw
    )
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize(
    "opts",
    [
        dict(merge_levels=1, merge_keep=3),
        dict(merge_levels=2, lane_shuffle=3, true_num_items=1500),
        dict(merge_levels=1, merge_keep=3, int8=True),
    ],
)
def test_packed_scan_select_split_over_blocks_matches_plain(card, opts, splits):
    """The fused kernel with its corpus tiles split over blocks: the tail
    merges the splits before the lane pairs, still in one launch."""
    opts = dict(opts)
    levels = opts.pop("merge_levels")
    keep = opts.pop("merge_keep", 2)
    tq, tc, ts, bound = scan_tensors(
        card, 8, 70, 2048, 64, int8=opts.pop("int8", False)
    )
    q_s, s_s, geom = topk.prepare_packed_scan(
        tq, tc, score_bound=bound, batch_tile=70, corpus_tile=512,
        reserve_bits=levels, scales=ts, **opts,
    )
    del geom["track_discards"], geom["reserve_bits"]
    kw = dict(merge_levels=levels, merge_keep=keep, capacity=128, **geom)
    want = topk.packed_lane_scan_select_plain(
        q_s.cpu(), tc.cpu(), on_cpu(s_s), 100, **kw
    )
    before = kernels.launch_counts()["packed_scan_select"]
    got = kernels.packed_scan_select(q_s, tc, s_s, 100, splits=splits, **kw)
    assert kernels.launch_counts()["packed_scan_select"] == before + 1
    # left alone, the wrapper splits this small batch, and agrees
    assert kernels.packed_scan_select_splits(q_s, tc, 100, **kw) > 1
    chosen = kernels.packed_scan_select(q_s, tc, s_s, 100, **kw)
    for g, c in zip(got, chosen, strict=True):
        assert torch.equal(g, c)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize(
    "opts",
    [
        dict(slots=2, track_discards=True),
        dict(slots=1, track_discards=True, lane_shuffle=3),
        dict(slots=2, track_discards=True, lane_shuffle=1, true_num_items=1500),
        dict(slots=2, int8=True, lane_shuffle=5),
        dict(slots=2, track_discards=True, f32=True),
        # tiles narrower than a block's lanes
        dict(slots=2, track_discards=True, dim=32, corpus_tile=64),
    ],
)
def test_lane_max_scan_split_over_blocks_matches_plain(card, opts, splits):
    """The corpus tiles split over blocks (forced, and whatever the
    wrapper chooses for this small batch) give the unsplit plain slots."""
    opts = dict(opts)
    int8 = opts.pop("int8", False)
    f32 = opts.pop("f32", False)
    dim = opts.pop("dim", 64)
    opts.setdefault("corpus_tile", 512)
    tq, tc, ts, _ = scan_tensors(card, 9, 70, 2048, dim, int8=int8, f32=f32)
    want = topk_f32.lane_max_scan_plain(tq.cpu(), tc.cpu(), on_cpu(ts), **opts)
    for forced in (splits, None):
        got = kernels.lane_max_scan(tq, tc, ts, splits=forced, **opts)
        for g, w in zip(got, want, strict=True):
            if w is None:
                assert g is None
            else:
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert kernels.lane_max_scan_splits(tq, tc, **opts) > 1


def tied_corpus(seed, num_items, dim, distinct=3):
    """Every corpus row one of `distinct` rows of small integers: each lane
    sees the same few scores again and again over its tiles, so the
    strict-`>` rule and the history it keeps decide most slots."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-8, 9, size=(distinct, dim)).astype(np.float32) / 16
    return pool[rng.integers(0, distinct, size=num_items)]


@pytest.mark.parametrize("slots", [1, 2])
def test_lane_max_scan_ties_across_splits(card, slots):
    """Rows repeated over the tiles of one lane: every split, down to one
    tile a split, gives the unsplit slots, positions and discard-max."""
    rng = np.random.default_rng(10)
    q = rng.integers(-8, 9, size=(70, 64)).astype(np.float32) / 16
    c = tied_corpus(11, 4096, 64)
    tq = torch.from_numpy(q).to(card, torch.bfloat16)
    tc = torch.from_numpy(c).to(card, torch.bfloat16)
    kw = dict(corpus_tile=256, slots=slots, track_discards=True, lane_shuffle=1)
    want = topk_f32.lane_max_scan_plain(tq.cpu(), tc.cpu(), None, **kw)
    for splits in (1, 2, 3, 5, 16):
        got = kernels.lane_max_scan(tq, tc, None, splits=splits, **kw)
        for g, w in zip(got, want, strict=True):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("f32", [False, True])
def test_count_at_least_split_over_blocks_matches_plain(card, f32, splits):
    tq, tc, _, _ = scan_tensors(card, 12, 70, 2048, 64, f32=f32)
    vals, _, _ = kernels.lane_max_scan(tq, tc, None, corpus_tile=512, slots=2)
    tau = topk.topk_stable(vals, 20)[0][:, -1].contiguous()
    kw = dict(corpus_tile=512, true_num_items=1900)
    want = topk_f32.count_at_least_plain(tq.cpu(), tc.cpu(), tau.cpu(), **kw)
    for forced in (splits, None):
        got = kernels.count_at_least(tq, tc, tau, splits=forced, **kw)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert kernels.count_at_least_splits(tq, tc, **kw) > 1


@pytest.mark.parametrize("splits", [1, 3, 16])
def test_count_at_least_ties_across_splits(card, splits):
    """tau from the lane scan kernel on the corpus built to tie: a tau that
    many items share, each of which counts, whatever the splits."""
    rng = np.random.default_rng(13)
    q = rng.integers(-8, 9, size=(70, 64)).astype(np.float32) / 16
    tq = torch.from_numpy(q).to(card, torch.bfloat16)
    tc = torch.from_numpy(tied_corpus(14, 4096, 64)).to(card, torch.bfloat16)
    vals, _, _ = kernels.lane_max_scan(tq, tc, None, corpus_tile=256, slots=2)
    tau = topk.topk_stable(vals, 20)[0][:, -1].contiguous()
    want = topk_f32.count_at_least_plain(
        tq.cpu(), tc.cpu(), tau.cpu(), corpus_tile=256
    )
    assert bool((want > 20).all())  # tau is shared by many items
    got = kernels.count_at_least(tq, tc, tau, corpus_tile=256, splits=splits)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_lane_scan_and_count_run_on_tensor_cores_without_spills(
    card, tmp_path, monkeypatch
):
    """A fresh build of kernels 3 and 4: `ptxas` reports no spill in any
    instantiation, and the machine code multiplies with HGMMA."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    kernels.build(verbose=True)
    sections = kernels.last_build_log.split("== ")
    for source in ("lane_max_scan.cu", "count_at_least.cu"):
        log = next(s for s in sections if s.startswith(source))
        spills = [line for line in log.splitlines() if "spill stores" in line]
        assert spills and all("0 bytes spill stores" in line for line in spills)
        assert all("0 bytes spill loads" in line for line in spills)
        obj = next(tmp_path.glob(f"{source.removesuffix('.cu')}_*.o"))
        cuobjdump = pathlib.Path(kernels._nvcc()).with_name("cuobjdump")
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(obj)], capture_output=True,
            text=True, check=True,
        ).stdout
        assert "HGMMA" in sass


@pytest.mark.parametrize(
    "compute_dtype,loss_tol,param_tol",
    [("bfloat16", (3e-2, 1e-2), 5e-5), ("float32", (1e-4, 1e-5), 5e-5)],
)
def test_train_steps_on_the_card_match_the_cpu(
    card, tmp_path, compute_dtype, loss_tol, param_tol
):
    """Three train steps at the reference config (dropout off) on the card
    and on the CPU from one init over the same batches, at bf16 and at
    f32: losses and grad_norm within `loss_tol` (rtol, atol), parameters
    within `param_tol`. bf16 rounds differently on the two devices; f32
    differs by summation order only, but Adam divides each gradient by
    its own RMS, so a component near rounding noise moves a fair part of
    lr either way. A zeroed gradient moves
    parameters 3 * lr = 3e-4 away and a negated one up to 6e-4, past the
    bound."""
    from xfmr_rec_torch.data.module import DataConfig, RecDataModule
    from xfmr_rec_torch.training import module as train_mod

    data = RecDataModule(DataConfig(data_dir=str(tmp_path), batch_size=32))
    data.prepare_data()
    data.setup()
    batches = [b for _, b in zip(range(3), data.train_batches(0))]
    config = train_mod.TrainConfig(dropout_rate=0.0,
                                   compute_dtype=compute_dtype)
    states = [train_mod.TrainState(config, seed=0, device=d)
              for d in ("cpu", card)]
    for batch in batches:
        cpu_m, card_m = (
            train_mod.train_step(s, train_mod.batch_to_device(batch, s.device))
            for s in states
        )
        for key in cpu_m:
            torch.testing.assert_close(card_m[key].cpu(), cpu_m[key],
                                       rtol=loss_tol[0], atol=loss_tol[1])
    cpu_p, card_p = (s.model.state_dict() for s in states)
    for name, value in cpu_p.items():
        torch.testing.assert_close(card_p[name].cpu(), value, rtol=0,
                                   atol=param_tol)


@pytest.mark.parametrize(
    "compute_dtype,loss_tol,param_tol",
    [("bfloat16", (3e-2, 1e-2), 5e-5), ("float32", (1e-4, 1e-5), 5e-5)],
)
def test_history_train_steps_on_the_card_match_the_cpu(
    card, tmp_path, compute_dtype, loss_tol, param_tol
):
    """The flagship's history tower (InfoNCE, 16 history slots, ratings)
    with every item channel (Bloom ids, bias, CF bag): three train steps
    on the card and on the CPU from one init. Losses and grad_norm within
    `loss_tol`; at f32 every parameter within `param_tol`. At bf16 Adam's
    first steps move each component by about lr in its gradient's sign,
    so components whose gradient is within bf16 rounding of zero (the
    attention key biases: their exact gradient is 0) take opposite signs
    on the two devices. Those are read from the CPU alone: the f32
    gradient at the CPU run's parameters is less than 4 times its
    distance from the bf16 gradient of the CPU's step, at some step. Of every
    leaf's other moved components at most 1% part beyond `param_tol`
    (none in a leaf of fewer than 100), and all stay within
    2 * lr * steps."""
    from xfmr_rec_torch.data.module import DataConfig, RecDataModule
    from xfmr_rec_torch.training import module as train_mod

    data = RecDataModule(DataConfig(data_dir=str(tmp_path), batch_size=32,
                                    max_history=16, max_bag=16))
    data.prepare_data()
    data.setup()
    batches = [b for _, b in zip(range(3), data.train_batches(0))]
    config = train_mod.TrainConfig(
        dropout_rate=0.0, compute_dtype=compute_dtype, user_tower="history",
        max_history=16, train_loss="InfomationNoiseContrastiveEstimationLoss",
        item_id_embedding="bloom", item_bias=True, max_bag=16,
    )
    states = [train_mod.TrainState(config, seed=0, device=d)
              for d in ("cpu", card)]
    init = {n: v.clone() for n, v in states[0].model.state_dict().items()}
    config32 = dataclasses.replace(config, compute_dtype="float32")
    ref = train_mod.TrainState(config32, seed=0, device="cpu")
    zeros = {n: torch.zeros_like(p, dtype=torch.bool)
             for n, p in states[0].model.named_parameters()}
    for batch in batches:
        ref.model.load_state_dict(states[0].model.state_dict())
        ref.model.zero_grad(set_to_none=True)
        train_mod.compute_batch_losses(
            ref.model, train_mod.batch_to_device(batch, "cpu"), config32,
        )[config.train_loss].backward()
        cpu_m, card_m = (
            train_mod.train_step(s, train_mod.batch_to_device(batch, s.device))
            for s in states
        )
        for key in cpu_m:
            torch.testing.assert_close(card_m[key].cpu(), cpu_m[key],
                                       rtol=loss_tol[0], atol=loss_tol[1])
        for (name, p16), p32 in zip(states[0].model.named_parameters(),
                                    ref.model.parameters(), strict=True):
            g32 = p32.grad if p32.grad is not None else torch.zeros_like(p32)
            g16 = p16.grad if p16.grad is not None else torch.zeros_like(p16)
            zeros[name] |= g32.abs() < 4 * (g16 - g32).abs()
    cpu_p, card_p = (s.model.state_dict() for s in states)
    if compute_dtype == "float32":
        for name, value in cpu_p.items():
            torch.testing.assert_close(card_p[name].cpu(), value, rtol=0,
                                       atol=param_tol)
        return
    lr = config.learning_rate
    held_total = 0
    for name, value in cpu_p.items():
        got = card_p[name].cpu()
        diff = (got - value).abs()
        assert diff.max().item() <= 2 * lr * len(batches) * 1.01, name
        if name not in zeros:
            assert diff.max().item() <= param_tol, name
            continue
        moved = torch.maximum((value - init[name]).abs(),
                              (got - init[name]).abs()) > lr / 2
        held = moved & ~zeros[name]
        parted = int((held & (diff > param_tol)).sum())
        assert parted <= int(0.01 * int(held.sum())), (name, parted)
        held_total += int(held.sum())
    assert held_total > 10_000
