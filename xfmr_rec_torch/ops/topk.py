"""Packed-key exhaustive top-k: host glue around the two Hopper kernels.

Port of the packed ("turbo") half of `xfmr_rec_tpu/ops/topk_pallas.py`.
A corpus sweep turns every score into a non-negative int32 key

    key = (bitcast<int32>(score * s + 1.5) & ~low_mask) | tile << reserve

with queries pre-scaled so |score * s| <= 0.25: the float lies in
[1.25, 1.75), one exponent, so integer order on keys IS the order of the
quantized scores, and the low bits carry the corpus tile. Each (row,
lane) keeps its top-2 keys and, optionally, the largest key it ever
evicted (the discard certificate). Selection, lane-pair merges, retries
and pool merges then run in key space.

Three functions launch kernels: `packed_lane_scan` (kernel
`csrc/packed_scan.cu`), `select_topk_keys` (kernel
`csrc/threshold_select.cu`) and `packed_lane_scan_select` (kernel
`csrc/packed_scan_select.cu`: scan, lane-pair merge and select in one
launch). Each sends a CPU tensor to its plain PyTorch version
(`packed_lane_scan_plain`, `select_topk_keys_plain`,
`packed_lane_scan_select_plain`, same module) and a CUDA tensor to its
kernel; nothing falls back. The f32 lane-max family is in
`ops/topk_f32.py`.

Tie order: `lax.top_k` puts the lower index first among equal values,
and `torch.topk` promises no order. Every selection here goes through
`topk_stable` (a stable descending sort, sliced), so positions match the
JAX package wherever its own order is defined.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from xfmr_rec_torch.ops import kernels

NEG_INF = float("-inf")

DEFAULT_BATCH_TILE = 256
DEFAULT_CORPUS_TILE = 2048


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` semantics: the k largest along the last axis,
    descending, the lower index first among ties."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def pick_corpus_tile(num_items: int, dim: int) -> int:
    """Corpus tile (lane count) for the packed scan at this dim.

    Same rule as the JAX package (keep ct * dim <= ~400k elements, cap at
    2048, floor at 256 lanes, never above the corpus rounded up to a
    power of two), so both packages pad a corpus to the same length and
    produce the same keys.
    """
    budget = 400_000
    tile = DEFAULT_CORPUS_TILE
    while tile > 256 and tile * dim > budget:
        tile //= 2
    return min(tile, 1 << (max(num_items, 2) - 1).bit_length())


def _packed_keys(
    scores: torch.Tensor,
    step: int,
    idx_bits: int,
    reserve_bits: int = 0,
    biased: bool = False,
) -> torch.Tensor:
    """(rows, ct) f32 scaled scores -> int32 packed keys of tile `step`.

    Every operand stays int32: `~low_mask` and the stamp are Python ints
    that fit in int32, so torch does not promote.
    """
    keyf = scores if biased else scores + 1.5
    keyi = keyf.contiguous().view(torch.int32)
    low_mask = (1 << (idx_bits + reserve_bits)) - 1
    return (keyi & ~low_mask) | (step << reserve_bits)


def _scan_tiles(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    tile_begin: int,
    tile_end: int,
    *,
    corpus_tile: int,
    idx_bits: int,
    reserve_bits: int = 0,
    bias_in_dot: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
    track_discards: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The slot contest over corpus tiles [tile_begin, tile_end), each
    key stamped with its tile's index in the whole corpus: (best1, best2)
    concatenated (B, 2*ct) and the per-row discard-max (B,) or None."""
    batch = queries.shape[0]
    ct = corpus_tile
    q32 = queries.float()
    best1 = torch.zeros((batch, ct), dtype=torch.int32, device=queries.device)
    best2 = torch.zeros_like(best1)
    dmax = torch.zeros_like(best1) if track_discards else None
    lanes = torch.arange(ct, device=queries.device)
    for step in range(tile_begin, tile_end):
        tile = corpus[step * ct : (step + 1) * ct].float()
        scores = q32 @ tile.T
        if scales is not None:
            scores = scores * scales[step * ct : (step + 1) * ct].float()
        shift = (step * lane_shuffle) % ct
        if shift:
            # np.roll semantics: lane l holds tile column (l - shift) % ct
            scores = torch.roll(scores, shift, 1)
        keys = _packed_keys(
            scores, step, idx_bits, reserve_bits, biased=bias_in_dot
        )
        if true_num_items is not None:
            items = step * ct + (lanes - shift) % ct
            keys = torch.where(items < true_num_items, keys, 0)
        contender = torch.minimum(best1, keys)
        best1 = torch.maximum(best1, keys)
        if dmax is not None:
            dmax = torch.maximum(dmax, torch.minimum(best2, contender))
        best2 = torch.maximum(best2, contender)
    keys_out = torch.cat([best1, best2], dim=1)
    return keys_out, None if dmax is None else dmax.amax(dim=1)


def packed_lane_scan_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    *,
    corpus_tile: int,
    idx_bits: int,
    reserve_bits: int = 0,
    bias_in_dot: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
    track_discards: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the packed scan kernel.

    Takes the queries already scaled (and bias-augmented) as the kernel
    does. Tile loop with an f32 matmul of the bf16/int8 inputs,
    `torch.roll` for the lane shuffle, and the max/min slot contest
    (`_scan_tiles` over every tile). Returns (keys (B, 2*ct) int32,
    dmax (B,) int32 or None).
    """
    return _scan_tiles(
        queries,
        corpus,
        scales,
        0,
        corpus.shape[0] // corpus_tile,
        corpus_tile=corpus_tile,
        idx_bits=idx_bits,
        reserve_bits=reserve_bits,
        bias_in_dot=bias_in_dot,
        true_num_items=true_num_items,
        lane_shuffle=lane_shuffle,
        track_discards=track_discards,
    )


def merge_split_slots_plain(
    keys: Sequence[torch.Tensor], dmax: Sequence[torch.Tensor | None]
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of the kernel's merge of a corpus split over blocks.

    `keys[s]` (B, 2*ct) and `dmax[s]` (B,) are the slots and discard-max
    of the contest over the s-th range of tiles. A key carries its tile,
    so the top-2 of a (row, lane) over the whole corpus is the top-2 of
    its 2*S partial slots; the row's discard-max is the largest partial
    discard-max or slot that this merge drops. Integer max and min only,
    so the order of the parts does not matter."""
    ct = keys[0].shape[1] // 2
    best1 = torch.zeros_like(keys[0][:, :ct])
    best2 = torch.zeros_like(best1)
    dropped = torch.zeros_like(best1)
    for part in keys:
        for slot in (part[:, :ct], part[:, ct:]):
            contender = torch.minimum(best1, slot)
            best1 = torch.maximum(best1, slot)
            dropped = torch.maximum(dropped, torch.minimum(best2, contender))
            best2 = torch.maximum(best2, contender)
    merged = torch.cat([best1, best2], dim=1)
    if dmax[0] is None:
        return merged, None
    return merged, torch.maximum(
        torch.stack(list(dmax)).amax(dim=0), dropped.amax(dim=1)
    )


def packed_lane_scan_split_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    splits: int,
    *,
    corpus_tile: int,
    **geometry,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of the packed scan kernel with its corpus tiles
    split `splits` ways: the contest over each contiguous range of tiles
    (the kernel's own ranges), then `merge_split_slots_plain`. Equal to
    `packed_lane_scan_plain` bit for bit, whatever `splits`."""
    num_tiles = corpus.shape[0] // corpus_tile
    parts = [
        _scan_tiles(
            queries, corpus, scales, num_tiles * s // splits,
            num_tiles * (s + 1) // splits, corpus_tile=corpus_tile,
            **geometry,
        )
        for s in range(splits)
    ]
    return merge_split_slots_plain(
        [keys for keys, _ in parts], [dmax for _, dmax in parts]
    )


def prepare_packed_scan(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    *,
    score_bound: float | torch.Tensor = 1.0,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    idx_bits: int | None = None,
    reserve_bits: int = 0,
    bias_in_dot: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
    scales: torch.Tensor | None = None,
    track_discards: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None, dict]:
    """Validate a packed scan and build the kernel's inputs: (queries
    scaled by 0.25/score_bound and bias-augmented, flat f32 scales or
    None, geometry keywords shared by the kernel and its plain version).

    The query is scaled in f32 and rounded back to its own dtype before
    the dot, exactly as the JAX package does, so both produce the same
    keys.
    """
    batch = queries.shape[0]
    num_items = corpus.shape[0]
    batch_tile = min(batch_tile, batch)
    corpus_tile = min(corpus_tile, num_items)
    if batch % batch_tile or num_items % corpus_tile:
        msg = (
            f"shapes must tile evenly: {batch=} % {batch_tile=}, "
            f"{num_items=} % {corpus_tile=}"
        )
        raise ValueError(msg)
    num_tiles = num_items // corpus_tile
    if idx_bits is None:
        idx_bits = max((num_tiles - 1).bit_length(), 1)
    if num_tiles > (1 << idx_bits):
        msg = f"{num_tiles=} does not fit in {idx_bits=}"
        raise ValueError(msg)
    if idx_bits + reserve_bits > 20:
        msg = (
            f"{idx_bits=} + {reserve_bits=} leaves fewer than 3 mantissa "
            "bits of score resolution"
        )
        raise ValueError(msg)
    if lane_shuffle < 0:
        msg = f"{lane_shuffle=} must be non-negative"
        raise ValueError(msg)
    scale = 0.25 / torch.as_tensor(
        score_bound, dtype=torch.float32, device=queries.device
    )
    queries = (queries.float() * scale).to(queries.dtype)
    if bias_in_dot:
        if scales is not None:
            msg = "bias_in_dot is incompatible with int8 scales"
            raise ValueError(msg)
        if corpus.shape[1] != queries.shape[1] + 1:
            msg = (
                "bias_in_dot expects the corpus to carry a trailing "
                f"1.5 column: corpus dim {corpus.shape[1]} != query dim "
                f"{queries.shape[1]} + 1"
            )
            raise ValueError(msg)
        queries = torch.cat(
            [queries, torch.ones_like(queries[:, :1])], dim=1
        )
    if true_num_items is not None and true_num_items >= num_items:
        true_num_items = None
    if scales is not None:
        scales = scales.reshape(-1).float()
    geometry = dict(
        corpus_tile=corpus_tile,
        idx_bits=idx_bits,
        reserve_bits=reserve_bits,
        bias_in_dot=bias_in_dot,
        true_num_items=true_num_items,
        lane_shuffle=lane_shuffle,
        track_discards=track_discards,
    )
    return queries, scales, geometry


def packed_lane_scan(
    queries: torch.Tensor, corpus: torch.Tensor, **options
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One packed-key sweep -> (keys (B, 2*ct) int32, dmax (B,) int32,
    or None with track_discards=False).

    Options as `prepare_packed_scan` (the JAX `packed_lane_scan`
    contract): `score_bound` must upper-bound |score|; `bias_in_dot`
    expects a corpus with a trailing 1.5 column; `batch_tile` keeps the
    JAX shape contract (the batch must tile evenly), though the CUDA
    kernel itself takes any batch. A CPU tensor runs the plain version,
    a CUDA tensor the kernel.
    """
    queries, scales, geometry = prepare_packed_scan(queries, corpus, **options)
    if queries.device.type == "cpu":
        return packed_lane_scan_plain(queries, corpus, scales, **geometry)
    return kernels.packed_scan(queries, corpus, scales, **geometry)


def merge_lane_pairs3(
    key1: torch.Tensor, key2: torch.Tensor, level: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the top-3 of each lane pair's 4 keys (2+2 bitonic network).

    Pairs column j with column j + w/2; survivors from the upper half get
    bit `level` stamped. Returns (top1, top2, top3, disc_max (B,)).
    """
    w = key1.shape[1] // 2
    bit = 1 << level
    a1, a2 = key1[:, :w], key2[:, :w]
    b1, b2 = key1[:, w:] | bit, key2[:, w:] | bit
    lo1 = torch.minimum(a1, b1)
    hi2 = torch.maximum(a2, b2)
    top1 = torch.maximum(a1, b1)
    top2 = torch.maximum(lo1, hi2)
    top3 = torch.minimum(lo1, hi2)
    disc = torch.minimum(a2, b2)
    return top1, top2, top3, disc.amax(dim=-1)


def merge_lane_pairs(
    key1: torch.Tensor, key2: torch.Tensor, level: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the top-2 keys of each lane pair (column j with j + w/2),
    stamping bit `level` on upper-half survivors. Returns (key1', key2',
    disc_max (B,)); the caller folds disc_max into the discard-max."""
    w = key1.shape[1] // 2
    bit = 1 << level
    a1, a2 = key1[:, :w], key2[:, :w]
    b1, b2 = key1[:, w:] | bit, key2[:, w:] | bit
    awins = a1 >= b1
    top1 = torch.where(awins, a1, b1)
    top2 = torch.where(
        awins, torch.maximum(a2, b1), torch.maximum(b2, a1)
    )
    disc = torch.maximum(
        torch.where(awins, torch.minimum(a2, b1), torch.minimum(b2, a1)),
        torch.where(awins, b2, a2),
    )
    return top1, top2, disc.amax(dim=-1)


def unpack_positions(
    keys: torch.Tensor,
    lane_index: torch.Tensor,
    *,
    corpus_tile: int,
    idx_bits: int,
    lane_shuffle: int = 0,
    reserve_bits: int = 0,
    merge_levels: int = 0,
) -> torch.Tensor:
    """Corpus positions from packed keys + their index into the key pool
    (width = ct >> merge_levels; merge stamps restore the pre-merge lane,
    the lane shuffle is undone per tile)."""
    lane_index = lane_index.to(torch.int32)
    tile = (keys >> reserve_bits) & ((1 << idx_bits) - 1)
    width = corpus_tile >> merge_levels
    lane = lane_index % width
    for level in range(merge_levels):
        lane = lane + ((keys >> level) & 1) * (corpus_tile >> (level + 1))
    if lane_shuffle:
        col = (lane - tile * lane_shuffle % corpus_tile + corpus_tile) % (
            corpus_tile
        )
    else:
        col = lane
    return tile * corpus_tile + col


def _tau_seed(
    pool: torch.Tensor, shared_exponent: bool
) -> tuple[torch.Tensor, int]:
    """(B, 1) start of the search for tau and its highest searched bit:
    the row max's exponent bits and bit 22, or 0 and bit 30."""
    if shared_exponent:
        return pool.amax(dim=1, keepdim=True) & ~((1 << 23) - 1), 22
    return torch.zeros((pool.shape[0], 1), dtype=torch.int32,
                       device=pool.device), 30


def bit_tau_plain(
    pool: torch.Tensor,
    k: int,
    quantum_bits: int = 0,
    shared_exponent: bool = False,
) -> torch.Tensor:
    """(B, 1) tau of the threshold select by the TPU kernel's bit search:
    from the seed, each bit from the highest searched one down to
    `quantum_bits` is kept when at least k keys are >= tau | bit."""
    tau, high_bit = _tau_seed(pool, shared_exponent)
    for bit in range(high_bit, quantum_bits - 1, -1):
        cand = tau | (1 << bit)
        count = (pool >= cand).sum(dim=1, keepdim=True)
        tau = torch.where(count >= k, cand, tau)
    return tau


RADIX_BITS = 8


def radix_tau_plain(
    pool: torch.Tensor,
    k: int,
    quantum_bits: int = 0,
    shared_exponent: bool = False,
) -> torch.Tensor:
    """(B, 1) tau of the threshold select by the Hopper kernel's radix
    search, its plain version.

    The searched bits (from 22 or 30 down to `quantum_bits`) are taken in
    digits of at most RADIX_BITS from the top. Per digit: the histogram
    of the digit over the keys that carry tau's bits above it, and the
    highest bin whose suffix count reaches the keys still needed; when
    the keys with the prefix are fewer (only at the first digit, where
    fewer than k keys reach the seed), tau stays. Equals `bit_tau_plain`
    on every input.
    """
    tau, high_bit = _tau_seed(pool, shared_exponent)
    keys = pool.to(torch.int64)
    tau = tau.to(torch.int64)
    need = torch.full_like(tau, k)
    top = high_bit + 1
    while top > quantum_bits:
        shift = max(top - RADIX_BITS, quantum_bits)
        bins = 1 << (top - shift)
        inside = (keys >> top) == (tau >> top)
        digit = (keys >> shift) & (bins - 1)
        hist = torch.zeros((pool.shape[0], bins + 1), dtype=torch.int64,
                           device=pool.device)
        hist.scatter_add_(1, digit, inside.to(torch.int64))
        # suffix[:, b]: keys with the prefix in bins >= b (suffix[:, bins] = 0)
        suffix = hist.flip(1).cumsum(1).flip(1)
        reach = suffix[:, :bins] >= need
        found = reach.any(dim=1, keepdim=True)
        # suffix counts fall with the bin: the reaching bins are 0..bin
        chosen = reach.sum(dim=1, keepdim=True) - 1
        above = suffix.gather(1, (chosen + 1).clamp(min=0))
        tau = torch.where(found, tau | (chosen.clamp(min=0) << shift), tau)
        need = torch.where(found, need - above, need)
        top = shift
    return tau.to(torch.int32)


def select_topk_keys_plain(
    pool: torch.Tensor,
    k: int,
    *,
    capacity: int,
    quantum_bits: int = 0,
    shared_exponent: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the threshold-select kernel.

    Per row: the k-th largest key by bit search (seeded from the shared
    exponent, stopping at `quantum_bits`), then every key above the tau
    quantum plus tau-quantum ties in lane order up to `capacity`,
    compacted to their rank. Returns ((B, capacity) keys, (B, capacity)
    meta = lane + 1), empty slots 0, rank order (= lane order).
    """
    batch, width = pool.shape
    device = pool.device
    tau = bit_tau_plain(pool, k, quantum_bits, shared_exponent)
    floor = torch.clamp(tau, min=1)
    # int32 wrap-around like the reference's jnp arithmetic
    step = torch.tensor(1 << quantum_bits, dtype=torch.int32, device=device)
    mask_ge = pool >= floor
    mask_gt = pool >= (floor.to(torch.int64) + step).to(torch.int32)
    tie = mask_ge & ~mask_gt
    gt_rank = torch.cumsum(mask_gt.to(torch.int32), dim=1) - mask_gt.int()
    tie_rank = torch.cumsum(tie.to(torch.int32), dim=1) - tie.int()
    n_gt = mask_gt.sum(dim=1, keepdim=True)
    budget = capacity - n_gt
    keep = mask_gt | (tie & (tie_rank < budget))
    rank = gt_rank + torch.minimum(tie_rank, budget)
    slot = torch.where(keep, rank, capacity).to(torch.int64)
    lanes = torch.arange(1, width + 1, dtype=torch.int32, device=device)
    keys_out = torch.zeros(
        (batch, capacity + 1), dtype=torch.int32, device=device
    )
    meta_out = torch.zeros_like(keys_out)
    keys_out.scatter_(1, slot, torch.where(keep, pool, 0))
    meta_out.scatter_(
        1, slot, torch.where(keep, lanes.expand(batch, -1), 0)
    )
    # slot `capacity` collects every dropped lane and is cut off
    return keys_out[:, :capacity], meta_out[:, :capacity]


def select_topk_keys(
    pool: torch.Tensor,
    k: int,
    *,
    capacity: int = 128,
    quantum_bits: int = 0,
    shared_exponent: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a non-negative int32 key pool by threshold-select.

    Returns (keys (B, k) descending, lane_index (B, k)): `lax.top_k`
    over the pool where ties may resolve to either tied element at the
    key quantum (`quantum_bits`), the certificate's own granularity.
    `shared_exponent` asserts every nonzero key shares bits 30..23.
    The final sort over `capacity` lanes is `topk_stable`, as
    `lax.top_k` is outside the Pallas kernel.
    """
    if not 0 < k <= capacity:
        msg = f"need 0 < {k=} <= {capacity=}"
        raise ValueError(msg)
    if capacity % 128:
        msg = f"{capacity=} must be a multiple of 128"
        raise ValueError(msg)
    width = pool.shape[1]
    if width % 128:
        msg = f"pool width {width} must be a multiple of 128"
        raise ValueError(msg)
    if width <= capacity:
        return topk_stable(pool, k)
    fb = width.bit_length()  # lane + 1 fits in fb bits
    if 2 * fb + 1 > 31:
        msg = f"pool width {width} too wide for packed meta routing"
        raise ValueError(msg)
    options = dict(
        capacity=capacity,
        quantum_bits=quantum_bits,
        shared_exponent=shared_exponent,
    )
    if pool.device.type == "cpu":
        sel_keys, meta = select_topk_keys_plain(pool, k, **options)
    else:
        sel_keys, meta = kernels.threshold_select(pool, k, **options)
    # empty slots (meta 0) clamp to lane 0; their key 0 keeps them last
    sel_lanes = torch.clamp((meta & ((1 << fb) - 1)) - 1, min=0)
    top_keys, sel = topk_stable(sel_keys, k)
    return top_keys, torch.gather(sel_lanes, 1, sel)


def _clamp_merge_levels(
    ct: int, k: int, merge_levels: int, merge_keep: int
) -> int:
    if merge_keep == 3 and merge_levels:
        # keep-3 buffers do not pair up again: single level only
        merge_levels = 1 if 3 * (ct >> 1) >= k else 0
    while merge_levels and 2 * (ct >> merge_levels) < k:
        merge_levels -= 1
    return merge_levels


def _pool_width(ct: int, merge_levels: int, merge_keep: int) -> int:
    """Width of the merged key pool (`merge_levels` already clamped)."""
    if merge_levels and merge_keep == 3:
        return 3 * (ct >> 1)
    return 2 * (ct >> merge_levels)


def _merge_slots(
    keys: torch.Tensor,
    dmax: torch.Tensor | None,
    merge_levels: int,
    merge_keep: int,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, 2*ct) slot buffers -> the merged key pool, the merges'
    discards folded into dmax (`merge_levels` already clamped)."""
    ct = keys.shape[1] // 2
    key1, key2 = keys[:, :ct], keys[:, ct:]
    if merge_levels and merge_keep == 3:
        key1, key2, key3, disc = merge_lane_pairs3(key1, key2, 0)
        if dmax is not None:
            dmax = torch.maximum(dmax, disc)
        return torch.cat([key1, key2, key3], dim=-1), dmax
    for level in range(merge_levels):
        key1, key2, disc = merge_lane_pairs(key1, key2, level)
        if dmax is not None:
            dmax = torch.maximum(dmax, disc)
    return torch.cat([key1, key2], dim=-1), dmax


def packed_lane_scan_select_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    k: int,
    *,
    corpus_tile: int,
    idx_bits: int,
    merge_levels: int = 0,
    merge_keep: int = 2,
    capacity: int = 128,
    bias_in_dot: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused scan + merge + select kernel:
    the plain packed scan (discards tracked), the lane-pair merges, then
    the plain threshold select at the key quantum. Takes the queries
    already scaled and `merge_levels` already clamped, as the kernel
    does. Returns (keys (B, capacity), meta (B, capacity), dmax (B,))."""
    keys, dmax = packed_lane_scan_plain(
        queries,
        corpus,
        scales,
        corpus_tile=corpus_tile,
        idx_bits=idx_bits,
        reserve_bits=merge_levels,
        bias_in_dot=bias_in_dot,
        true_num_items=true_num_items,
        lane_shuffle=lane_shuffle,
    )
    pool, dmax = _merge_slots(keys, dmax, merge_levels, merge_keep)
    sel_keys, sel_meta = select_topk_keys_plain(
        pool,
        k,
        capacity=capacity,
        quantum_bits=idx_bits + merge_levels,
        shared_exponent=True,
    )
    return sel_keys, sel_meta, dmax


def packed_lane_scan_select(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    score_bound: float | torch.Tensor = 1.0,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    idx_bits: int | None = None,
    merge_levels: int = 0,
    merge_keep: int = 2,
    capacity: int | None = None,
    bias_in_dot: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed sweep + lane-pair merge + threshold select in ONE kernel.

    Returns (sel_keys (B, capacity) i32, sel_lanes (B, capacity) i32,
    dmax (B,) i32): per row the top-`capacity` candidate keys of the
    merged slot pool (rank order, not sorted; empty slots key 0, lane
    0), their pool lane indices (decode with `unpack_positions`,
    reserve_bits=merge_levels) and the discard-max with the merge
    discards folded in. Callers finish with a top-k over `capacity`
    lanes. Ties at the key quantum may resolve to either tied element.
    Same `score_bound` / `bias_in_dot` / `scales` contract as
    `packed_lane_scan`. A CPU tensor runs the plain version, a CUDA
    tensor the kernel.
    """
    ct = min(corpus_tile, corpus.shape[0])
    if idx_bits is None:
        idx_bits = max((corpus.shape[0] // ct - 1).bit_length(), 1)
    if idx_bits + merge_levels > 20:
        msg = (
            f"{idx_bits=} + reserve {merge_levels} leaves fewer than 3 "
            "mantissa bits of score resolution"
        )
        raise ValueError(msg)
    merge_levels = _clamp_merge_levels(ct, k, merge_levels, merge_keep)
    pool_width = _pool_width(ct, merge_levels, merge_keep)
    if capacity is None:
        capacity = _round_up(k, 128)
    if not 0 < k <= capacity:
        msg = f"need 0 < {k=} <= {capacity=}"
        raise ValueError(msg)
    if capacity % 128 or pool_width % 128:
        msg = f"{capacity=} / {pool_width=} must be multiples of 128"
        raise ValueError(msg)
    if capacity > pool_width:
        msg = f"{capacity=} exceeds the merged pool width {pool_width}"
        raise ValueError(msg)
    fb = pool_width.bit_length()
    if 2 * fb + 1 > 31:
        msg = f"merged pool width {pool_width} too wide for meta routing"
        raise ValueError(msg)
    queries, scales, geometry = prepare_packed_scan(
        queries,
        corpus,
        score_bound=score_bound,
        batch_tile=batch_tile,
        corpus_tile=corpus_tile,
        idx_bits=idx_bits,
        reserve_bits=merge_levels,
        bias_in_dot=bias_in_dot,
        true_num_items=true_num_items,
        lane_shuffle=lane_shuffle,
        scales=scales,
    )
    # the fused kernel always tracks discards and takes the merge depth
    # where the scan takes its reserved bits
    del geometry["track_discards"], geometry["reserve_bits"]
    fused = (
        packed_lane_scan_select_plain
        if queries.device.type == "cpu"
        else kernels.packed_scan_select
    )
    sel_keys, sel_meta, dmax = fused(
        queries,
        corpus,
        scales,
        k,
        merge_levels=merge_levels,
        merge_keep=merge_keep,
        capacity=capacity,
        **geometry,
    )
    # empty slots (meta 0) clamp to lane 0; their key 0 keeps them last
    sel_lanes = torch.clamp((sel_meta & ((1 << fb) - 1)) - 1, min=0)
    return sel_keys, sel_lanes, dmax


def packed_certified_parts(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    score_bound: float | torch.Tensor = 1.0,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    idx_bits: int | None = None,
    merge_levels: int = 0,
    merge_keep: int = 2,
    bias_in_dot: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
    scales: torch.Tensor | None = None,
    selector: str = "auto",
    track_discards: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Packed scan + top-k: (top_keys (B, k) i32, positions (B, k) i32,
    dmax (B,) i32 or None with track_discards=False).

    `selector`: "fused" runs scan, merge and threshold select as ONE
    kernel (`packed_lane_scan_select`; no key pool in device memory),
    "threshold" the scan, then `select_topk_keys` over the merged pool,
    "topk" a stable sort of the pool, "auto" the two-kernel threshold
    path once the pool is at least 4x `capacity` wide (as the reference
    routes it), else the sort. The fused kernel always tracks discards,
    so with `track_discards=False` "fused" runs as "topk".
    """
    if merge_keep not in (2, 3):
        msg = f"merge_keep must be 2 or 3, got {merge_keep}"
        raise ValueError(msg)
    if selector not in ("auto", "fused", "threshold", "topk"):
        msg = f"unknown {selector=}"
        raise ValueError(msg)
    if not track_discards and selector == "fused":
        selector = "topk"
    ct = min(corpus_tile, corpus.shape[0])
    num_tiles = corpus.shape[0] // ct
    if idx_bits is None:
        idx_bits = max((num_tiles - 1).bit_length(), 1)
    merge_levels = _clamp_merge_levels(ct, k, merge_levels, merge_keep)
    capacity = _round_up(k, 128)
    decode = dict(
        corpus_tile=ct,
        idx_bits=idx_bits,
        lane_shuffle=lane_shuffle,
        reserve_bits=merge_levels,
        merge_levels=merge_levels,
    )
    if selector == "fused":
        sel_keys, sel_lanes, dmax = packed_lane_scan_select(
            queries,
            corpus,
            k,
            score_bound=score_bound,
            batch_tile=batch_tile,
            corpus_tile=corpus_tile,
            idx_bits=idx_bits,
            merge_levels=merge_levels,
            merge_keep=merge_keep,
            capacity=capacity,
            bias_in_dot=bias_in_dot,
            true_num_items=true_num_items,
            lane_shuffle=lane_shuffle,
            scales=scales,
        )
        top_keys, sel = topk_stable(sel_keys, k)
        top_lanes = torch.gather(sel_lanes, 1, sel)
        return top_keys, unpack_positions(top_keys, top_lanes, **decode), dmax
    keys, dmax = packed_lane_scan(
        queries,
        corpus,
        score_bound=score_bound,
        batch_tile=batch_tile,
        corpus_tile=corpus_tile,
        idx_bits=idx_bits,
        reserve_bits=merge_levels,
        bias_in_dot=bias_in_dot,
        true_num_items=true_num_items,
        lane_shuffle=lane_shuffle,
        scales=scales,
        track_discards=track_discards,
    )
    pool, dmax = _merge_slots(keys, dmax, merge_levels, merge_keep)
    use_threshold = selector == "threshold" or (
        selector == "auto" and pool.shape[1] >= 4 * capacity
    )
    if use_threshold:
        top_keys, top_lanes = select_topk_keys(
            pool,
            k,
            capacity=capacity,
            quantum_bits=idx_bits + merge_levels,
            shared_exponent=True,
        )
    else:
        top_keys, top_lanes = topk_stable(pool, k)
    return top_keys, unpack_positions(top_keys, top_lanes, **decode), dmax


def decode_scores(
    keys: torch.Tensor,
    *,
    idx_bits: int,
    score_bound: float | torch.Tensor = 1.0,
    reserve_bits: int = 0,
) -> torch.Tensor:
    """Packed keys -> quantized scores (floor at the key quantum)."""
    low = (1 << (idx_bits + reserve_bits)) - 1
    keyf = (keys & ~low).contiguous().view(torch.float32)
    bound = torch.as_tensor(
        score_bound, dtype=torch.float32, device=keys.device
    )
    return (keyf - 1.5) * (bound / 0.25)


def exact_scores_at(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    positions: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exact f32 scores for selected positions: (B, k) gather + dot."""
    rows = corpus[positions.long()].to(queries.dtype)  # (B, k, D)
    scores = torch.einsum("bd,bkd->bk", queries.float(), rows.float())
    if scales is not None:
        scores = scores * scales.reshape(-1).float()[positions.long()]
    return scores


def packed_certified_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    score_bound: float | torch.Tensor = 1.0,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    idx_bits: int | None = None,
    merge_levels: int = 0,
    merge_keep: int = 2,
    bias_in_dot: bool = False,
    true_num_items: int | None = None,
    scales: torch.Tensor | None = None,
    recompute_scores: bool = True,
    selector: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed certified top-k: (scores (B, k) f32, positions (B, k) i32,
    exact (B,) bool). `exact` certifies the packed (quantized) order."""
    ct = min(corpus_tile, corpus.shape[0])
    num_tiles = corpus.shape[0] // ct
    if idx_bits is None:
        idx_bits = max((num_tiles - 1).bit_length(), 1)
    merge_levels = _clamp_merge_levels(ct, k, merge_levels, merge_keep)
    top_keys, positions, dmax = packed_certified_parts(
        queries,
        corpus,
        k,
        score_bound=score_bound,
        batch_tile=batch_tile,
        corpus_tile=corpus_tile,
        idx_bits=idx_bits,
        merge_levels=merge_levels,
        merge_keep=merge_keep,
        bias_in_dot=bias_in_dot,
        true_num_items=true_num_items,
        scales=scales,
        selector=selector,
    )
    tau = top_keys[:, k - 1]
    # stamped padding keys reach (1 << merge_levels) - 1; real keys are
    # >= bitcast(1.25)
    exact = (dmax <= tau) & (tau > (1 << merge_levels) - 1)
    if recompute_scores:
        c = corpus[:, :-1] if bias_in_dot else corpus
        scores = exact_scores_at(queries, c, positions, scales=scales)
    else:
        scores = decode_scores(
            top_keys,
            idx_bits=idx_bits,
            score_bound=score_bound,
            reserve_bits=merge_levels,
        )
    return scores, positions, exact


def packed_topk_excluding(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    exclude_positions: torch.Tensor | None = None,
    score_bound: float | torch.Tensor = 1.0,
    true_num_items: int | None = None,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    merge_levels: int = 1,
    merge_keep: int = 2,
    bias_in_dot: bool = False,
    scales: torch.Tensor | None = None,
    recompute_scores: bool = False,
    selector: str = "topk",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-key top-k with per-row exclusions (the `search` hot path).

    Fetches k + E candidates from the packed pool, zeroes the keys at
    excluded positions and takes the final top-k, so E exclusions can
    never push a wanted item out. No certificate: the scan skips the
    discard bookkeeping. Scores are quantum-floor decodes, or exact f32
    with `recompute_scores=True`; exhausted slots score -inf.
    """
    batch = queries.shape[0]
    batch_tile = min(batch_tile, _round_up(batch, 8))
    pad_rows = -batch % batch_tile
    if pad_rows:
        queries = torch.nn.functional.pad(queries, (0, 0, 0, pad_rows))
        if exclude_positions is not None:
            exclude_positions = torch.nn.functional.pad(
                exclude_positions, (0, 0, 0, pad_rows)
            )
    slack = 0 if exclude_positions is None else exclude_positions.shape[1]
    ct = min(corpus_tile, corpus.shape[0])
    merge_levels = _clamp_merge_levels(ct, k + slack, merge_levels, merge_keep)
    pool = _pool_width(ct, merge_levels, merge_keep)
    if slack and k + slack > pool and corpus.shape[0] > pool:
        msg = (
            f"exclusion width {slack} + {k=} exceeds the packed candidate "
            f"pool ({pool} = unmerged 2 slots x {ct} lanes); "
            "raise corpus_tile or use the dense method"
        )
        raise ValueError(msg)
    fetch = min(k + slack, pool)
    num_tiles = corpus.shape[0] // ct
    idx_bits = max((num_tiles - 1).bit_length(), 1)
    keys, positions, _ = packed_certified_parts(
        queries,
        corpus,
        fetch,
        score_bound=score_bound,
        batch_tile=batch_tile,
        corpus_tile=corpus_tile,
        idx_bits=idx_bits,
        merge_levels=merge_levels,
        merge_keep=merge_keep,
        bias_in_dot=bias_in_dot,
        true_num_items=true_num_items,
        scales=scales,
        selector=selector,
        track_discards=False,
    )
    if exclude_positions is not None:
        hit = (
            positions[:, :, None] == exclude_positions[:, None, :]
        ).any(dim=-1)
        keys = torch.where(hit, 0, keys)
    top_keys, sel = topk_stable(keys, k)
    top_pos = torch.gather(positions, 1, sel)
    # masked/exhausted keys are 0; stamped padding keys reach
    # (1 << merge_levels) - 1: both below any real key
    real = top_keys > (1 << merge_levels) - 1
    if recompute_scores:
        c = corpus[:, :-1] if bias_in_dot else corpus
        scores = exact_scores_at(queries, c, top_pos, scales=scales)
    else:
        scores = decode_scores(
            top_keys,
            idx_bits=idx_bits,
            score_bound=score_bound,
            reserve_bits=merge_levels,
        )
    scores = torch.where(real, scores, NEG_INF)
    return scores[:batch], top_pos[:batch]


def _dedupe_pool_keys(
    pool_keys: torch.Tensor, pool_pos: torch.Tensor
) -> torch.Tensor:
    """Zero all but the best key per position within each row's pool
    (ties: the earlier column wins), as the JAX package does."""
    width = pool_keys.shape[-1]
    pos_eq = pool_pos[:, :, None] == pool_pos[:, None, :]
    key_i = pool_keys[:, :, None]
    key_j = pool_keys[:, None, :]
    idx = torch.arange(width, device=pool_keys.device)
    j_beats_i = (key_j > key_i) | (
        (key_j == key_i) & (idx[None, :] < idx[:, None])
    )
    dup = (pos_eq & j_beats_i).any(dim=-1)
    return torch.where(dup, 0, pool_keys)


def _retry_widths(
    batch: int,
    retries: int,
    merge_levels: int,
    merge_keep: int,
    retry_width: int | Sequence[int] | None,
) -> list[int]:
    """Per-round retry slot counts (the JAX package's schedule)."""
    if retry_width is None:
        if merge_levels and merge_keep == 2:
            first, later = batch // 4, batch // 16
        else:
            first, later = batch // 16, batch // 64
        widths = [max(64, first)] + [max(64, later)] * max(retries - 1, 0)
    elif isinstance(retry_width, Sequence):
        widths = [int(w) for w in retry_width]
        if not widths:
            msg = "retry_width sequence must be non-empty"
            raise ValueError(msg)
        if len(widths) < retries:
            widths += [widths[-1]] * (retries - len(widths))
    else:
        widths = [int(retry_width)] * retries
    return [_round_up(min(w, batch), 8) for w in widths[:retries]]


def packed_guaranteed_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    score_bound: float | torch.Tensor = 1.0,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    merge_levels: int = 1,
    merge_keep: int = 3,
    bias_in_dot: bool = False,
    true_num_items: int | None = None,
    scales: torch.Tensor | None = None,
    retry_width: int | Sequence[int] | None = None,
    retries: int = 2,
    recompute_scores: bool = False,
    selector: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Guaranteed-exact top-k: certified pass 1, lane-shuffled retries
    (shuffles 1, 3, 5, ...) of the uncertified rows, key-space pool
    merges with position dedupe. Returns (scores, positions, exact);
    callers re-run `~exact` rows through the dense path.

    Rows to retry are gathered into a fixed-width slot batch like
    `jnp.nonzero(size=width, fill_value=0)`: the first `width` failing
    rows, padded with row 0. Fill and duplicate slots recompute the same
    values and write them back unchanged, so the scatter is benign.
    """
    true_batch = queries.shape[0]
    batch_tile = min(batch_tile, _round_up(true_batch, 8))
    pad_rows = -true_batch % batch_tile
    if pad_rows:
        # zero queries tie every item at one key: they certify trivially
        queries = torch.nn.functional.pad(queries, (0, 0, 0, pad_rows))
    batch = queries.shape[0]
    ct = min(corpus_tile, corpus.shape[0])
    num_tiles = corpus.shape[0] // ct
    idx_bits = max((num_tiles - 1).bit_length(), 1)
    merge_levels = _clamp_merge_levels(ct, k, merge_levels, merge_keep)
    min_real = (1 << merge_levels) - 1
    widths = _retry_widths(
        batch, retries, merge_levels, merge_keep, retry_width
    )

    def sweep(q, shuffle):
        return packed_certified_parts(
            q,
            corpus,
            k,
            score_bound=score_bound,
            batch_tile=batch_tile,
            corpus_tile=corpus_tile,
            idx_bits=idx_bits,
            merge_levels=merge_levels,
            merge_keep=merge_keep,
            bias_in_dot=bias_in_dot,
            true_num_items=true_num_items,
            lane_shuffle=shuffle,
            scales=scales,
            selector=selector,
        )

    keys, positions, dmax = sweep(queries, 0)
    tau = keys[:, k - 1]
    exact = (dmax <= tau) & (tau > min_real)
    for attempt in range(retries):
        # The JAX pipeline skips a round on device (lax.cond). Eager
        # PyTorch decides on the host: one sync per round.
        failing = torch.nonzero(~exact).flatten()
        if failing.numel() == 0:
            break
        width = widths[attempt]
        bad_idx = torch.zeros(width, dtype=torch.int64, device=keys.device)
        take = min(width, failing.numel())
        bad_idx[:take] = failing[:take]
        need = ~exact[bad_idx]
        keys2, pos2, dmax2 = sweep(queries[bad_idx], 2 * attempt + 1)
        pool_keys = torch.cat([keys[bad_idx], keys2], dim=-1)
        pool_pos = torch.cat([positions[bad_idx], pos2], dim=-1)
        pool_keys = _dedupe_pool_keys(pool_keys, pool_pos)
        merged_keys, sel = topk_stable(pool_keys, k)
        merged_pos = torch.gather(pool_pos, 1, sel)
        merged_dmax = torch.minimum(dmax[bad_idx], dmax2)
        merged_tau = merged_keys[:, k - 1]
        merged_exact = (merged_dmax <= merged_tau) & (merged_tau > min_real)
        keys = keys.index_put(
            (bad_idx,), torch.where(need[:, None], merged_keys, keys[bad_idx])
        )
        positions = positions.index_put(
            (bad_idx,),
            torch.where(need[:, None], merged_pos, positions[bad_idx]),
        )
        dmax = dmax.index_put(
            (bad_idx,), torch.where(need, merged_dmax, dmax[bad_idx])
        )
        exact = exact.index_put(
            (bad_idx,), torch.where(need, merged_exact, exact[bad_idx])
        )
    if recompute_scores:
        c = corpus[:, :-1] if bias_in_dot else corpus
        scores = exact_scores_at(queries, c, positions, scales=scales)
    else:
        scores = decode_scores(
            keys,
            idx_bits=idx_bits,
            score_bound=score_bound,
            reserve_bits=merge_levels,
        )
    return scores[:true_batch], positions[:true_batch], exact[:true_batch]
