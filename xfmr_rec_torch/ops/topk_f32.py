"""f32 lane-max exhaustive top-k: host glue around two Hopper kernels.

Port of the f32 half of `xfmr_rec_tpu/ops/topk_pallas.py`. One corpus
sweep keeps, for every query row and every lane (position mod the corpus
tile width), the top-1 or top-2 f32 scores with their corpus positions;
an exact top-k over those lane buffers follows. Two of a row's true
top-k items that share a lane with a third lose the smallest, so the
sweep also keeps the largest score that ever left a lane: when that
discard-max is at most the k-th score found, every item above the k-th
is still in the buffers and the row is provably exact
(`certified_topk`, method "discard"). Method "count" certifies the same
by a second sweep that counts the scores at or above the k-th.

Two functions launch kernels: `lane_max_scan` (`csrc/lane_max_scan.cu`)
and `count_at_least` (`csrc/count_at_least.cu`). Each sends a CPU tensor
to its plain PyTorch version (`lane_max_scan_plain`,
`count_at_least_plain`, same module) and a CUDA tensor to its kernel;
nothing falls back. The lane scan kernel splits the corpus tiles over
blocks at small batches and merges the parts in tile order;
`lane_max_scan_split_plain` is the plain version of that. Selections go
through `topk_stable`, as in `ops/topk.py`.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from xfmr_rec_torch.ops import kernels
from xfmr_rec_torch.ops.topk import (
    DEFAULT_BATCH_TILE,
    DEFAULT_CORPUS_TILE,
    NEG_INF,
    _round_up,
    topk_stable,
)
from xfmr_rec_torch.utils.profiling import span


def _scan_tiles(
    queries: torch.Tensor, corpus: torch.Tensor, batch_tile: int,
    corpus_tile: int,
) -> int:
    """The corpus tile clamped to the corpus; raises unless batch and
    corpus tile evenly (the JAX package's shape contract, though the
    CUDA kernels themselves take any batch)."""
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
    return corpus_tile


def _lane_scan_tiles(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    tile_begin: int,
    tile_end: int,
    *,
    corpus_tile: int,
    slots: int = 1,
    track_discards: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """The strict-`>` slot contest over corpus tiles [tile_begin,
    tile_end): (vals, pos, dmax or None) as `lane_max_scan_plain` returns
    them, and (B, ct) `first`: with two slots, the position of the first
    item that held slot 2's value (slot 1's when an item tied with slot 1
    took slot 2), which the merge of a split needs."""
    batch = queries.shape[0]
    ct = corpus_tile
    device = queries.device
    q32 = queries.float()
    lanes = torch.arange(ct, dtype=torch.int32, device=device)
    vals = [
        torch.full((batch, ct), NEG_INF, dtype=torch.float32, device=device)
        for _ in range(slots)
    ]
    pos = [
        torch.zeros((batch, ct), dtype=torch.int32, device=device)
        for _ in range(slots)
    ]
    first = [torch.zeros((batch, ct), dtype=torch.int32, device=device)]
    dropped = torch.full((batch, ct), NEG_INF, device=device)
    for step in range(tile_begin, tile_end):
        tile = corpus[step * ct : (step + 1) * ct].float()
        scores = q32 @ tile.T
        if scales is not None:
            scores = scores * scales[step * ct : (step + 1) * ct]
        shift = (step * lane_shuffle) % ct
        if shift:
            # np.roll semantics: lane l holds tile column (l - shift) % ct
            scores = torch.roll(scores, shift, 1)
        positions = (step * ct + (lanes - shift) % ct).expand(batch, -1)
        if true_num_items is not None:
            scores = torch.where(positions < true_num_items, scores, NEG_INF)
        dropped = _feed_slot(vals, pos, dropped, scores, positions, first)
    dmax = dropped.amax(dim=1) if track_discards else None
    return torch.cat(vals, dim=1), torch.cat(pos, dim=1), dmax, first[0]


def lane_max_scan_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    *,
    corpus_tile: int,
    slots: int = 1,
    track_discards: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the lane-max scan kernel.

    Tile loop with an f32 matmul of the bf16/int8/f32 inputs, `torch.roll`
    for the lane shuffle, padding to -inf, and the strict-`>` slot
    contest in ascending tile order (`_lane_scan_tiles` over every tile).
    Returns (vals (B, slots*ct) f32, pos (B, slots*ct) i32, dmax (B,) f32
    or None); empty slots are (-inf, 0).
    """
    return _lane_scan_tiles(
        queries,
        corpus,
        scales,
        0,
        corpus.shape[0] // corpus_tile,
        corpus_tile=corpus_tile,
        slots=slots,
        track_discards=track_discards,
        true_num_items=true_num_items,
        lane_shuffle=lane_shuffle,
    )[:3]


def _feed_slot(
    best_v: list[torch.Tensor],
    best_p: list[torch.Tensor],
    dropped: torch.Tensor,
    v: torch.Tensor,
    p: torch.Tensor,
    first: list[torch.Tensor] | None = None,
) -> torch.Tensor:
    """One (value, position) per (row, lane) enters the slots `best_v`,
    `best_p` (updated in place) under the strict `>`, the value displaced
    from slot 1 going on to slot 2; returns `dropped` raised by what fell
    out. `first[0]`, with two slots, follows the position of the first
    item that held slot 2's value: slot 1's when an item tied with slot 1
    takes slot 2, else the item that takes it."""
    beats1 = v > best_v[0]
    contender = torch.where(beats1, best_v[0], v)
    contender_pos = torch.where(beats1, best_p[0], p)
    at_least1 = v >= best_v[0]
    old_p1 = best_p[0]
    best_v[0] = torch.where(beats1, v, best_v[0])
    best_p[0] = torch.where(beats1, p, best_p[0])
    discarded = contender
    if len(best_v) == 2:
        beats2 = contender > best_v[1]
        discarded = torch.where(beats2, best_v[1], contender)
        best_v[1] = torch.where(beats2, contender, best_v[1])
        best_p[1] = torch.where(beats2, contender_pos, best_p[1])
        if first is not None:
            first[0] = torch.where(
                beats2, torch.where(at_least1, old_p1, p), first[0]
            )
    return torch.maximum(dropped, discarded)


def merge_lane_slots_plain(
    vals: Sequence[torch.Tensor],
    pos: Sequence[torch.Tensor],
    first: Sequence[torch.Tensor],
    dmax: Sequence[torch.Tensor | None],
    *,
    slots: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain version of the kernel's tile-ordered merge of a corpus split
    over blocks.

    `vals[s]`, `pos[s]` (B, slots*ct), `first[s]` (B, ct) and `dmax[s]`
    (B,) are what `_lane_scan_tiles` returns for the s-th range of tiles,
    the ranges in ascending order. The strict-`>` contest keeps ties by
    history: slot 2 holds the second item of its value when two of them
    came before slot 1's, else the first. So each part's slots alone do
    not decide ties across parts; with the first item of slot 2's value
    they do. Each part feeds, in ascending position, that first item
    (where slot 2 holds a later one of a value below slot 1's), then its
    slots, into the same contest; this gives the unsplit slots, ties
    included. The row's discard-max is the largest partial discard-max or
    value that this merge drops."""
    ct = vals[0].shape[1] // slots
    best_v = [torch.full_like(vals[0][:, :ct], NEG_INF) for _ in range(slots)]
    best_p = [torch.zeros_like(pos[0][:, :ct]) for _ in range(slots)]
    dropped = torch.full_like(best_v[0], NEG_INF)
    for part_v, part_p, part_f in zip(vals, pos, first, strict=True):
        v1, p1 = part_v[:, :ct], part_p[:, :ct]
        if slots == 1:
            dropped = _feed_slot(best_v, best_p, dropped, v1, p1)
            continue
        v2, p2 = part_v[:, ct:], part_p[:, ct:]
        earlier = (v2 < v1) & (part_f != p2)
        dropped = _feed_slot(
            best_v, best_p, dropped, torch.where(earlier, v2, NEG_INF), part_f
        )
        swap = p2 < p1
        dropped = _feed_slot(
            best_v, best_p, dropped, torch.where(swap, v2, v1),
            torch.where(swap, p2, p1),
        )
        dropped = _feed_slot(
            best_v, best_p, dropped, torch.where(swap, v1, v2),
            torch.where(swap, p1, p2),
        )
    merged_v, merged_p = torch.cat(best_v, dim=1), torch.cat(best_p, dim=1)
    if dmax[0] is None:
        return merged_v, merged_p, None
    return merged_v, merged_p, torch.maximum(
        torch.stack(list(dmax)).amax(dim=0), dropped.amax(dim=1)
    )


def lane_max_scan_split_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    splits: int,
    *,
    corpus_tile: int,
    slots: int = 1,
    **geometry,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain version of the lane-max scan kernel with its corpus tiles
    split `splits` ways: the contest over each contiguous range of tiles
    (the kernel's own ranges), then `merge_lane_slots_plain`. Equal to
    `lane_max_scan_plain` bit for bit, whatever `splits`."""
    num_tiles = corpus.shape[0] // corpus_tile
    parts = [
        _lane_scan_tiles(
            queries, corpus, scales, num_tiles * s // splits,
            num_tiles * (s + 1) // splits, corpus_tile=corpus_tile,
            slots=slots, **geometry,
        )
        for s in range(splits)
    ]
    vals, pos, dmax, first = zip(*parts, strict=True)
    return merge_lane_slots_plain(vals, pos, first, dmax, slots=slots)


def lane_max_scan(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    *,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    slots: int = 1,
    track_discards: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """One sweep -> per-lane top-`slots` values and positions.

    Returns (values (B, slots*corpus_tile) f32, positions (B,
    slots*corpus_tile) i32) and, with `track_discards`, the per-row
    maximum score ever evicted from any lane's slots, (B, 1) f32: the
    single-sweep exactness certificate (see `certified_topk`).
    `true_num_items` masks the zero-padding rows of the corpus to -inf
    inside the sweep. `scales`: (N,) or (1, N) per-item f32 multipliers
    of an int8 corpus (score = scale_i * q . c_i). A CPU tensor runs the
    plain version, a CUDA tensor the kernel.
    """
    num_items = corpus.shape[0]
    corpus_tile = _scan_tiles(queries, corpus, batch_tile, corpus_tile)
    if slots not in (1, 2):
        msg = f"slots must be 1 or 2, got {slots}"
        raise ValueError(msg)
    if scales is not None:
        scales = scales.reshape(-1).float()
        if scales.shape[0] != num_items:
            msg = f"scales length {scales.shape[0]} != {num_items=}"
            raise ValueError(msg)
    if true_num_items is not None and true_num_items >= num_items:
        true_num_items = None
    scan = (
        lane_max_scan_plain
        if queries.device.type == "cpu"
        else kernels.lane_max_scan
    )
    vals, pos, dmax = scan(
        queries,
        corpus,
        scales,
        corpus_tile=corpus_tile,
        slots=slots,
        track_discards=track_discards,
        true_num_items=true_num_items,
        lane_shuffle=lane_shuffle,
    )
    if track_discards:
        return vals, pos, dmax[:, None]
    return vals, pos


def scan_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    slots: int = 1,
    true_num_items: int | None = None,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lane-max scan top-k (near-exact: a lane holding more than `slots`
    of a row's top-k loses the smallest)."""
    vals, pos = lane_max_scan(
        queries,
        corpus,
        batch_tile=batch_tile,
        corpus_tile=corpus_tile,
        slots=slots,
        true_num_items=true_num_items,
        scales=scales,
    )
    top_vals, top_lanes = topk_stable(vals, k)
    return top_vals, torch.gather(pos, 1, top_lanes)


def scan_topk_excluding(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    exclude_positions: torch.Tensor | None = None,
    true_num_items: int | None = None,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    slots: int = 2,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lane-max scan top-k with per-row exclusions and query padding.

    Exclusions are applied by slack: the scan retrieves k + E lanes,
    excluded positions are masked to -inf and the final top-k is taken,
    so E excluded items can never push a wanted item out. Corpus padding
    is masked inside the sweep (`true_num_items`): zero rows score 0,
    which outranks negative real scores.
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
    lanes = min(corpus_tile, corpus.shape[0])
    pool = slots * lanes
    # when N <= pool every item lands in some lane slot, so coverage is
    # exhaustive whatever the slack; otherwise an exclusion list wider
    # than the pool's headroom could exhaust the candidates and the tail
    # would fill with -inf rows whose positions ARE excluded items
    if slack and k + slack > pool and corpus.shape[0] > pool:
        msg = (
            f"exclusion width {slack} + {k=} exceeds the candidate pool "
            f"({slots} slots x {lanes} lanes = {pool}); raise "
            "corpus_tile/slots or use the dense method"
        )
        raise ValueError(msg)
    fetch = min(k + slack, pool)
    vals, pos = scan_topk(
        queries,
        corpus,
        fetch,
        batch_tile=batch_tile,
        corpus_tile=corpus_tile,
        slots=slots,
        true_num_items=true_num_items,
        scales=scales,
    )
    if exclude_positions is not None:
        hit = (pos[:, :, None] == exclude_positions[:, None, :]).any(dim=-1)
        vals = torch.where(hit, NEG_INF, vals)
    top_vals, sel = topk_stable(vals, k)
    top_pos = torch.gather(pos, 1, sel)
    return top_vals[:batch], top_pos[:batch]


def count_at_least_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    tau: torch.Tensor,
    *,
    corpus_tile: int,
    true_num_items: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the count kernel: per row, the number of
    corpus scores >= tau over a tile loop, padding masked. (B,) int32."""
    batch = queries.shape[0]
    ct = corpus_tile
    device = queries.device
    q32 = queries.float()
    lanes = torch.arange(ct, dtype=torch.int32, device=device)
    counts = torch.zeros(batch, dtype=torch.int32, device=device)
    for step in range(corpus.shape[0] // ct):
        tile = corpus[step * ct : (step + 1) * ct].float()
        hits = (q32 @ tile.T) >= tau[:, None]
        if true_num_items is not None:
            hits = hits & (step * ct + lanes < true_num_items)
        counts += hits.sum(dim=1, dtype=torch.int32)
    return counts


def count_at_least(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    tau: torch.Tensor,
    *,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    true_num_items: int | None = None,
) -> torch.Tensor:
    """Per-row count of corpus scores >= tau, one sweep. (B,) int32. A
    CPU tensor runs the plain version, a CUDA tensor the kernel."""
    corpus_tile = _scan_tiles(queries, corpus, batch_tile, corpus_tile)
    if true_num_items is not None and true_num_items >= corpus.shape[0]:
        true_num_items = None
    count = (
        count_at_least_plain
        if queries.device.type == "cpu"
        else kernels.count_at_least
    )
    return count(
        queries,
        corpus,
        tau.reshape(-1).float().contiguous(),
        corpus_tile=corpus_tile,
        true_num_items=true_num_items,
    )


def certified_topk_parts(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    slots: int = 2,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Discard-certified scan in raw parts for multi-pass merges:
    (top_vals (B, k), top_pos (B, k), dmax (B,)), dmax the largest score
    ever evicted from a lane. Passes with different `lane_shuffle` have
    decorrelated collisions; a merged pool certifies when the minimum of
    dmax over the passes is at most the merged k-th score (an item above
    it that is missing from the union was evicted in EVERY pass)."""
    with span("index.sweep"):
        vals, pos, dmax = lane_max_scan(
            queries,
            corpus,
            batch_tile=batch_tile,
            corpus_tile=corpus_tile,
            slots=slots,
            track_discards=True,
            true_num_items=true_num_items,
            lane_shuffle=lane_shuffle,
            scales=scales,
        )
        top_vals, top_lanes = topk_stable(vals, k)
        return top_vals, torch.gather(pos, 1, top_lanes), dmax[:, 0]


def certified_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    batch_tile: int = DEFAULT_BATCH_TILE,
    corpus_tile: int = DEFAULT_CORPUS_TILE,
    slots: int = 2,
    method: str = "discard",
    true_num_items: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lane-max scan top-k + per-row exactness certificate: (values,
    positions, exact (B,) bool). exact[b] means the row is provably the
    exact top-k by score multiset (items tied at the k-th score may swap
    identity).

    method="discard": one sweep. Every corpus element sits in a lane
    slot at the end or was evicted; if the largest evicted score is at
    most tau, the k-th score found, every element above tau is still in
    the buffers and the boundary fills with tau-valued elements, which
    are interchangeable. method="count": two sweeps; the second counts
    #{score >= tau} per row and certifies when it equals k. Kept for
    cross-validation.
    """
    if method == "count":
        top_vals, top_pos = scan_topk(
            queries,
            corpus,
            k,
            batch_tile=batch_tile,
            corpus_tile=corpus_tile,
            slots=slots,
            true_num_items=true_num_items,
        )
        counts = count_at_least(
            queries,
            corpus,
            top_vals[:, k - 1],
            batch_tile=batch_tile,
            corpus_tile=corpus_tile,
            true_num_items=true_num_items,
        )
        return top_vals, top_pos, counts == k
    if method != "discard":
        msg = f"unknown certification {method=}"
        raise ValueError(msg)
    top_vals, top_pos, dmax = certified_topk_parts(
        queries,
        corpus,
        k,
        batch_tile=batch_tile,
        corpus_tile=corpus_tile,
        slots=slots,
        true_num_items=true_num_items,
    )
    return top_vals, top_pos, dmax <= top_vals[:, k - 1]
