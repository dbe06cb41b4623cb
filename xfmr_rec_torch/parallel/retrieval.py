"""Corpus-sharded exact retrieval over the device mesh.

Port of `xfmr_rec_tpu/parallel/retrieval.py`. The item matrix is split
along items over the mesh's "model" axis: every shard scores its rows
against the queries with the port's own entry points (`sharded_topk` by
one f32 matmul; the certified paths through `ops/topk_f32.py`
`lane_max_scan`, kernel 3, and `ops/topk.py` `packed_certified_parts`,
kernels 1 and 2), takes its local top-k, and the (m, B, k) candidate sets
merge per data row (`mesh.gather_columns`), never the (B, N) score
matrix. Positions are global int32 (`shard * local_n + local position`).

The exactness certificate composes across shards: a row is exact when
the largest key (or score) any shard evicted is at most the merged k-th
(`mesh.pmax`). With `shard_queries` the batch splits over the "data"
axis too (each slot sweeps (B/d, N/m)); the data rows' results are
gathered to every process's lead device. Selections go through
`topk_stable`, so positions come out in the reference's order, ties
included. Where the reference skips a retry round on the device
(`lax.cond`), `sharded_packed_guaranteed_topk` decides on the host, as
the port's single-card `packed_guaranteed_topk` does.

On a mesh that spans processes, a process sweeps only its own slots; a
data row whose slots lie in several processes merges over that row's
process group, each of its processes taking the same merged pool (and so
the same retry decisions), and the rows are then gathered so that every
process returns the same answer.

A corpus given as one (N, D) tensor is split and placed on each call;
`place_rows` / `place_columns` place it once (the index does).
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable, Sequence

import torch

from xfmr_rec_torch.ops import topk as tk
from xfmr_rec_torch.ops.topk_f32 import lane_max_scan
from xfmr_rec_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_columns,
    gather_rows,
    pmax,
    split_rows,
)

NEG_INF = float("-inf")


class ShardedTensor:
    """A tensor split into m equal pieces along `axis` over the model
    axis: `shards[i][j]` is piece j on `mesh.devices[i, j]`, placed only
    where this process holds the slot (None elsewhere, as
    `jax.make_array_from_callback` places a process's shards). A device
    that appears twice holds one copy of a piece."""

    def __init__(self, value: torch.Tensor, mesh: Mesh, axis: int = 0) -> None:
        num_model = mesh.shape[MODEL_AXIS]
        pieces = torch.split(value, value.shape[axis] // num_model, dim=axis)
        placed: dict[tuple[torch.device, int], torch.Tensor] = {}
        self.shards = []
        for i in range(mesh.shape[DATA_AXIS]):
            row = []
            for j in range(num_model):
                device = mesh.devices[i, j]
                if not mesh.is_local(i, j):
                    row.append(None)
                    continue
                if (device, j) not in placed:
                    placed[(device, j)] = pieces[j].to(device).contiguous()
                row.append(placed[(device, j)])
            self.shards.append(row)
        self.shape = tuple(value.shape)
        self.axis = axis
        self.group = mesh.group

    def full(self, device: torch.device) -> torch.Tensor:
        """The whole tensor gathered onto `device` (in every process)."""
        gather = gather_rows if self.axis == 0 else gather_columns
        return gather(
            [p for p in self.shards[0] if p is not None], device, self.group
        )


def place_rows(corpus, mesh: Mesh) -> ShardedTensor:
    """An (N, D) corpus split along items over the model axis."""
    if isinstance(corpus, ShardedTensor):
        return corpus
    return ShardedTensor(torch.as_tensor(corpus), mesh, axis=0)


def place_columns(scales, mesh: Mesh) -> ShardedTensor | None:
    """(1, N) per-item int8 scales, split like the corpus rows."""
    if scales is None or isinstance(scales, ShardedTensor):
        return scales
    return ShardedTensor(torch.as_tensor(scales), mesh, axis=1)


def on_device(device: torch.device):
    """Make `device` current for a launch (kernels go to the current
    card's context)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _query_spec(mesh: Mesh, batch: int, shard_queries: bool | None) -> int:
    """How many ways the query batch splits: over the data axis when
    requested, else 1 (replicated; only data row 0 computes). `None` =
    auto, the reference's rule: split whenever the data axis is
    nontrivial and divides the batch and the mesh lies in one process
    (multi-process callers opt in)."""
    data_size = mesh.shape.get(DATA_AXIS, 1)
    if shard_queries is None:
        shard_queries = (
            data_size > 1 and batch % data_size == 0 and mesh.process_count == 1
        )
    if not shard_queries:
        return 1
    if batch % data_size:
        msg = (
            f"shard_queries: batch {batch} % mesh '{DATA_AXIS}' "
            f"({data_size}) != 0 — pad the batch or replicate queries"
        )
        raise ValueError(msg)
    return data_size


def _validate_shard_geometry(corpus_rows: int, num_model: int, k: int) -> int:
    """Shared guard: corpus divisibility + candidate-pool width.

    Returns local_n. The merged candidate pool is num_model *
    min(k, local_n) wide; a k beyond that cannot be selected."""
    if corpus_rows % num_model:
        msg = f"corpus rows {corpus_rows} % mesh '{MODEL_AXIS}' != 0"
        raise ValueError(msg)
    local_n = corpus_rows // num_model
    if k > num_model * min(k, local_n):
        msg = (
            f"k={k} exceeds the merged candidate pool "
            f"{num_model} shards x min(k, local_n={local_n}) = "
            f"{num_model * min(k, local_n)}; reduce k or use fewer shards"
        )
        raise ValueError(msg)
    return local_n


def _gather_merge(
    local_vals: Sequence[torch.Tensor],
    local_pos: Sequence[torch.Tensor],
    k: int,
    device: torch.device,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather the (B, local_k) shard candidates over the model axis onto
    `device` (over the row's process `group`) and take the global top-k:
    the shared merge epilogue."""
    all_vals = gather_columns(local_vals, device, group)
    all_pos = gather_columns(local_pos, device, group)
    top_vals, merge_arg = tk.topk_stable(all_vals, k)
    return top_vals, torch.gather(all_pos, 1, merge_arg)


def _per_data_row(
    mesh: Mesh,
    parts: int,
    outputs: int,
    fn: Callable[..., tuple[torch.Tensor, ...]],
    *row_inputs: torch.Tensor | None,
) -> tuple[torch.Tensor, ...]:
    """Run `fn(i, *chunks)` for each data row i that holds queries and a
    slot of this process (its chunk of every row input; None passes
    through), then gather the `outputs` outputs' rows onto the lead
    device of every process (each row from the process that holds its
    first slot)."""
    chunks = [
        [None] * parts if x is None else split_rows(x, parts) for x in row_inputs
    ]
    outs = {
        i: fn(i, *(c[i] for c in chunks))
        for i in range(parts)
        if mesh.holds_row(i)
    }
    mine = [out for i, out in outs.items() if mesh.owns_row(i)]
    return tuple(
        gather_rows([out[c] for out in mine], mesh.lead, mesh.group)
        for c in range(outputs)
    )


def _pad_local(corpus: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(corpus, (0, 0, 0, pad)) if pad else corpus


def _pad_scales(scales: torch.Tensor | None, pad: int) -> torch.Tensor | None:
    if scales is None or not pad:
        return scales
    return torch.nn.functional.pad(scales, (0, pad))


def sharded_topk(
    queries: torch.Tensor,
    corpus,
    k: int,
    mesh: Mesh,
    *,
    exclude_positions: torch.Tensor | None = None,
    true_num_items: int | None = None,
    scales=None,
    shard_queries: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an item-sharded corpus (dense scores per shard).

    Args:
        queries: (B, D).
        corpus: (N, D) tensor or a `ShardedTensor` from `place_rows`.
        k: top-k.
        exclude_positions: (B, E) global corpus positions to mask
            (padded with >= N).
        true_num_items: logical corpus size when trailing rows are
            shard-balancing padding; pad rows score -inf.
        scales: (1, N) per-item dequantization scales of an int8 corpus.
        shard_queries: split the batch over the data axis too (None =
            auto when the data axis is nontrivial and divides B).

    Returns:
        (scores (B, k) f32, positions (B, k) global int32) on the lead
        device.
    """
    num_model = mesh.shape[MODEL_AXIS]
    local_n = _validate_shard_geometry(corpus.shape[0], num_model, k)
    local_k = min(k, local_n)
    if true_num_items is not None and true_num_items >= corpus.shape[0]:
        true_num_items = None
    parts = _query_spec(mesh, queries.shape[0], shard_queries)
    corpus = place_rows(corpus, mesh)
    scales = place_columns(scales, mesh)

    def row(i, q, excl):
        vals, poss = [], []
        for j in range(num_model):
            if not mesh.is_local(i, j):
                continue
            device = mesh.devices[i, j]
            local = corpus.shards[i][j]
            q32 = q.to(device).float()
            if scales is not None:
                # int8 shard: dequantizing dense scoring (the single-card
                # index's int8 dense branch)
                scores = (q32 @ local.to(torch.bfloat16).float().T) * (
                    scales.shards[i][j][0][None, :].float()
                )
            else:
                scores = q32 @ local.float().T
            offset = j * local_n
            if true_num_items is not None:
                real = offset + torch.arange(local_n, device=device)
                scores = torch.where(real < true_num_items, scores, NEG_INF)
            if excl is not None:
                # position equality, as a scatter: entries outside this
                # shard aim at an extra column that is cut off
                local_excl = excl.to(device).long() - offset
                inside = (local_excl >= 0) & (local_excl < local_n)
                scores = torch.cat([scores, scores[:, :1]], dim=1)
                scores.scatter_(
                    1, torch.where(inside, local_excl, local_n), NEG_INF
                )
                scores = scores[:, :local_n]
            top, arg = tk.topk_stable(scores, local_k)
            vals.append(top)
            poss.append((arg + offset).to(torch.int32))
        return _gather_merge(vals, poss, k, mesh.row_lead(i), mesh.row_group(i))

    return _per_data_row(mesh, parts, 2, row, queries, exclude_positions)


def _tiles(
    batch: int,
    parts: int,
    dim: int,
    local_n: int,
    batch_tile: int | None,
    corpus_tile: int | None,
) -> tuple[int, int]:
    """(batch tile, corpus tile) of a shard's sweep, as the reference
    picks them for the per-device batch and the local corpus."""
    bt = batch_tile or min(tk.DEFAULT_BATCH_TILE, batch // parts)
    ct = corpus_tile or tk.pick_corpus_tile(local_n, dim)
    return bt, ct


def sharded_certified_topk(
    queries: torch.Tensor,
    corpus,
    k: int,
    mesh: Mesh,
    *,
    batch_tile: int | None = None,
    corpus_tile: int | None = None,
    true_num_items: int | None = None,
    shard_queries: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-certified f32 top-k over an item-sharded corpus.

    Each shard runs the lane-max scan (`lane_max_scan`, kernel 3; two
    slots, discard-max) over its rows, takes a local top-k, and the
    candidates merge on the data row's lead device. A row is provably
    the exact top-k (by score multiset) when the largest score any shard
    evicted is at most tau, the merged k-th value: an element >= tau on a
    shard is either in its lane buffers, and then in its local top-k or
    beaten by k local values that push tau up, or it was evicted, which
    that shard's discard-max records.

    `true_num_items`: pad candidates (shard-balancing zero rows) are
    masked out of the merged pool; a pad row's score can still enter a
    shard's discard-max, which only makes the certificate conservative.

    Returns (scores (B, k) f32, positions (B, k) int32, exact (B,) bool).
    """
    num_model = mesh.shape[MODEL_AXIS]
    local_n = _validate_shard_geometry(corpus.shape[0], num_model, k)
    batch = queries.shape[0]
    parts = _query_spec(mesh, batch, shard_queries)
    bt, ct = _tiles(batch, parts, corpus.shape[1], local_n, batch_tile, corpus_tile)
    local_k = min(k, local_n)
    if true_num_items is not None and true_num_items >= corpus.shape[0]:
        true_num_items = None
    corpus = place_rows(corpus, mesh)
    pad = -local_n % ct

    def row(i, q):
        vals, poss, dmaxes = [], [], []
        for j in range(num_model):
            if not mesh.is_local(i, j):
                continue
            device = mesh.devices[i, j]
            with on_device(device):
                v, p, d = lane_max_scan(
                    q.to(device),
                    _pad_local(corpus.shards[i][j], pad),
                    batch_tile=bt,
                    corpus_tile=ct,
                    slots=2,
                    track_discards=True,
                    true_num_items=local_n if pad else None,
                )
                top, arg = tk.topk_stable(v, local_k)
                pos = torch.gather(p, 1, arg) + j * local_n
                if true_num_items is not None:
                    top = torch.where(pos < true_num_items, top, NEG_INF)
            vals.append(top)
            poss.append(pos)
            dmaxes.append(d[:, 0])
        lead, group = mesh.row_lead(i), mesh.row_group(i)
        top_scores, top_pos = _gather_merge(vals, poss, k, lead, group)
        tau = top_scores[:, k - 1]
        # <=: score-multiset exactness, the single-card convention
        return top_scores, top_pos, pmax(dmaxes, lead, group) <= tau

    return _per_data_row(mesh, parts, 3, row, queries)


def _packed_geometry(local_n: int, ct: int) -> tuple[int, int, int]:
    """(ct rounded down to a multiple of 8, pad rows inside a shard,
    idx_bits of the shard's tiles). Lane-pair merges split the tile in
    half, so ct stays a multiple of 8; pad rows cover the remainder."""
    ct = max(8, (min(ct, local_n) // 8) * 8)
    pad = -local_n % ct
    num_tiles = (local_n + pad) // ct
    return ct, pad, max((num_tiles - 1).bit_length(), 1)


def _mask_pad_keys(
    keys: torch.Tensor, pos: torch.Tensor, true_num_items: int | None
) -> torch.Tensor:
    """Key 0 for shard-balancing pad candidates (pos >= true_num_items)."""
    if true_num_items is None:
        return keys
    return torch.where(pos < true_num_items, keys, 0)


def _bound_on(score_bound, device: torch.device):
    if torch.is_tensor(score_bound):
        return score_bound.to(device)
    return score_bound


def sharded_packed_certified_topk(
    queries: torch.Tensor,
    corpus,
    k: int,
    mesh: Mesh,
    *,
    score_bound: float | torch.Tensor = 1.0,
    batch_tile: int | None = None,
    corpus_tile: int | None = None,
    merge_levels: int = 0,
    true_num_items: int | None = None,
    scales=None,
    shard_queries: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed-key certified top-k over an item-sharded corpus.

    Each shard sweeps its rows into int32 keys (`packed_certified_parts`:
    kernel 1, and kernel 2 once the pool is at least 4x the capacity),
    takes a local top-k in key space, and the key/position candidates
    merge on the data row's lead device. Keys compare across shards
    because every shard packs with the same `score_bound` and tile
    geometry; the certificate composes as in `sharded_certified_topk`,
    with the max over shards of the discard-max keys against the merged
    k-th key. Exactness is in the packed (quantized) order.

    `score_bound` must bound |score| globally. Returns (scores (B, k) f32
    decoded at the key quantum, positions (B, k) int32, exact (B,) bool).
    """
    num_model = mesh.shape[MODEL_AXIS]
    local_n = _validate_shard_geometry(corpus.shape[0], num_model, k)
    batch = queries.shape[0]
    parts = _query_spec(mesh, batch, shard_queries)
    bt, ct = _tiles(batch, parts, corpus.shape[1], local_n, batch_tile, corpus_tile)
    ct, pad, idx_bits = _packed_geometry(local_n, ct)
    local_k = min(k, local_n)
    if true_num_items is not None and true_num_items >= corpus.shape[0]:
        true_num_items = None
    while merge_levels and 2 * (ct >> merge_levels) < local_k:
        merge_levels -= 1
    corpus = place_rows(corpus, mesh)
    scales = place_columns(scales, mesh)

    def row(i, q):
        keys, poss, dmaxes = [], [], []
        for j in range(num_model):
            if not mesh.is_local(i, j):
                continue
            device = mesh.devices[i, j]
            with on_device(device):
                lk, lp, ld = tk.packed_certified_parts(
                    q.to(device),
                    _pad_local(corpus.shards[i][j], pad),
                    local_k,
                    score_bound=_bound_on(score_bound, device),
                    batch_tile=bt,
                    corpus_tile=ct,
                    idx_bits=idx_bits,
                    merge_levels=merge_levels,
                    true_num_items=local_n if pad else None,
                    scales=None if scales is None else _pad_scales(
                        scales.shards[i][j], pad
                    ),
                )
                lp = lp + j * local_n
            keys.append(_mask_pad_keys(lk, lp, true_num_items))
            poss.append(lp)
            dmaxes.append(ld)
        lead, group = mesh.row_lead(i), mesh.row_group(i)
        top_keys, top_pos = _gather_merge(keys, poss, k, lead, group)
        tau = top_keys[:, k - 1]
        exact = (pmax(dmaxes, lead, group) <= tau) & (
            tau > (1 << merge_levels) - 1
        )
        scores = tk.decode_scores(
            top_keys,
            idx_bits=idx_bits,
            score_bound=_bound_on(score_bound, lead),
            reserve_bits=merge_levels,
        )
        return scores, top_pos, exact

    return _per_data_row(mesh, parts, 3, row, queries)


def _guaranteed_retry_widths(
    local_batch: int,
    bt: int,
    retries: int,
    merge_levels: int,
    merge_keep: int,
    retry_width: int | Sequence[int] | None,
) -> list[int]:
    """Per-round retry widths, relative to the per-device batch, each
    rounded to a clean tiling (a multiple of 8 up to the batch tile, of
    the batch tile above)."""
    if retry_width is None:
        if merge_levels and merge_keep == 2:
            first, later = local_batch // 4, local_batch // 16
        else:
            first, later = local_batch // 16, local_batch // 64
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
    adjusted = []
    for w in widths[:retries]:
        w = min(w + (-w % 8), local_batch)
        if w > bt:
            w = min(w + (-w % bt), local_batch)
        adjusted.append(w or local_batch)
    return adjusted


def sharded_packed_guaranteed_topk(
    queries: torch.Tensor,
    corpus,
    k: int,
    mesh: Mesh,
    *,
    score_bound: float | torch.Tensor = 1.0,
    true_num_items: int | None = None,
    batch_tile: int | None = None,
    corpus_tile: int | None = None,
    merge_levels: int = 1,
    merge_keep: int = 3,
    retry_width: int | Sequence[int] | None = None,
    retries: int = 2,
    scales=None,
    shard_queries: bool | None = None,
    selector: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Guaranteed-exact top-k over an item-sharded corpus.

    Pass 1 sweeps every shard with the keep-3 packed scan and merges the
    candidates in key space; the rows whose composed certificate fails
    are gathered into a fixed-width slot batch (the first `width` failing
    rows, padded with row 0) and swept again on every shard with lane
    shuffles 1, 3, ...; the pools merge position-deduped and the
    certificate min-composes across passes: an element above the final
    tau was evicted in every pass on some shard, so min over passes of
    (max over shards of dmax) <= tau certifies the union's top-k. A round
    is skipped once every row certifies (a host decision here).

    Returns (scores (B, k) quantum-floor decodes, positions (B, k)
    int32, exact (B,) bool). Callers re-run `~exact` rows on
    `sharded_topk`. `selector` is `packed_certified_parts`' ("fused"
    takes kernel 5).
    """
    num_model = mesh.shape[MODEL_AXIS]
    local_n = _validate_shard_geometry(corpus.shape[0], num_model, k)
    batch = queries.shape[0]
    parts = _query_spec(mesh, batch, shard_queries)
    local_batch = batch // parts
    bt, ct = _tiles(batch, parts, corpus.shape[1], local_n, batch_tile, corpus_tile)
    ct, pad, idx_bits = _packed_geometry(local_n, ct)
    local_k = min(k, local_n)
    if true_num_items is not None and true_num_items >= corpus.shape[0]:
        true_num_items = None
    merge_levels = tk._clamp_merge_levels(ct, local_k, merge_levels, merge_keep)
    min_real = (1 << merge_levels) - 1
    widths = _guaranteed_retry_widths(
        local_batch, bt, retries, merge_levels, merge_keep, retry_width
    )
    corpus = place_rows(corpus, mesh)
    scales = place_columns(scales, mesh)

    def row(i, q):
        lead, group = mesh.row_lead(i), mesh.row_group(i)

        def sweep(qrows, shuffle, tile):
            """Every shard's sweep, merged: (pool keys, pool positions,
            max over shards of dmax), on the lead device."""
            keys, poss, dmaxes = [], [], []
            for j in range(num_model):
                if not mesh.is_local(i, j):
                    continue
                device = mesh.devices[i, j]
                with on_device(device):
                    lk, lp, ld = tk.packed_certified_parts(
                        qrows.to(device),
                        _pad_local(corpus.shards[i][j], pad),
                        local_k,
                        score_bound=_bound_on(score_bound, device),
                        batch_tile=tile,
                        corpus_tile=ct,
                        idx_bits=idx_bits,
                        merge_levels=merge_levels,
                        merge_keep=merge_keep,
                        true_num_items=local_n if pad else None,
                        lane_shuffle=shuffle,
                        scales=None if scales is None else _pad_scales(
                            scales.shards[i][j], pad
                        ),
                        selector=selector,
                    )
                    lp = lp + j * local_n
                keys.append(_mask_pad_keys(lk, lp, true_num_items))
                poss.append(lp)
                dmaxes.append(ld)
            return (
                gather_columns(keys, lead, group),
                gather_columns(poss, lead, group),
                pmax(dmaxes, lead, group),
            )

        q = q.to(lead)
        pool_k, pool_p, gdmax = sweep(q, 0, bt)
        keys, sel = tk.topk_stable(pool_k, k)
        positions = torch.gather(pool_p, 1, sel)
        tau = keys[:, k - 1]
        exact = (gdmax <= tau) & (tau > min_real)
        for attempt in range(retries):
            # the reference skips the round on the device (lax.cond);
            # eager PyTorch decides here, one sync a round (every process
            # of the row decides alike: they hold one merged pool)
            failing = torch.nonzero(~exact).flatten()
            if failing.numel() == 0:
                break
            width = widths[attempt]
            bad_idx = torch.zeros(width, dtype=torch.int64, device=lead)
            take = min(width, failing.numel())
            bad_idx[:take] = failing[:take]
            need = ~exact[bad_idx]
            new_k, new_p, gd2 = sweep(q[bad_idx], 2 * attempt + 1, min(bt, width))
            pool_keys = torch.cat([keys[bad_idx], new_k], dim=-1)
            pool_pos = torch.cat([positions[bad_idx], new_p], dim=-1)
            pool_keys = tk._dedupe_pool_keys(pool_keys, pool_pos)
            merged_keys, msel = tk.topk_stable(pool_keys, k)
            merged_pos = torch.gather(pool_pos, 1, msel)
            merged_dmax = torch.minimum(gdmax[bad_idx], gd2)
            merged_tau = merged_keys[:, k - 1]
            merged_exact = (merged_dmax <= merged_tau) & (merged_tau > min_real)
            keys = keys.index_put(
                (bad_idx,), torch.where(need[:, None], merged_keys, keys[bad_idx])
            )
            positions = positions.index_put(
                (bad_idx,),
                torch.where(need[:, None], merged_pos, positions[bad_idx]),
            )
            gdmax = gdmax.index_put(
                (bad_idx,), torch.where(need, merged_dmax, gdmax[bad_idx])
            )
            exact = exact.index_put(
                (bad_idx,), torch.where(need, merged_exact, exact[bad_idx])
            )
        scores = tk.decode_scores(
            keys,
            idx_bits=idx_bits,
            score_bound=_bound_on(score_bound, lead),
            reserve_bits=merge_levels,
        )
        return scores, positions, exact

    return _per_data_row(mesh, parts, 3, row, queries)


def sharded_packed_topk_excluding(
    queries: torch.Tensor,
    corpus,
    k: int,
    mesh: Mesh,
    *,
    exclude_positions: torch.Tensor | None = None,
    score_bound: float | torch.Tensor = 1.0,
    true_num_items: int | None = None,
    batch_tile: int | None = None,
    corpus_tile: int | None = None,
    merge_levels: int = 1,
    merge_keep: int = 2,
    selector: str = "topk",
    scales=None,
    shard_queries: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-key top-k with per-row exclusions over an item-sharded
    corpus (the sharded `search`).

    Each shard sweeps its rows with the packed scan (kernel 1, no
    certificate bookkeeping) and fetches its local top-(k+E) in key
    space; the candidates gather on the data row's lead device and the
    exclusions are masked after the merge by global position. Within one
    shard at most E excluded items outrank a wanted one, so fetching k+E
    a shard keeps every global top-k survivor in the pool.

    `exclude_positions` is (B, E) global positions (padded with >= N).
    Returns (scores (B, k) f32 quantum-floor decodes, positions (B, k)
    int32); masked or exhausted entries score -inf.
    """
    num_model = mesh.shape[MODEL_AXIS]
    local_n = _validate_shard_geometry(corpus.shape[0], num_model, k)
    batch = queries.shape[0]
    parts = _query_spec(mesh, batch, shard_queries)
    bt, ct = _tiles(batch, parts, corpus.shape[1], local_n, batch_tile, corpus_tile)
    ct, pad, idx_bits = _packed_geometry(local_n, ct)
    if true_num_items is not None and true_num_items >= corpus.shape[0]:
        true_num_items = None
    slack = 0 if exclude_positions is None else exclude_positions.shape[1]
    # clamp the merge so the per-shard pool still holds k+E candidates
    # (the single-card packed_topk_excluding's policy)
    fetch_target = min(k + slack, local_n)
    merge_levels = tk._clamp_merge_levels(ct, fetch_target, merge_levels, merge_keep)
    pool = tk._pool_width(ct, merge_levels, merge_keep)
    if fetch_target > pool and local_n + pad > pool:
        msg = (
            f"exclusion width {slack} + {k=} exceeds the per-shard packed "
            f"candidate pool ({pool}); raise corpus_tile or use "
            "sharded_topk (dense)"
        )
        raise ValueError(msg)
    fetch = min(fetch_target, pool)
    corpus = place_rows(corpus, mesh)
    scales = place_columns(scales, mesh)

    def row(i, q, excl):
        keys, poss = [], []
        for j in range(num_model):
            if not mesh.is_local(i, j):
                continue
            device = mesh.devices[i, j]
            with on_device(device):
                lk, lp, _ = tk.packed_certified_parts(
                    q.to(device),
                    _pad_local(corpus.shards[i][j], pad),
                    fetch,
                    score_bound=_bound_on(score_bound, device),
                    batch_tile=bt,
                    corpus_tile=ct,
                    idx_bits=idx_bits,
                    merge_levels=merge_levels,
                    merge_keep=merge_keep,
                    selector=selector,
                    true_num_items=local_n if pad else None,
                    scales=None if scales is None else _pad_scales(
                        scales.shards[i][j], pad
                    ),
                    track_discards=False,
                )
                lp = lp + j * local_n
            keys.append(_mask_pad_keys(lk, lp, true_num_items))
            poss.append(lp)
        lead, group = mesh.row_lead(i), mesh.row_group(i)
        # the whole merged pool: exclusions mask before the final top-k
        all_keys = gather_columns(keys, lead, group)
        all_pos = gather_columns(poss, lead, group)
        if excl is not None:
            hit = (all_pos[:, :, None] == excl.to(lead)[:, None, :]).any(dim=-1)
            all_keys = torch.where(hit, 0, all_keys)
        top_keys, sel = tk.topk_stable(all_keys, k)
        top_pos = torch.gather(all_pos, 1, sel)
        # masked/exhausted keys are 0; stamped padding keys reach
        # (1 << merge_levels) - 1: both below any real key
        real = top_keys > (1 << merge_levels) - 1
        scores = tk.decode_scores(
            top_keys,
            idx_bits=idx_bits,
            score_bound=_bound_on(score_bound, lead),
            reserve_bits=merge_levels,
        )
        return torch.where(real, scores, NEG_INF), top_pos

    return _per_data_row(mesh, parts, 2, row, queries, exclude_positions)
