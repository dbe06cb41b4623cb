"""Build, bind and launch the hand-written Hopper kernels.

Sources live in `xfmr_rec_torch/csrc/*.cu`, with the device code they
share in `*.cuh` beside them. At first use each source is compiled by its
own `nvcc` (all started together) for `sm_90a`, and the objects are
linked into one shared library with a plain C interface, loaded with
ctypes. The library lands in `build/kernels/` at the root of the
checkout, named by a hash of the sources, headers and flags, so a changed
file rebuilds and an unchanged tree loads straight away.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`/`torch.zeros`, launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to its
launch count. A wrapper never runs on the CPU: the callers in
`ops/topk.py` and `ops/topk_f32.py` send CPU tensors to the plain
versions themselves.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = (
    "packed_scan.cu",
    "threshold_select.cu",
    "lane_max_scan.cu",
    "count_at_least.cu",
    "packed_scan_select.cu",
)
HEADERS = (
    "scan_common.cuh",
    "mma_sweep.cuh",
    "packed_sweep.cuh",
    "select_common.cuh",
)
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
)

# launches per kernel since the last reset (read by chip_smoke.py to show
# that a path went through the kernels)
LAUNCHES = {
    "packed_scan": 0,
    "threshold_select": 0,
    "lane_max_scan": 0,
    "count_at_least": 0,
    "packed_scan_select": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_log = ""

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    msg = "nvcc not found (PATH, CUDA_HOME/bin or /usr/local/cuda/bin)"
    raise RuntimeError(msg)


def _remove(paths: list[pathlib.Path]) -> None:
    for path in paths:
        path.unlink(missing_ok=True)


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernel sources (if needed) and return the library path.

    One `nvcc -c` per source runs in parallel, then one link. The objects
    and the library are written under names that hold this process's id
    and renamed into place, so processes that build at the same moment
    (trial workers) never write one file, a reader never sees a
    half-written library, and no process leaves its own objects behind.
    """
    global last_build_log
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC_DIR / name).read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libxfmr_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    pid = os.getpid()
    procs = []
    objects = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{pathlib.Path(name).stem}_{tag}_{pid}.o"
        objects.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC_DIR / name),
               "-o", str(obj)]
        procs.append(
            (name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        )
    logs = []
    failed = []
    for name, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode:
            failed.append(name)
    last_build_log = "\n".join(logs)
    if failed:
        _remove(objects)
        msg = f"nvcc failed for {failed}:\n{last_build_log}"
        raise RuntimeError(msg)
    tmp = lib_path.with_suffix(f".tmp{pid}")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objects), "-o", str(tmp)],
        capture_output=True, text=True, check=False,
    )
    if link.returncode:
        _remove([*objects, tmp])
        msg = f"nvcc link failed:\n{link.stdout}\n{link.stderr}"
        raise RuntimeError(msg)
    tmp.replace(lib_path)
    # one set of objects a build tag stays beside the library (its SASS
    # is read by the tests); a racing build renames identical bytes
    for name, obj in zip(SOURCES, objects, strict=True):
        obj.replace(BUILD_DIR / f"{pathlib.Path(name).stem}_{tag}.o")
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.xfmr_packed_scan.argtypes = [
                _VOID, _VOID, _VOID, _VOID, _VOID,  # q, corpus, scales, keys, dmax
                _VOID, _VOID,  # work, arrivals
                _INT, _INT, _INT, _INT,  # batch, dim, num_tiles, corpus_tile
                _INT, _INT, _INT, _INT,  # true_n, shuffle, low_mask, reserve
                _INT, _INT, _INT,  # add_bias, track_discards, splits
                _INT, _INT,  # q_kind, corpus_kind
                _VOID,  # stream
            ]
            lib.xfmr_packed_scan.restype = _INT
            lib.xfmr_packed_scan_shape.argtypes = [
                _INT, _INT, _INT, _INT,  # aligned, dim, q_kind, corpus_kind
                _VOID,  # shape
            ]
            lib.xfmr_packed_scan_shape.restype = _INT
            lib.xfmr_threshold_select.argtypes = [
                _VOID, _VOID, _VOID,  # pool, keys, meta
                _INT, _INT, _INT, _INT,  # batch, width, k, capacity
                _INT, _INT,  # quantum_bits, shared_exponent
                _INT, _INT,  # block_warps, blocks
                _VOID,  # stream
            ]
            lib.xfmr_threshold_select.restype = _INT
            lib.xfmr_threshold_select_shape.argtypes = [_INT, _VOID]
            lib.xfmr_threshold_select_shape.restype = _INT
            lib.xfmr_lane_max_scan.argtypes = [
                _VOID, _VOID, _VOID,  # q, corpus, scales
                _VOID, _VOID, _VOID,  # vals, pos, dmax
                _VOID, _VOID, _VOID,  # work_vals, work_tiles, arrivals
                _INT, _INT, _INT, _INT,  # batch, dim, num_tiles, corpus_tile
                _INT, _INT, _INT, _INT,  # slots, true_n, shuffle, discards
                _INT,  # splits
                _INT, _INT,  # q_kind, corpus_kind
                _VOID,  # stream
            ]
            lib.xfmr_lane_max_scan.restype = _INT
            lib.xfmr_lane_max_scan_shape.argtypes = [
                _INT, _INT, _INT,  # aligned, dim, slots
                _INT, _INT,  # q_kind, corpus_kind
                _VOID,  # shape
            ]
            lib.xfmr_lane_max_scan_shape.restype = _INT
            lib.xfmr_count_at_least.argtypes = [
                _VOID, _VOID, _VOID, _VOID,  # q, corpus, tau, counts
                _INT, _INT, _INT, _INT,  # batch, dim, num_tiles, corpus_tile
                _INT, _INT,  # true_n, splits
                _INT, _INT,  # q_kind, corpus_kind
                _VOID,  # stream
            ]
            lib.xfmr_count_at_least.restype = _INT
            lib.xfmr_count_at_least_shape.argtypes = [
                _INT, _INT, _INT, _INT,  # aligned, dim, q_kind, corpus_kind
                _VOID,  # shape
            ]
            lib.xfmr_count_at_least_shape.restype = _INT
            lib.xfmr_packed_scan_select.argtypes = [
                _VOID, _VOID, _VOID,  # q, corpus, scales
                _VOID, _VOID,  # work, arrivals
                _VOID, _VOID, _VOID,  # keys, meta, dmax
                _INT, _INT, _INT, _INT,  # batch, dim, num_tiles, corpus_tile
                _INT, _INT, _INT, _INT,  # true_n, shuffle, low_mask, reserve
                _INT,  # add_bias
                _INT, _INT, _INT,  # k, capacity, quantum_bits
                _INT, _INT, _INT,  # merge_levels, keep3, pool_width
                _INT,  # splits
                _INT, _INT,  # q_kind, corpus_kind
                _VOID,  # stream
            ]
            lib.xfmr_packed_scan_select.restype = _INT
            lib.xfmr_packed_scan_select_shape.argtypes = [
                _INT, _INT, _INT, _INT,  # aligned, dim, corpus_tile, capacity
                _INT, _INT, _INT,  # merge_levels, keep3, pool_width
                _INT, _INT,  # q_kind, corpus_kind
                _VOID,  # shape
            ]
            lib.xfmr_packed_scan_select_shape.restype = _INT
            _lib = lib
    return _lib


_Q_KINDS = {torch.bfloat16: 0, torch.float32: 1}
_CORPUS_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
# (query dtype, corpus dtype) pairs the scan kernel is instantiated for
_SCAN_PAIRS = {
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.int8),
    (torch.float32, torch.float32),
}
MAX_SCAN_DIM = 256


def _check_cuda(name: str, tensor: torch.Tensor) -> None:
    if not tensor.is_cuda:
        msg = f"{name} must be a CUDA tensor, got {tensor.device}"
        raise ValueError(msg)
    if not tensor.is_contiguous():
        msg = f"{name} must be contiguous"
        raise ValueError(msg)


def _raise_on(err: int, kernel: str) -> None:
    if err:
        msg = f"{kernel} launch failed with CUDA error {err}"
        raise RuntimeError(msg)


def _check_scan(
    kernel: str,
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    corpus_tile: int,
    pairs: set = _SCAN_PAIRS,
) -> tuple[int, int, int]:
    """Argument checks shared by the scan kernels; returns (batch, dim,
    num_tiles)."""
    _check_cuda("queries", queries)
    _check_cuda("corpus", corpus)
    pair = (queries.dtype, corpus.dtype)
    if pair not in pairs:
        msg = f"{kernel} takes (query, corpus) dtypes {pairs}, got {pair}"
        raise ValueError(msg)
    batch, dim = queries.shape
    num_items = corpus.shape[0]
    if corpus.shape[1] != dim:
        msg = f"query dim {dim} != corpus dim {corpus.shape[1]}"
        raise ValueError(msg)
    if not 0 < dim <= MAX_SCAN_DIM:
        msg = f"{kernel} supports dim <= {MAX_SCAN_DIM}, got {dim}"
        raise ValueError(msg)
    if corpus_tile <= 0 or num_items % corpus_tile:
        msg = f"{num_items=} must be a multiple of {corpus_tile=}"
        raise ValueError(msg)
    if scales is not None:
        _check_cuda("scales", scales)
        if scales.dtype != torch.float32 or scales.numel() != num_items:
            msg = "scales must be float32 with one entry per corpus row"
            raise ValueError(msg)
    if queries.device != corpus.device:
        msg = "queries and corpus must be on the same device"
        raise ValueError(msg)
    return batch, dim, num_items // corpus_tile


def sweep_splits(
    batch: int,
    num_tiles: int,
    lane_chunks: int,
    sm_count: int,
    block_rows: int = 64,
    blocks_per_sm: int = 4,
) -> int:
    """How many contiguous ranges the corpus tiles are split into, each
    swept by blocks of its own (the third grid dimension).

    Row tiles x lane chunks blocks fill the card at a large batch, and
    the answer is 1. At a small batch the tiles are split so that the
    blocks fill the SMs once, all resident together (`blocks_per_sm` at a
    time on each), and never more ways than there are tiles. The defaults
    are the shape of the bf16 sweep at D=64; the wrappers ask the library
    for the shape of the launch at hand.
    """
    blocks = max(1, -(-batch // block_rows) * lane_chunks)
    return max(1, min(num_tiles, blocks_per_sm * sm_count // blocks))


class _SweepPlan(NamedTuple):
    splits: int
    row_tiles: int
    lane_chunks: int


@functools.lru_cache(maxsize=None)
def _block_shape(
    shape_fn: str, device: int, *args: int
) -> tuple[int, int, int, int]:
    """(rows of a block, lanes of a block, blocks an SM holds at a time,
    SMs) of one sweep kernel on one card, from the kernel's shape query
    in the library: fixed for given arguments, so asked once."""
    shape = (_INT * 3)()
    with torch.cuda.device(device):
        err = getattr(load(), shape_fn)(*args, shape)
    _raise_on(err, shape_fn)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return (*shape, sm_count)


def _plan_sweep(
    shape_fn: str,
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_tile: int,
    splits: int | None,
    *select: int,
) -> _SweepPlan:
    """The grid of one launch of a sweep kernel: the block shape for these
    operands (`select` holds the kernel's further arguments: the fused
    kernel's geometry, the lane scan's slots), and the caller's splits or
    `sweep_splits` for this card."""
    batch, dim = queries.shape
    num_tiles = corpus.shape[0] // corpus_tile
    block_rows, block_lanes, blocks_per_sm, sm_count = _block_shape(
        shape_fn,
        corpus.device.index,
        int(corpus.data_ptr() % 16 == 0),
        dim,
        *select,
        _Q_KINDS[queries.dtype],
        _CORPUS_KINDS[corpus.dtype],
    )
    row_tiles = -(-batch // block_rows)
    lane_chunks = -(-corpus_tile // block_lanes)
    if splits is None:
        splits = sweep_splits(
            batch, num_tiles, lane_chunks, sm_count, block_rows, blocks_per_sm
        )
    if not 1 <= splits <= num_tiles:
        msg = f"need 1 <= {splits=} <= {num_tiles=}"
        raise ValueError(msg)
    return _SweepPlan(splits, row_tiles, lane_chunks)


def packed_scan_splits(
    queries: torch.Tensor, corpus: torch.Tensor, *, corpus_tile: int, **_ignored
) -> int:
    """The corpus splits that `packed_scan` chooses for these operands on
    this card (its other arguments are accepted and ignored)."""
    _check_scan("packed_scan", queries, corpus, None, corpus_tile)
    return _plan_sweep(
        "xfmr_packed_scan_shape", queries, corpus, corpus_tile, None
    ).splits


def packed_scan(
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
    splits: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the packed scan kernel (same arguments and results as
    `ops.topk.packed_lane_scan_plain`). `splits` overrides how many ways
    the corpus tiles are split over blocks (default: `sweep_splits`); the
    result does not depend on it."""
    batch, dim, num_tiles = _check_scan(
        "packed_scan", queries, corpus, scales, corpus_tile
    )
    keys = torch.empty(
        (batch, 2 * corpus_tile), dtype=torch.int32, device=queries.device
    )
    dmax = torch.zeros(batch, dtype=torch.int32, device=queries.device)
    if batch == 0:
        return keys, dmax if track_discards else None
    lib = load()
    plan = _plan_sweep(
        "xfmr_packed_scan_shape", queries, corpus, corpus_tile, splits
    )
    work = arrivals = None
    if plan.splits > 1:
        # partial slots of every split, and one arrival counter per (row
        # tile, lane chunk)
        work = torch.empty(
            (plan.splits, batch, 2 * corpus_tile),
            dtype=torch.int32,
            device=queries.device,
        )
        arrivals = torch.zeros(
            plan.row_tiles * plan.lane_chunks,
            dtype=torch.int32,
            device=queries.device,
        )
    low_mask = (1 << (idx_bits + reserve_bits)) - 1
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = lib.xfmr_packed_scan(
        queries.data_ptr(),
        corpus.data_ptr(),
        None if scales is None else scales.data_ptr(),
        keys.data_ptr(),
        dmax.data_ptr(),
        None if work is None else work.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(),
        batch,
        dim,
        num_tiles,
        corpus_tile,
        -1 if true_num_items is None else int(true_num_items),
        int(lane_shuffle),
        low_mask,
        reserve_bits,
        0 if bias_in_dot else 1,
        1 if track_discards else 0,
        plan.splits,
        _Q_KINDS[queries.dtype],
        _CORPUS_KINDS[corpus.dtype],
        stream,
    )
    _raise_on(err, "packed_scan")
    LAUNCHES["packed_scan"] += 1
    return keys, dmax if track_discards else None


MAX_SELECT_WIDTH = 16384


def select_grid(
    batch: int, sm_count: int, block_warps: int, blocks_per_sm: int
) -> tuple[int, int]:
    """(warps of a block, blocks) of a threshold-select launch: a warp
    per row, persistent over rows when the batch outgrows the card.

    A block holds as many rows as spread the batch evenly over the SMs,
    at most `block_warps` (the block size at which an SM holds the most
    warps), so a 128-row retry runs one warp on each of 128 SMs. The
    grid is the blocks the batch needs, at most as many as the card
    holds at a time (`blocks_per_sm` blocks of `block_warps` warps an SM,
    from the occupancy API); each warp then takes every (all warps)-th
    row.
    """
    per_block = max(1, min(block_warps, -(-batch // sm_count)))
    resident = max(1, sm_count * block_warps * blocks_per_sm // per_block)
    return per_block, max(1, min(-(-batch // per_block), resident))


@functools.lru_cache(maxsize=None)
def _select_shape(device: int, width: int) -> tuple[int, int, int]:
    """(warps of a block at which an SM holds the most warps, such
    blocks an SM holds, SMs) of the threshold-select kernel for rows of
    `width` keys on one card."""
    shape = (_INT * 2)()
    with torch.cuda.device(device):
        err = load().xfmr_threshold_select_shape(width, shape)
    _raise_on(err, "xfmr_threshold_select_shape")
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return shape[0], shape[1], sm_count


def threshold_select_grid(pool: torch.Tensor) -> tuple[int, int]:
    """The (warps of a block, blocks) that `threshold_select` launches
    for this pool on this card."""
    block_warps, blocks_per_sm, sm_count = _select_shape(
        pool.device.index, pool.shape[1]
    )
    return select_grid(pool.shape[0], sm_count, block_warps, blocks_per_sm)


def threshold_select(
    pool: torch.Tensor,
    k: int,
    *,
    capacity: int,
    quantum_bits: int = 0,
    shared_exponent: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the threshold-select kernel (same arguments and results as
    `ops.topk.select_topk_keys_plain`)."""
    _check_cuda("pool", pool)
    if pool.dtype != torch.int32 or pool.dim() != 2:
        msg = f"pool must be a 2-D int32 tensor, got {pool.dtype} {tuple(pool.shape)}"
        raise ValueError(msg)
    batch, width = pool.shape
    if not 0 < width <= MAX_SELECT_WIDTH:
        msg = f"threshold_select supports widths up to {MAX_SELECT_WIDTH}, got {width}"
        raise ValueError(msg)
    if not 0 < k <= capacity <= width:
        msg = f"need 0 < {k=} <= {capacity=} <= {width=}"
        raise ValueError(msg)
    if not 0 <= quantum_bits <= 30:
        msg = f"need 0 <= {quantum_bits=} <= 30"
        raise ValueError(msg)
    keys = torch.empty((batch, capacity), dtype=torch.int32, device=pool.device)
    meta = torch.empty_like(keys)
    if batch == 0:
        return keys, meta
    lib = load()
    block_warps, blocks = threshold_select_grid(pool)
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = lib.xfmr_threshold_select(
        pool.data_ptr(),
        keys.data_ptr(),
        meta.data_ptr(),
        batch,
        width,
        k,
        capacity,
        quantum_bits,
        1 if shared_exponent else 0,
        block_warps,
        blocks,
        stream,
    )
    _raise_on(err, "threshold_select")
    LAUNCHES["threshold_select"] += 1
    return keys, meta


# the lane scan keeps a slot's tile index in 16 bits
MAX_LANE_SCAN_TILES = 1 << 16


def _check_lane_scan(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    corpus_tile: int,
    slots: int,
) -> tuple[int, int, int]:
    """Argument checks of the lane-max scan; returns (batch, dim,
    num_tiles)."""
    batch, dim, num_tiles = _check_scan(
        "lane_max_scan", queries, corpus, scales, corpus_tile
    )
    if slots not in (1, 2):
        msg = f"slots must be 1 or 2, got {slots}"
        raise ValueError(msg)
    if num_tiles > MAX_LANE_SCAN_TILES:
        msg = (
            f"lane_max_scan takes at most {MAX_LANE_SCAN_TILES} corpus "
            f"tiles, got {num_tiles}"
        )
        raise ValueError(msg)
    return batch, dim, num_tiles


def lane_max_scan_splits(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    *,
    corpus_tile: int,
    slots: int = 1,
    **_ignored,
) -> int:
    """The corpus splits that `lane_max_scan` chooses for these operands
    on this card (its other arguments are accepted and ignored)."""
    _check_lane_scan(queries, corpus, None, corpus_tile, slots)
    return _plan_sweep(
        "xfmr_lane_max_scan_shape", queries, corpus, corpus_tile, None, slots
    ).splits


def lane_max_scan(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    *,
    corpus_tile: int,
    slots: int = 1,
    track_discards: bool = False,
    true_num_items: int | None = None,
    lane_shuffle: int = 0,
    splits: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Launch the f32 lane-max scan kernel (same arguments and results as
    `ops.topk_f32.lane_max_scan_plain`). `splits` overrides how many ways
    the corpus tiles are split over blocks (default: `sweep_splits`); the
    result does not depend on it."""
    batch, dim, num_tiles = _check_lane_scan(
        queries, corpus, scales, corpus_tile, slots
    )
    device = queries.device
    width = slots * corpus_tile
    vals = torch.empty((batch, width), dtype=torch.float32, device=device)
    pos = torch.empty((batch, width), dtype=torch.int32, device=device)
    dmax = None
    if track_discards:
        # the kernel reduces into it with atomics
        dmax = torch.full(
            (batch,), float("-inf"), dtype=torch.float32, device=device
        )
    if batch == 0:
        return vals, pos, dmax
    lib = load()
    plan = _plan_sweep(
        "xfmr_lane_max_scan_shape", queries, corpus, corpus_tile, splits,
        slots,
    )
    work_vals = work_tiles = arrivals = None
    if plan.splits > 1:
        # the (value, tile) slots of every split, and one arrival counter
        # per (row tile, lane chunk)
        work_vals = torch.empty(
            (plan.splits, batch, width), dtype=torch.float32, device=device
        )
        work_tiles = torch.empty(
            (plan.splits, batch, width), dtype=torch.int32, device=device
        )
        arrivals = torch.zeros(
            plan.row_tiles * plan.lane_chunks, dtype=torch.int32,
            device=device,
        )
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.xfmr_lane_max_scan(
        queries.data_ptr(),
        corpus.data_ptr(),
        None if scales is None else scales.data_ptr(),
        vals.data_ptr(),
        pos.data_ptr(),
        None if dmax is None else dmax.data_ptr(),
        None if work_vals is None else work_vals.data_ptr(),
        None if work_tiles is None else work_tiles.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(),
        batch,
        dim,
        num_tiles,
        corpus_tile,
        slots,
        -1 if true_num_items is None else int(true_num_items),
        int(lane_shuffle),
        1 if track_discards else 0,
        plan.splits,
        _Q_KINDS[queries.dtype],
        _CORPUS_KINDS[corpus.dtype],
        stream,
    )
    _raise_on(err, "lane_max_scan")
    LAUNCHES["lane_max_scan"] += 1
    return vals, pos, dmax


# the count kernel takes no scales, so no int8 corpus
_COUNT_PAIRS = {
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32),
}


def count_at_least_splits(
    queries: torch.Tensor, corpus: torch.Tensor, *, corpus_tile: int,
    **_ignored,
) -> int:
    """The corpus splits that `count_at_least` chooses for these operands
    on this card (its other arguments are accepted and ignored)."""
    _check_scan(
        "count_at_least", queries, corpus, None, corpus_tile, _COUNT_PAIRS
    )
    return _plan_sweep(
        "xfmr_count_at_least_shape", queries, corpus, corpus_tile, None
    ).splits


def count_at_least(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    tau: torch.Tensor,
    *,
    corpus_tile: int,
    true_num_items: int | None = None,
    splits: int | None = None,
) -> torch.Tensor:
    """Launch the count kernel (same arguments and result as
    `ops.topk_f32.count_at_least_plain`). `splits` as in `lane_max_scan`:
    every split adds its counts with integer atomics, so the result does
    not depend on it."""
    batch, dim, num_tiles = _check_scan(
        "count_at_least", queries, corpus, None, corpus_tile, _COUNT_PAIRS
    )
    _check_cuda("tau", tau)
    if tau.dtype != torch.float32 or tau.shape != (batch,):
        msg = f"tau must be float32 of shape ({batch},), got {tau.dtype} {tuple(tau.shape)}"
        raise ValueError(msg)
    # the kernel adds into it with atomics
    counts = torch.zeros(batch, dtype=torch.int32, device=queries.device)
    if batch == 0:
        return counts
    lib = load()
    plan = _plan_sweep(
        "xfmr_count_at_least_shape", queries, corpus, corpus_tile, splits
    )
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = lib.xfmr_count_at_least(
        queries.data_ptr(),
        corpus.data_ptr(),
        tau.data_ptr(),
        counts.data_ptr(),
        batch,
        dim,
        num_tiles,
        corpus_tile,
        -1 if true_num_items is None else int(true_num_items),
        plan.splits,
        _Q_KINDS[queries.dtype],
        _CORPUS_KINDS[corpus.dtype],
        stream,
    )
    _raise_on(err, "count_at_least")
    LAUNCHES["count_at_least"] += 1
    return counts


def _check_scan_select(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    scales: torch.Tensor | None,
    k: int,
    corpus_tile: int,
    merge_levels: int,
    merge_keep: int,
    capacity: int,
) -> tuple[int, int, int, tuple[int, int, int, int, int]]:
    """Argument checks of the fused kernel; returns (batch, dim,
    num_tiles, select) with `select` = (corpus_tile, capacity,
    merge_levels, keep3, pool_width) as the library takes them."""
    batch, dim, num_tiles = _check_scan(
        "packed_scan_select", queries, corpus, scales, corpus_tile
    )
    if merge_keep not in (2, 3):
        msg = f"merge_keep must be 2 or 3, got {merge_keep}"
        raise ValueError(msg)
    keep3 = bool(merge_levels) and merge_keep == 3
    if keep3 and merge_levels != 1:
        msg = f"keep-3 merges one level, got {merge_levels=}"
        raise ValueError(msg)
    if corpus_tile % (1 << max(merge_levels, 1)):
        msg = f"{corpus_tile=} does not halve {merge_levels} times"
        raise ValueError(msg)
    pool_width = (
        3 * (corpus_tile >> 1) if keep3 else 2 * (corpus_tile >> merge_levels)
    )
    if not 0 < pool_width <= MAX_SELECT_WIDTH:
        msg = f"packed_scan_select supports pools up to {MAX_SELECT_WIDTH}, got {pool_width}"
        raise ValueError(msg)
    if not 0 < k <= capacity <= pool_width:
        msg = f"need 0 < {k=} <= {capacity=} <= {pool_width=}"
        raise ValueError(msg)
    select = (corpus_tile, capacity, merge_levels, int(keep3), pool_width)
    return batch, dim, num_tiles, select


def packed_scan_select_splits(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    corpus_tile: int,
    merge_levels: int = 0,
    merge_keep: int = 2,
    capacity: int = 128,
    **_ignored,
) -> int:
    """The corpus splits that `packed_scan_select` chooses for these
    operands on this card (its other arguments are accepted and
    ignored)."""
    *_, select = _check_scan_select(
        queries, corpus, None, k, corpus_tile, merge_levels, merge_keep,
        capacity,
    )
    return _plan_sweep(
        "xfmr_packed_scan_select_shape", queries, corpus, corpus_tile,
        None, *select,
    ).splits


def packed_scan_select(
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
    splits: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fused scan + merge + select kernel, once (same arguments
    and results as `ops.topk.packed_lane_scan_select_plain`):
    (keys (B, capacity), meta (B, capacity), dmax (B,)), all int32.
    `merge_levels` is taken as given (already clamped). `splits` as in
    `packed_scan`."""
    batch, dim, num_tiles, select = _check_scan_select(
        queries, corpus, scales, k, corpus_tile, merge_levels, merge_keep,
        capacity,
    )
    keep3, pool_width = select[3:]
    device = queries.device
    keys = torch.empty((batch, capacity), dtype=torch.int32, device=device)
    meta = torch.empty_like(keys)
    # the kernel reduces into dmax and counts arrivals with atomics
    dmax = torch.zeros(batch, dtype=torch.int32, device=device)
    if batch == 0:
        return keys, meta, dmax
    lib = load()
    plan = _plan_sweep(
        "xfmr_packed_scan_select_shape", queries, corpus, corpus_tile,
        splits, *select,
    )
    # every block parks its slots; one arrival counter per row tile and,
    # to merge the splits, one per (row tile, lane chunk)
    work = torch.empty(
        (plan.splits, batch, 2 * corpus_tile), dtype=torch.int32, device=device
    )
    arrivals = torch.zeros(
        plan.row_tiles * (1 + (plan.lane_chunks if plan.splits > 1 else 0)),
        dtype=torch.int32,
        device=device,
    )
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.xfmr_packed_scan_select(
        queries.data_ptr(),
        corpus.data_ptr(),
        None if scales is None else scales.data_ptr(),
        work.data_ptr(),
        arrivals.data_ptr(),
        keys.data_ptr(),
        meta.data_ptr(),
        dmax.data_ptr(),
        batch,
        dim,
        num_tiles,
        corpus_tile,
        -1 if true_num_items is None else int(true_num_items),
        int(lane_shuffle),
        (1 << (idx_bits + merge_levels)) - 1,
        merge_levels,
        0 if bias_in_dot else 1,
        k,
        capacity,
        idx_bits + merge_levels,
        merge_levels,
        keep3,
        pool_width,
        plan.splits,
        _Q_KINDS[queries.dtype],
        _CORPUS_KINDS[corpus.dtype],
        stream,
    )
    _raise_on(err, "packed_scan_select")
    LAUNCHES["packed_scan_select"] += 1
    return keys, meta, dmax
