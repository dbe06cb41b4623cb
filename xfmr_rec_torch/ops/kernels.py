"""Build, bind and launch the hand-written Hopper kernels.

Sources live in `xfmr_rec_torch/csrc/*.cu`. At first use each source is
compiled by its own `nvcc` (all started together) for `sm_90a`, and the
objects are linked into one shared library with a plain C interface,
loaded with ctypes. The library lands in `build/kernels/` at the root of
the checkout, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads straight away.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`/`torch.zeros`, launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to its
launch count. A wrapper never runs on the CPU: the callers in
`ops/topk.py` send CPU tensors to the plain versions themselves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("packed_scan.cu", "threshold_select.cu")
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
LAUNCHES = {"packed_scan": 0, "threshold_select": 0}

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


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernel sources (if needed) and return the library path.

    One `nvcc -c` per source runs in parallel, then one link. Output goes
    to a temporary name and is renamed into place, so a reader never sees
    a half-written library.
    """
    global last_build_log
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC_DIR / name).read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libxfmr_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    objects = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{pathlib.Path(name).stem}_{tag}.o"
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
        msg = f"nvcc failed for {failed}:\n{last_build_log}"
        raise RuntimeError(msg)
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objects), "-o", str(tmp)],
        capture_output=True, text=True, check=False,
    )
    if link.returncode:
        msg = f"nvcc link failed:\n{link.stdout}\n{link.stderr}"
        raise RuntimeError(msg)
    tmp.replace(lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.xfmr_packed_scan.argtypes = [
                _VOID, _VOID, _VOID, _VOID, _VOID,  # q, corpus, scales, keys, dmax
                _INT, _INT, _INT, _INT,  # batch, dim, num_tiles, corpus_tile
                _INT, _INT, _INT, _INT,  # true_n, shuffle, low_mask, reserve
                _INT, _INT,  # add_bias, track_discards
                _INT, _INT,  # q_kind, corpus_kind
                _VOID,  # stream
            ]
            lib.xfmr_packed_scan.restype = _INT
            lib.xfmr_threshold_select.argtypes = [
                _VOID, _VOID, _VOID,  # pool, keys, meta
                _INT, _INT, _INT, _INT,  # batch, width, k, capacity
                _INT, _INT,  # quantum_bits, shared_exponent
                _VOID,  # stream
            ]
            lib.xfmr_threshold_select.restype = _INT
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
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the packed scan kernel (same arguments and results as
    `ops.topk.packed_lane_scan_plain`)."""
    _check_cuda("queries", queries)
    _check_cuda("corpus", corpus)
    pair = (queries.dtype, corpus.dtype)
    if pair not in _SCAN_PAIRS:
        msg = f"packed_scan takes (query, corpus) dtypes {_SCAN_PAIRS}, got {pair}"
        raise ValueError(msg)
    batch, dim = queries.shape
    num_items = corpus.shape[0]
    if corpus.shape[1] != dim:
        msg = f"query dim {dim} != corpus dim {corpus.shape[1]}"
        raise ValueError(msg)
    if not 0 < dim <= MAX_SCAN_DIM:
        msg = f"packed_scan supports dim <= {MAX_SCAN_DIM}, got {dim}"
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
    keys = torch.empty(
        (batch, 2 * corpus_tile), dtype=torch.int32, device=queries.device
    )
    dmax = torch.zeros(batch, dtype=torch.int32, device=queries.device)
    if batch == 0:
        return keys, dmax if track_discards else None
    lib = load()
    low_mask = (1 << (idx_bits + reserve_bits)) - 1
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = lib.xfmr_packed_scan(
        queries.data_ptr(),
        corpus.data_ptr(),
        None if scales is None else scales.data_ptr(),
        keys.data_ptr(),
        dmax.data_ptr(),
        batch,
        dim,
        num_items // corpus_tile,
        corpus_tile,
        -1 if true_num_items is None else int(true_num_items),
        int(lane_shuffle),
        low_mask,
        reserve_bits,
        0 if bias_in_dot else 1,
        1 if track_discards else 0,
        _Q_KINDS[queries.dtype],
        _CORPUS_KINDS[corpus.dtype],
        stream,
    )
    _raise_on(err, "packed_scan")
    LAUNCHES["packed_scan"] += 1
    return keys, dmax if track_discards else None


MAX_SELECT_WIDTH = 16384


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
    keys = torch.empty((batch, capacity), dtype=torch.int32, device=pool.device)
    meta = torch.empty_like(keys)
    if batch == 0:
        return keys, meta
    lib = load()
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
        stream,
    )
    _raise_on(err, "threshold_select")
    LAUNCHES["threshold_select"] += 1
    return keys, meta
