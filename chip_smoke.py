#!/usr/bin/env python3
"""Drive the PyTorch port's serving, certified-search and training paths
on one CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA card (H100, sm_90a) and nvcc; builds the kernels from
`xfmr_rec_torch/csrc/` into `build/kernels/` first. Exits non-zero,
printing no result, when there is no card or any phase fails. Phases:

1. build the kernels, and the native tokenizer and BM25 libraries with
   `g++` (required here: elsewhere the library calls' default,
   `native=None`, falls back to the Python path after a warning);
2. the packed scan kernel against its plain PyTorch version: bit for bit
   on inputs whose dot products are exact in f32 (also at the serving
   tower's width, at small batches whose corpus tiles the wrapper splits
   over blocks, and with a forced split), within one key quantum on
   random unit vectors at the retrieval geometry, and the same from run
   to run and from split to split;
3. the threshold-select kernel against its plain version on real pools:
   raw keys and meta identical, at the full batch and at 128 rows;
4. the serving path: a synthesized artifact (text tower at the trained
   widths, 2^20 items, every text tokenized by the native tokenizer and
   encoded on the card), `RecService` over HTTP on localhost, every
   answer held against dense exact top-k on the card; BM25 keyword
   search over HTTP (the served index holding a native handle) against
   its `native=False` oracle; 1,024 items added
   over HTTP under traffic (no request may fail; the grown index held
   against dense exact top-k); 1,024 items removed from a copy of the
   grown index, then `search_certified("fused")` on it held against
   dense exact top-k, the surviving rows' packed keys unmoved; the
   numpy `PortableEncoder` on 1,024 served texts against the card's
   encoder at f32; the same artifact behind `index_kind="ivf"` with
   `ivf_certified` (the IVF built, cached and reloaded, `add_items`
   refused), 64 sequential requests with exclusions over HTTP beside the
   exact engine's: each certified row == dense top-k over the served
   rows, each other row the exact engine's answer (kernel 1);
5. guaranteed-exact search (`search_certified(method="fused")`) at
   2^20 x 64 bf16, B=4096, k=100, against dense exact top-k, with its
   throughput and a profile of one batch, and of one `"f32"` batch
   (device time by kernel and the device's idle share);
6. the f32 lane-max scan kernel, the count kernel and the fused
   scan + merge + select kernel against their plain versions: bit for
   bit on the exact inputs, within a stated tolerance on random unit
   vectors at the retrieval geometry; the lane-max scan with its corpus
   split over blocks (forced 2, 7 and one tile a split, and on a corpus
   built to tie) equal to its unsplit launch and from run to run;
7. the other certified paths at the same full width, each against dense
   exact top-k: `search_certified` with methods "f32" and "packed",
   `packed_guaranteed_topk(selector="fused")`, `certified_topk` with the
   discard and the count certificate, and exclusion search on an index
   with `scan_kernel="f32"`;
8. each kernel's time at the main path's shapes, its plain version's, a
   library yardstick and its bound (the threshold select and its
   yardstick from CUDA graphs, so the host does not set the reading);
9. training: (a) a synthetic corpus at ML-1M's size through the port's
   ETL, the reference config trained 300 steps through `cli fit` with
   two validations on the dense index (finite logged losses, moved
   parameters, metrics in [0, 1]), 3 steps on the card held against the
   CPU from one init at bf16 and at f32, and the train step's time at
   batch 32 and 4096 with its device-idle share, steps 10-20 traced by
   `profile_dir`, 3 steps with `remat=True` equal to 3 without (dropout
   on) and the step's peak memory with and without; (b) a 2^17-item
   catalog whose eval search runs the scan index (kernel 1), its answers
   held against dense scores, and `cli predict` over its predict users,
   each row held the same way; (c) the artifact of (a) served by
   `RecommenderEngine`, its answers equal to the trainer's own search;
10. the history tower: (a) the repo's flagship (history user tower, 16
   rated slots, InfoNCE) at full width on phase 9's corpus, 300 steps
   through `cli fit` with two validations, 3 card steps against the CPU
   at bf16 and f32, remat against plain steps, the step's time at batch
   32 and 1024, and the saved
   artifact served over HTTP (`recommend_with_user_id` for 64 users in
   one burst, `recommend_with_user` with a request history), every answer
   equal to the trainer's own user vector and search; (b) every item
   channel (Bloom ids, bias, CF bag, cf_rank 128) on phase 9's 2^17-item
   catalog, whose validation runs kernel 1 on 162-column rows: answers
   against dense scores, kernel 1 at that width against its plain
   version, and the artifact served; BM25 over the user store against
   its oracle; (c) the serve CLI (`python -m
   xfmr_rec_torch.serving.prepare`) on (a)'s artifact, golden checks
   passed;
11. (run before 9) the IVF probe on clustered 2^20 x 64 corpora (4,096
   and 512 seeded centres): the build, B=256 certified searches at
   nprobe 8, each certified row held to dense exact top-k, the probe's
   ms beside `search_certified("fused")`;
12. multi-device, on four cards where the machine has them, else on a
   virtual mesh of four slots on one card (printed): (a) phase 5's
   corpus in a `ShardedRetrievalIndex` over 4 model shards, then a
   2 x 2 (data x model) mesh, B=4096, k=100: `search` with exclusions,
   `search_certified` "fused" and "packed", `sharded_certified_topk`
   (f32, kernel 3), and the int8 corpus on 4 shards, every row held to
   dense top-k on the card; kernels 1, 2 and 3 launched inside the
   window; ms a batch beside the single card's "fused"; (b) phase 4's
   served artifact behind `index_kind="sharded"`: 64 requests in one
   burst, each the exact engine's answer; (c) the reference config, 3
   steps on a 4-device mesh and 3 with `shard_vocab` at model_parallel
   2, each == the single-device steps within 5e-5, the step's ms beside
   the single device's, and `Trainer.fit(mesh=True, model_parallel=2)`
   with one validation through `sharded_topk`;
14. (run after 12) many processes: two processes on the card (two
   mesh slots each, `chip_smoke.py --worker`) joined by
   `initialize_distributed` (gloo, staged through host memory, where
   they share one card; NCCL where each has its own), the backend
   printed: (a) phase 5's corpus in a `ShardedRetrievalIndex` over a
   1 x 4 mesh (the model axis across the processes) and a 2 x 2 one
   (each model row inside a process, the reference's layout), B=4096,
   k=100: `search` with 8 exclusions a row, `search_certified` "fused"
   and "packed", `sharded_certified_topk` (f32, kernel 3), every row held
   to dense top-k on the card by process 0, and on 2 x 2 the packed
   search (no exclusions) with the batch split over the data axis equal
   to the replicated one; each process's launches of kernels 1, 2 and 3 (each
   > 0), the ms a batch beside phase 12's; (b) phase 4's artifact behind
   `index_kind="sharded"` over 1 x 4: 64 requests through `RecService`'s
   handlers in both processes, each the exact engine's answer; (c) 3
   steps of the reference config and 3 of the flagship history tower
   (f32) on a 4 x 1 mesh over the processes, each == 3 single-device
   steps within 5e-5, then the reference config in bf16 (the port's
   default), its step 1's losses and gradient norm held to one device's
   within `MP_BF16_STEP1_RTOL`, the step's ms beside one device's; (d) the
   checkpoint cycle through `Trainer(mesh=True)`: 2 steps,
   `save_checkpoint` (process 0 writes), step 3; in a fresh group,
   restore and step 3: the same loss and parameters bit for bit. Both
   processes' answers, parameters and states are the same bits;
13. (run last) tuning and the recommend surface on phase 9's 2^17-item
   catalogue, so every validation and search runs kernel 1: (a) `tune`
   of 4 configs from seed 0 (the default point first) in rungs of 40,
   80 and 160 steps through `make_trainer_evaluator(device="cuda")`,
   every trial a finite NDCG in [0, 1], kernel 1 launched at least once
   a validation, the trial log read back and fed to
   `warm_start_sampler`; (b) `TrialExecutor(platform="cuda",
   workers=2)`, clamped to the cards present, runs (a)'s first rung in
   a spawned worker (configs and trial ids equal, metrics within a
   stated bound), and then a probe given to that worker by the
   `"import"` spec reports its pid, its one visible card and its
   kernel-1 launches; (c) on the winner retrained,
   `recommend` for 64 user texts (3 ids each excluded) and
   `recommend_users` for 64 users (train histories excluded), every
   list dense top-k within a key quantum, `cli predict --user_id` in a
   subprocess equal to `recommend_users`, and `recommend` with a raw
   text on phase 10 (b)'s item-channel trainer;
then the card, one JSON line for the kernels, and the result line.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import hashlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from xfmr_rec_torch.data.module import DataConfig, RecDataModule
from xfmr_rec_torch.data.prepare import load_table, prepare_movielens
from xfmr_rec_torch.data.synthetic import generate_movielens
from xfmr_rec_torch.index.ivf import IVFIndex
from xfmr_rec_torch.index.mips import BM25Index, RetrievalIndex
from xfmr_rec_torch.models.convert import torch_name
from xfmr_rec_torch.models.encoder import ModelConfig, TextEncoder, init_encoder
from xfmr_rec_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from xfmr_rec_torch.native import bm25_native, tokenizer_native
from xfmr_rec_torch.ops import kernels, topk, topk_f32
from xfmr_rec_torch.serving.engine import RecommenderEngine
from xfmr_rec_torch.serving.schemas import ItemQuery, Query
from xfmr_rec_torch.serving.service import RecService, make_server
from xfmr_rec_torch.training import cli
from xfmr_rec_torch.training import module as train_mod
from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig
from xfmr_rec_torch.tuning import hpo
from xfmr_rec_torch.tuning.executor import TrialExecutor

SEED = 0
# the text tower the reference trains (BASELINE.md: BERT 1 layer,
# hidden 32, 4 heads, intermediate 32), bf16 compute, dense table
ENCODER = dict(
    vocab_size=30522,
    hidden_size=32,
    num_hidden_layers=1,
    num_attention_heads=4,
    intermediate_size=32,
    hidden_act="gelu",
    pooling_mode="mean",
    compute_dtype="bfloat16",
    embedding_type="dense",
    max_length=64,
)
SERVE_ITEMS = 1 << 20
ENCODED_ITEMS = SERVE_ITEMS
# texts a chunk through the encoder, and the Python tokenizer's sample
ENCODE_CHUNK = 32768
PY_TOKENIZE_SAMPLE = 16384
# live catalog mutation: items added under traffic, then removed from a
# copy of the grown index
ADDED_ITEMS = 1024
REMOVED_ITEMS = 1024
BENCH_ITEMS = 1 << 20
BENCH_DIM = 64
BENCH_BATCH = 4096
BENCH_K = 100
# H100 SXM data-sheet peaks
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# int32 ops on the CUDA cores, each counted as one lane operation at the
# float32 lane rate (67 TFLOP/s counts an FMA as two): an optimistic
# peak, so the bound stays a least time
INT32_OPS = 67e12 / 2

WORDS = (
    "action adventure animation comedy crime drama family fantasy horror "
    "musical mystery romance thriller war western documentary noir space "
    "robot heist island winter summer city desert ocean night love friend "
    "brother sister king queen ghost dragon detective pilot soldier"
).split()


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 1) -> float:
    """Mean device milliseconds per call, CUDA events around `iters`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call with the host kept out of the
    reading: `launches` calls captured in one CUDA graph, replayed
    `replays` times between CUDA events (a call's ctypes, allocations
    and checks run once, at capture)."""
    fn()  # the build, the launch plan and the allocator warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def exact_inputs(gen, batch, num_items, dim, int8=False):
    """Values k/16 (|k| <= 8), or int8 rows with power-of-two scales:
    every product and partial sum is exact in f32, and the power-of-two
    bound keeps the 0.25/bound query scaling exact too."""
    q = torch.randint(-8, 9, (batch, dim), generator=gen).float() / 16
    if int8:
        c = torch.randint(-127, 128, (num_items, dim), generator=gen)
        c = c.to(torch.int8)
        scales = 2.0 ** -torch.randint(8, 11, (num_items,), generator=gen)
        scales = scales.float()
        peak = (q.abs().sum(1).max() * 127 * scales.max()).item()
    else:
        c = torch.randint(-8, 9, (num_items, dim), generator=gen).float() / 16
        scales = None
        peak = (q.abs().sum(1).max() * 0.5).item()
    bound = 2.0 ** math.ceil(math.log2(peak + 1e-3))
    return q, c, scales, bound


def exact_tensors(gen, dev, int8=False, f32=False, bias=False, batch=500,
                  dim=64):
    """`exact_inputs` at B=500, N=65536, D=64 (unless told otherwise) on
    the card, in the dtypes of one kernel instantiation (bf16/bf16,
    bf16/int8 or f32/f32), with the 1.5 column appended for
    `bias_in_dot`."""
    q, c, scales, bound = exact_inputs(gen, batch, 1 << 16, dim, int8=int8)
    if bias:
        c = torch.cat([c, torch.full((len(c), 1), 1.5)], dim=1)
    qdt = torch.float32 if f32 else torch.bfloat16
    cdt = torch.int8 if int8 else qdt
    sd = None if scales is None else scales.to(dev)
    return q.to(dev, qdt), c.to(dev, cdt), sd, bound


def quantum_scaled(qbits: int) -> float:
    """One key quantum in scaled-score units (keys live in [1.25, 1.75),
    ulp 2^-23, with `qbits` low bits masked)."""
    return 2.0 ** (qbits - 23)


def index_quantum_bits(index) -> int:
    """Masked low key bits of an index's packed searches: the tile index
    plus one reserved bit for the single lane-pair merge both use."""
    corpus, _, tile, _ = index._scan_setup()
    return max((corpus.shape[0] // tile - 1).bit_length(), 1) + 1


# ---------------------------------------------------------------------------
# phase 2: packed scan kernel vs plain
# ---------------------------------------------------------------------------
def phase_scan(dev) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    cases = [
        ("base", {}),
        ("no_discards", dict(track_discards=False)),
        ("shuffle1", dict(lane_shuffle=1)),
        ("shuffle3_reserve1_padding",
         dict(lane_shuffle=3, reserve_bits=1, true_num_items=60000)),
        ("int8_scales", dict(int8=True)),
        ("int8_scales_shuffle5", dict(int8=True, lane_shuffle=5)),
        ("bias_in_dot", dict(bias_in_dot=True)),
        ("f32_inputs", dict(f32=True, lane_shuffle=1)),
        # the serving tower's width
        ("dim32_shuffle1", dict(dim=32, lane_shuffle=1)),
        ("dim32_int8_scales", dict(dim=32, int8=True)),
        # small batches: the wrapper splits the corpus tiles over blocks
        ("batch64_shuffle3_padding",
         dict(batch=64, lane_shuffle=3, reserve_bits=1, true_num_items=60000)),
        ("batch8", dict(batch=8)),
        ("batch8_int8_scales", dict(batch=8, int8=True, lane_shuffle=5)),
        ("batch8_f32_inputs", dict(batch=8, f32=True)),
        ("forced_splits5_shuffle1", dict(splits=5, lane_shuffle=1)),
        ("forced_splits32_bias_in_dot", dict(splits=32, bias_in_dot=True)),
        # the history tower's index rows (phase 10): + bias (33), + CF
        # factors and popularity (161), both (162); off the 16-byte grid
        ("dim33", dict(dim=33)),
        ("dim161_shuffle1", dict(dim=161, lane_shuffle=1)),
        ("dim162_padding", dict(dim=162, true_num_items=60000)),
        ("dim161_bias_in_dot", dict(dim=161, bias_in_dot=True)),
        ("dim161_int8_scales", dict(dim=161, int8=True)),
        ("batch8_dim162", dict(batch=8, dim=162)),
    ]
    for name, opts in cases:
        opts = dict(opts)
        int8 = opts.pop("int8", False)
        f32 = opts.pop("f32", False)
        batch = opts.pop("batch", 500)
        splits = opts.pop("splits", None)
        qd, cd, sd, bound = exact_tensors(
            gen, dev, int8=int8, f32=f32, bias=opts.get("bias_in_dot", False),
            batch=batch, dim=opts.pop("dim", 64),
        )
        q_s, s_s, geom = topk.prepare_packed_scan(
            qd, cd, score_bound=bound, batch_tile=batch, corpus_tile=2048,
            scales=sd, **opts,
        )
        got = kernels.packed_scan(q_s, cd, s_s, splits=splits, **geom)
        chosen = splits or kernels.packed_scan_splits(q_s, cd, **geom)
        want = topk.packed_lane_scan_plain(q_s, cd, s_s, **geom)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"scan keys differ ({name})")
        if geom["track_discards"]:
            check(torch.equal(got[1], want[1]), f"scan dmax differs ({name})")
        else:
            check(got[1] is None, f"dmax returned untracked ({name})")
        check(chosen > 1 or batch == 500,
              f"unexpected corpus splits {chosen} ({name})")
        print(f"scan exact case {name}: keys and dmax bit-identical "
              f"(B={batch}, N=65536, D={cd.shape[1]}, corpus splits {chosen}"
              f"{' forced' if splits else ''})")

    # random unit vectors at the retrieval geometry
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.nn.functional.normalize(
        torch.randn(BENCH_BATCH, BENCH_DIM, device=dev, generator=g), dim=1
    ).bfloat16()
    c = torch.nn.functional.normalize(
        torch.randn(BENCH_ITEMS, BENCH_DIM, device=dev, generator=g), dim=1
    ).bfloat16()
    q_s, _, geom = topk.prepare_packed_scan(
        q, c, score_bound=1.05, batch_tile=512, corpus_tile=2048,
        reserve_bits=1,
    )
    got_keys, got_dmax = kernels.packed_scan(q_s, c, None, **geom)
    want_keys, want_dmax = topk.packed_lane_scan_plain(q_s, c, None, **geom)
    qbits = geom["idx_bits"] + geom["reserve_bits"]
    decode = dict(idx_bits=geom["idx_bits"], reserve_bits=1, score_bound=1.05)
    err = (
        topk.decode_scores(got_keys, **decode)
        - topk.decode_scores(want_keys, **decode)
    ).abs().max().item()
    err_dmax = (
        topk.decode_scores(got_dmax, **decode)
        - topk.decode_scores(want_dmax, **decode)
    ).abs().max().item()
    # one key quantum in score units, plus f32 reassociation of a 64-term
    # dot of unit vectors (64 * 2^-24 relative, x4 for the window scale)
    tol = quantum_scaled(qbits) * 1.05 / 0.25 + 64 * 2.0**-24 * 4
    same = (got_keys == want_keys).float().mean().item()
    print(f"scan random B={BENCH_BATCH} N={BENCH_ITEMS} D={BENCH_DIM}: "
          f"{same:.6f} of keys bit-identical, decoded score max_abs_err "
          f"{err:.3e} (dmax {err_dmax:.3e}), tolerance {tol:.3e} "
          "(one key quantum + f32 reassociation)")
    check(err <= tol and err_dmax <= tol, "scan random-input error too large")
    check(kernels.packed_scan_splits(q_s, c, **geom) == 1,
          "the full batch was split over blocks")

    # with the corpus split over blocks, the partial top-2s are merged by
    # whichever block arrives last: integer max and min only, so two runs
    # agree bit for bit, and with the unsplit sweep of the same rows
    q_rows = q_s[:256].contiguous()
    run1 = kernels.packed_scan(q_rows, c, None, **geom)
    chosen = kernels.packed_scan_splits(q_rows, c, **geom)
    run2 = kernels.packed_scan(q_rows, c, None, **geom)
    forced = kernels.packed_scan(q_rows, c, None, splits=37, **geom)
    torch.cuda.synchronize()
    check(chosen > 1, "a 256-row sweep was not split over blocks")
    for what, other in (("a second run", run2), ("37 forced splits", forced),
                        ("the unsplit full batch",
                         (got_keys[:256], got_dmax[:256]))):
        check(torch.equal(run1[0], other[0]) and torch.equal(run1[1], other[1]),
              f"split sweep differs from {what}")
    print(f"scan random B=256 with the corpus split {chosen} ways over "
          "blocks: keys and dmax torch.equal run to run, to 37 forced "
          "splits and to the same rows of the unsplit B=4096 sweep")
    return {"max_abs_err": max(err, err_dmax), "keys": got_keys,
            "idx_bits": geom["idx_bits"], "queries": q, "corpus": c}


# ---------------------------------------------------------------------------
# phase 3: threshold select kernel vs plain
# ---------------------------------------------------------------------------
def phase_select(scan: dict) -> dict:
    keys = scan["keys"]
    ct = keys.shape[1] // 2
    k1, k2, k3, _ = topk.merge_lane_pairs3(keys[:, :ct], keys[:, ct:], 0)
    pools = {
        3072: (torch.cat([k1, k2, k3], dim=1), scan["idx_bits"] + 1),
        4096: (keys, scan["idx_bits"] + 1),
    }
    for width, (pool, qbits) in pools.items():
        opts = dict(capacity=128, quantum_bits=qbits, shared_exponent=True)
        # the full batch, and the first 128 rows as a retry round sends them
        for rows in (pool.shape[0], 128):
            part = pool[:rows].contiguous()
            got = kernels.threshold_select(part, BENCH_K, **opts)
            want = topk.select_topk_keys_plain(part, BENCH_K, **opts)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"select raw outputs differ from plain (W={width}, B={rows})")
            grid = kernels.threshold_select_grid(part)
            print(f"select W={width} B={rows} k={BENCH_K} cap=128 quantum "
                  f"bits {qbits}: raw keys and meta torch.equal to plain "
                  f"(warps a block, blocks: {grid})")
    return {"max_abs_err": 0.0, "pool": pools[3072][0].contiguous(),
            "qbits": pools[3072][1]}


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------
def item_text(rng, i: int) -> str:
    words = rng.choice(WORDS, size=rng.integers(3, 9))
    return f"{' '.join(words)} ({1950 + i % 70})"


def synthesize_artifact(root: pathlib.Path, dev,
                        card: str) -> tuple[list[str], float]:
    """processors.json, portable.json, encoder.npz and index/ in the
    layout `Trainer.save` writes, with seeded weights."""
    config = ModelConfig(**ENCODER)
    rng = np.random.default_rng(SEED)
    template = TextEncoder(config).state_dict()
    flat = {}
    for name, tensor in template.items():
        flax_name = name.replace("layers.", "layer_").replace(".", "/")
        check(torch_name(flax_name) == name, f"name map failed for {name}")
        if name.endswith("scale"):
            value = 1.0 + 0.1 * rng.standard_normal(tensor.shape)
        else:
            value = 0.02 * rng.standard_normal(tensor.shape)
        if name == "word_embed.embedding":
            value = 0.5 * rng.standard_normal(tensor.shape)
        flat[flax_name] = value.astype(np.float32)
    np.savez(root / "encoder.npz", **flat)
    model_dump = dataclasses.asdict(config)
    data_dump = {"tokenizer": "hashing", "vocab_size": 30522,
                 "max_length": ENCODER["max_length"]}
    (root / "processors.json").write_text(json.dumps(
        {"model": model_dump, "data": data_dump, "step": 0,
         "best_metric": 0.0}
    ))
    (root / "portable.json").write_text(json.dumps(
        {"model": model_dump,
         "tokenizer": {"kind": "hashing", "vocab_size": 30522,
                       "max_length": ENCODER["max_length"]}}
    ))
    texts = [item_text(rng, i) for i in range(SERVE_ITEMS)]
    from xfmr_rec_torch.models.convert import build_encoder, load_portable

    _, _, state = load_portable(root)
    encoder = build_encoder(config, state, dev)
    tok = HashingTokenizer(TokenizerConfig(vocab_size=30522,
                                           max_length=ENCODER["max_length"]))
    # every catalogue text through the native tokenizer and the encoder
    t0 = time.perf_counter()
    tokens = tok.encode_batch(texts[:ENCODED_ITEMS], native=True)
    tokenize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_tokens = tok.encode_batch(texts[:PY_TOKENIZE_SAMPLE], native=False)
    py_tokenize_s = time.perf_counter() - t0
    check(np.array_equal(tokens[:PY_TOKENIZE_SAMPLE], py_tokens),
          "native token ids differ from the Python tokenizer's")
    t0 = time.perf_counter()
    tokens_dev = torch.from_numpy(tokens).to(dev)
    encoded = torch.cat([
        encoder(tokens_dev[start:start + ENCODE_CHUNK])
        for start in range(0, ENCODED_ITEMS, ENCODE_CHUNK)
    ])
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    del tokens_dev
    check(encoded.shape == (SERVE_ITEMS, ENCODER["hidden_size"])
          and bool(torch.isfinite(encoded).all()),
          "the encoded catalogue is not finite at its shape")
    corpus = encoded
    ids = np.arange(1, SERVE_ITEMS + 1)
    metadata = [{"movie_text": t, "movie_rn": int(i)}
                for t, i in zip(texts, ids, strict=True)]
    index = RetrievalIndex(corpus, ids, metadata, id_col="movie_id",
                           method="auto", device=dev)
    check(index.method == "scan", "method='auto' did not pick the scan")
    index.save(root / "index")
    print(f"artifact: all {ENCODED_ITEMS} item texts tokenized by the "
          f"native tokenizer in {tokenize_s:.3f} s (the Python tokenizer: "
          f"{py_tokenize_s:.3f} s for {PY_TOKENIZE_SAMPLE}, ids equal) and "
          f"encoded on the card in {encode_s:.3f} s (host wall, "
          f"{ENCODE_CHUNK} texts a pass); index method 'auto' -> "
          f"{index.method!r} [{card}]")
    return texts, encode_s


def scaled_queries(index, emb: torch.Tensor) -> torch.Tensor:
    """The packed search's own queries: bf16, scaled by 0.25/bound with
    the bound `RetrievalIndex.search` computes, rounded back to bf16."""
    q = emb.to(index.device, torch.bfloat16)
    qnorm = torch.linalg.vector_norm(q.float(), dim=-1).max()
    bound = torch.clamp(index._corpus_maxnorm * qnorm * 1.05, min=1e-6)
    return (q.float() * (0.25 / bound.float())).bfloat16()


def check_exclusion_search(dense, ct, exclude, got_pos, k, tol, what,
                           shards=1):
    """Hold exclusion-search answers against dense scores on the card.

    `packed_topk_excluding` is not certified: its scan keeps the top-2
    keys of each lane and one lane-pair merge keeps the top-2 of each
    pair (lanes j and j + ct/2 of every tile), exclusions included, before
    the exclusions are dropped. So the exact answer is the top-k of those
    pair survivors. Scores known only to within `tol` make survival
    uncertain near a pair's second place; so `sure` holds items that beat
    their pair's third by more than `tol` and `maybe` items within `tol`
    of its second. Every returned item must be a possible survivor at or
    above the k-th sure score, and every sure survivor above the k-th
    possible score must be returned; no duplicates, no exclusions.
    Over a corpus split in `shards` equal shards of whole tiles (the
    sharded search), each shard keeps its own pair survivors.
    """
    batch, n = dense.shape
    half = ct // 2
    # a partial last tile: its padded lanes hold no item (the scan masks
    # them), so they score -inf and survive nothing
    dense = torch.nn.functional.pad(dense, (0, -n % ct), value=-math.inf)
    per_pair = dense.view(batch, shards, -1, 2, half).permute(0, 1, 4, 2, 3)
    top3 = torch.topk(per_pair.reshape(batch, shards * half, -1), 3,
                      dim=-1).values
    columns = torch.arange(dense.shape[1], device=dense.device)
    pair_of = columns // (dense.shape[1] // shards) * half + columns % half
    maybe = dense >= top3[:, pair_of, 1] - tol
    sure = dense > top3[:, pair_of, 2] + tol
    maybe[:, n:] = False
    sure[:, n:] = False
    for row, excl in enumerate(exclude):
        if excl:
            idx = torch.tensor(excl, device=dense.device)
            maybe[row, idx] = False
            sure[row, idx] = False
    neg = torch.tensor(-math.inf, device=dense.device)
    kth_sure = torch.topk(torch.where(sure, dense, neg), k).values[:, -1]
    kth_maybe = torch.topk(torch.where(maybe, dense, neg), k).values[:, -1]
    for row in range(batch):
        pos = got_pos[row]
        check(len(set(pos.tolist())) == len(pos), f"{what}: duplicates")
        check(bool(maybe[row, pos].all()), f"{what}: not a lane-pair survivor")
        check(bool((dense[row, pos] >= kth_sure[row] - tol).all()),
              f"{what}: item below the k-th")
        required = sure[row] & (dense[row] > kth_maybe[row] + tol)
        check(int(required[pos].sum()) == int(required.sum()),
              f"{what}: missed a top item")


def check_direct_search(engine, rng, dev, what: str) -> tuple[float, float]:
    """8 seeded text queries with 5 excluded ids each through
    `engine.index.search`, held against dense top-k of the lane-pair
    survivors on the card at key-quantum resolution. Item ids are corpus
    positions + 1. Returns the search's host ms and recall@k against
    unrestricted dense top-k."""
    num_items = len(engine.index)
    tight = quantum_scaled(index_quantum_bits(engine.index)) + 1e-6
    queries = [" ".join(rng.choice(WORDS, size=4)) for _ in range(8)]
    excl = [[int(x) for x in rng.integers(1, num_items + 1, size=5)]
            for _ in queries]
    emb = torch.from_numpy(engine.embed(queries))
    t0 = time.perf_counter()
    _, got_ids = engine.index.search(emb.numpy(), top_k=BENCH_K,
                                     exclude_ids=excl)
    direct_ms = (time.perf_counter() - t0) * 1e3
    ct = engine.index._scan_setup()[2]
    q_s = scaled_queries(engine.index, emb)
    dense = q_s.float() @ engine.index.corpus.float().T
    excl_pos = [[i - 1 for i in e] for e in excl]
    got_pos = torch.from_numpy(got_ids.astype(np.int64) - 1).to(dev)
    check_exclusion_search(dense, ct, excl_pos, got_pos, BENCH_K, tight, what)
    exact_top = 0
    for row in range(len(queries)):
        masked = dense[row].clone()
        masked[torch.tensor(excl_pos[row], device=dev)] = -math.inf
        true_top = set(torch.topk(masked, BENCH_K).indices.tolist())
        exact_top += len(true_top & set(got_pos[row].tolist()))
        check(not set(excl[row]) & set(got_ids[row].tolist()),
              f"{what}: an excluded id came back")
    return direct_ms, exact_top / (BENCH_K * len(queries))


def phase_serving(dev, card: str, root: pathlib.Path) -> dict:
    """The served artifact is written under `root` and kept there for
    phase 12."""
    texts, _ = synthesize_artifact(root, dev, card)
    check_portable(root, texts, dev, card)
    t0 = time.perf_counter()
    engine = RecommenderEngine(root, device=dev, warmup=True)
    print(f"engine load + warmup {time.perf_counter() - t0:.2f} s")
    service = RecService(engine, micro_batch=64, micro_batch_wait_ms=20,
                         allow_catalog_mutation=True)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    launches = {name: 0 for name in kernels.LAUNCHES}

    def add_launches():
        counts = kernels.launch_counts()
        for name, count_ in counts.items():
            launches[name] += count_
        return counts

    def post(endpoint, payload):
        req = urllib.request.Request(
            f"{base}/{endpoint}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    rng = np.random.default_rng(SEED + 3)
    tight = quantum_scaled(index_quantum_bits(engine.index)) + 1e-6
    kernels.reset_launch_counts()
    thread.start()
    try:
        # (a) direct engine search, checked at key-quantum resolution
        direct_ms, recall = check_direct_search(engine, rng, dev,
                                                "direct search")
        print(f"serving direct: 8 queries x top-{BENCH_K} with exclusions == "
              "dense top-k of the lane-pair survivors up to one key quantum "
              f"({tight:.2e} scaled); recall@{BENCH_K} vs unrestricted dense "
              f"{recall:.4f}; {direct_ms:.2f} ms host wall [{card}]")
        ct = engine.index._scan_setup()[2]

        # (b) HTTP requests through RecService
        answers = []
        queries = [" ".join(rng.choice(WORDS, size=4)) for _ in range(3)]
        for text in queries:
            answers.append((text, [], post("recommend_with_query",
                                           {"query": {"text": text},
                                            "top_k": 20})))
        for item_id in (1, 777, 16000):
            item = post("item_id", {"item_id": item_id})
            check(item["movie_id"] == item_id
                  and item["movie_text"] == texts[item_id - 1],
                  "item_id returned the wrong row")
            excl_ids = [item_id, item_id + 1]
            body = post("recommend_with_item_id",
                        {"item_id": item_id, "exclude_item_ids": excl_ids,
                         "top_k": 20})
            answers.append((item["movie_text"], excl_ids, body))
        burst_texts = [item_text(rng, i) for i in range(64)]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(64) as pool:
            futures = [pool.submit(post, "recommend_with_query",
                                   {"query": {"text": t}, "top_k": 10})
                       for t in burst_texts]
            burst = [f.result(timeout=300) for f in futures]
        burst_s = time.perf_counter() - t0
        answers += [(t, [], b) for t, b in zip(burst_texts, burst, strict=True)]
        batcher = service.batcher
        # served queries may come from a batched encode and a batch-wide
        # score bound: both move the bf16 query by up to a rounding step
        # (2^-8 relative), so HTTP answers are held to 1e-2 of a unit score
        loose = 1e-2
        for text, excl_ids, body in answers:
            check(len(body) > 0, "empty answer")
            got_ids = [c["movie_id"] for c in body]
            check(not set(excl_ids) & set(got_ids), "an excluded id came back")
            emb1 = torch.from_numpy(engine.embed([text])).to(dev)
            dense1 = emb1.bfloat16().float() @ engine.index.corpus.float().T
            pos = torch.tensor([i - 1 for i in got_ids], device=dev)
            check_exclusion_search(dense1, ct, [[i - 1 for i in excl_ids]],
                                   pos[None], len(got_ids), loose,
                                   f"http {text!r}")
            served = torch.tensor([c["score"] for c in body], device=dev)
            check(bool(((served - dense1[0, pos]).abs() <= loose).all()),
                  "served scores disagree with dense")
        health = urllib.request.urlopen(f"{base}/healthz", timeout=30).read()
        check(json.loads(health) == {"status": "ok"}, "healthz")
        add_launches()
        print(f"serving http: {len(answers)} answers (3 recommend_with_query, "
              "3 recommend_with_item_id with exclusions, 3 item_id lookups, "
              f"a 64-request burst in {burst_s:.2f} s host wall served in "
              f"{batcher.batches_dispatched} micro-batches) all == dense "
              f"top-k of the lane-pair survivors within {loose} [{card}]")

        # (b) BM25 keyword search over HTTP on the whole catalogue
        check_text_search(
            base, "search_items_text", engine.index.search_text,
            engine.index.metadata, "movie_text", engine.index.ids, "movie_id",
            [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 4))))
             for _ in range(16)], card)
        check(engine.index._fts._native is not None,
              "the served item BM25 answered from the Python path")

        # (c) 1,024 items added under traffic, (d) removal + certified
        kernels.reset_launch_counts()
        check_live_add(engine, base, rng, dev, card)
        counts = add_launches()
        print(f"live add kernel launches: {counts}")
        check(counts["packed_scan"] > 0, "the grown index never launched "
              "packed_scan")
        kernels.reset_launch_counts()
        check_removal(engine, rng, dev, card)
        counts = add_launches()
        print(f"removal + certified kernel launches: {counts}")
        check(counts["packed_scan"] > 0 and counts["threshold_select"] > 0,
              "certified search on the compacted index skipped a kernel")

        # (e) the IVF probe over the same artifact (counts reset inside)
        counts = phase_ivf_serving(root, texts, dev, card)["launches"]
        for name, count_ in counts.items():
            launches[name] += count_
        print(f"ivf serving kernel launches: {counts}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    print(f"serving path kernel launches: {launches}")
    check(launches["packed_scan"] > 0, "serving path never launched packed_scan")
    return {"launches": launches, "texts": texts}


def post_status(base: str, endpoint: str, payload: dict):
    """(HTTP status, JSON body) of one POST, error statuses included."""
    req = urllib.request.Request(
        f"{base}/{endpoint}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def check_text_search(base, endpoint, search, rows, text_col, ids, id_key,
                      queries, card):
    """BM25 over HTTP: the index's build seconds (its first search,
    direct), the p50 and max of 64 sequential requests, and 16 seeded
    queries equal to the `native=False` oracle over the same rows (rows
    equal, scores within 1e-5 relative); `ids[row]` is a row's id."""
    t0 = time.perf_counter()
    search("", top_k=1)
    build_s = time.perf_counter() - t0
    lat = []
    for i in range(64):
        t0 = time.perf_counter()
        status, _ = post_status(base, endpoint,
                                {"query": queries[i % len(queries)],
                                 "top_k": 10})
        lat.append((time.perf_counter() - t0) * 1e3)
        check(status == 200, f"{endpoint} answered {status}")
    lat.sort()
    t0 = time.perf_counter()
    oracle = BM25Index(rows, text_col=text_col, native=False)
    oracle_s = time.perf_counter() - t0
    identical = 0
    for query in queries:
        status, body = post_status(base, endpoint,
                                   {"query": query, "top_k": 10})
        want = oracle.search(query, top_k=10)
        check(status == 200 and len(body) == len(want) > 0,
              f"{endpoint} {query!r}: {len(body)} hits, oracle {len(want)}")
        for hit, (row, score) in zip(body, want, strict=True):
            check(hit[id_key] == int(ids[row])
                  and hit[text_col] == rows[row][text_col]
                  and abs(hit["score"] - score) <= 1e-5 * score,
                  f"{endpoint} {query!r} differs from the oracle")
        identical += [h["score"] for h in body] == [sc for _, sc in want]
    print(f"{endpoint}: BM25 over {len(rows)} rows built in {build_s:.3f} s "
          f"(native); 64 sequential requests over HTTP p50 "
          f"{lat[len(lat) // 2]:.3f} ms, max {lat[-1]:.3f} ms (host clock); "
          f"16 seeded queries == the native=False oracle over all "
          f"{len(rows)} rows (built in {oracle_s:.3f} s): rows equal, scores "
          f"within 1e-5 relative, {identical} of 16 bit-identical [{card}]")


def check_live_add(engine, base, rng, dev, card) -> None:
    """(c) `add_items` refused (403) by a service started without
    `allow_catalog_mutation`; then 1,024 items added over HTTP while 4
    client threads send `recommend_with_query`: no request fails, the
    grown index answers 8 searches with exclusions as dense top-k does
    at key-quantum resolution, and each added item's text retrieves it
    in its top 10."""
    gated = make_server(RecService(engine), port=0)
    gated_thread = threading.Thread(target=gated.serve_forever, daemon=True)
    gated_thread.start()
    try:
        status, _ = post_status(
            f"http://127.0.0.1:{gated.server_address[1]}", "add_items",
            {"items": [{"movie_id": 10**9, "movie_text": "x"}]})
    finally:
        gated.shutdown()
        gated.server_close()
        gated_thread.join(timeout=30)
    check(status == 403, f"add_items without the flag answered {status}")
    before = len(engine.index)
    new_ids = list(range(before + 1, before + 1 + ADDED_ITEMS))
    # a unique word a text, so each added item has its own embedding
    new_texts = [f"{item_text(rng, i)} release{i}" for i in new_ids]
    items = [{"movie_rn": i, "movie_id": i, "movie_text": t}
             for i, t in zip(new_ids, new_texts, strict=True)]
    log = []  # (start, seconds, ok) of each client request
    stop = threading.Event()

    def client(seed):
        crng = np.random.default_rng(seed)
        while not stop.is_set():
            text = " ".join(crng.choice(WORDS, size=4))
            t0 = time.perf_counter()
            try:
                status, body = post_status(base, "recommend_with_query",
                                           {"query": {"text": text},
                                            "top_k": 10})
                ok = status == 200 and len(body) == 10
            except (OSError, ValueError):
                ok = False
            log.append((t0, time.perf_counter() - t0, ok))

    clients = [threading.Thread(target=client, args=(SEED + 40 + i,))
               for i in range(4)]
    for t in clients:
        t.start()
    try:
        time.sleep(1.0)
        t_add = time.perf_counter()
        status, body = post_status(base, "add_items", {"items": items})
        t_done = time.perf_counter()
        time.sleep(2.0)
    finally:
        stop.set()
        for t in clients:
            t.join(timeout=60)
    check(not any(t.is_alive() for t in clients), "a client hung")
    check(status == 200 and body == {"added": ADDED_ITEMS,
                                     "num_items": before + ADDED_ITEMS},
          f"add_items answered {status}: {body}")
    failed = sum(not ok for _, _, ok in log)
    during = [r for r in log if r[0] < t_done and r[0] + r[1] > t_add]
    after = sorted(r for r in log if r[0] >= t_done)
    check(failed == 0, f"{failed} of {len(log)} requests failed")
    check(len(during) > 0 and len(after) > 8, "no traffic around the add")
    steady = sorted(r[1] for r in after[len(after) // 2:])
    index = engine.index
    check(len(index) == before + ADDED_ITEMS
          and index._scan_state is not None
          and index._scan_state[3] == before + ADDED_ITEMS,
          "the published index is not the warmed, grown one")
    direct_ms, recall = check_direct_search(engine, rng, dev,
                                            "search after the add")
    _, got = index.search(engine.embed(new_texts), top_k=10)
    missed = [i for i, row in zip(new_ids, got, strict=True) if i not in row]
    check(not missed, f"{len(missed)} added items miss their own top 10")
    tight = quantum_scaled(index_quantum_bits(index)) + 1e-6
    print(f"live add: add_items answers 403 without "
          f"allow_catalog_mutation; {ADDED_ITEMS} items added over HTTP in "
          f"{(t_done - t_add) * 1e3:.1f} ms host wall while 4 clients sent "
          f"{len(log)} recommend_with_query requests ({len(during)} "
          f"overlapping the add, max {max(r[1] for r in during) * 1e3:.1f} "
          f"ms), 0 failed; first request after the swap "
          f"{after[0][1] * 1e3:.3f} ms, steady p50 "
          f"{steady[len(steady) // 2] * 1e3:.3f} ms (host clock, HTTP and "
          f"micro-batching included); the grown index ({len(index)} items, "
          f"a partial last tile) answers 8 searches with exclusions == dense "
          f"top-k of the lane-pair survivors within one key quantum "
          f"({tight:.2e} scaled; recall@{BENCH_K} vs unrestricted dense "
          f"{recall:.4f}, {direct_ms:.2f} ms); every added item's text finds "
          f"it in its top 10 [{card}]")


def survivor_keys(index, queries, ids, idx_bits) -> torch.Tensor:
    """Packed keys (the scan's plain key function, tile stamp 0, one
    reserved bit) of the rows `ids` for these queries at the index's own
    score bound, from the stored rows, in f64 on the host."""
    bound = index._score_bound(queries).cpu()
    q_s = torch.from_numpy(queries).bfloat16().float() * (0.25 / bound)
    q_s = q_s.bfloat16().double()
    rows = torch.tensor([index._id_to_pos[int(i)] for i in ids],
                        device=index.device)
    scores = (q_s @ index.corpus[rows].cpu().double().T).float()
    return topk._packed_keys(scores, 0, idx_bits, 1)


def check_removal(engine, rng, dev, card) -> None:
    """(d) 1,024 seeded ids removed from a copy of the grown index, then
    `search_certified("fused")` at B=4096, k=100 on it: every row
    certified or answered by the dense fallback, the answers dense exact
    top-k of the compacted corpus at key-quantum resolution, and 64
    surviving rows' packed keys bit-equal before and after (the max norm,
    so the key quantum, is kept)."""
    shrunk = copy.copy(engine.index)
    all_ids = shrunk.ids.astype(np.int64)
    drop = rng.choice(all_ids, size=REMOVED_ITEMS, replace=False)
    kept = np.setdiff1d(all_ids, drop)
    survivors = rng.choice(kept, size=64, replace=False)
    queries = engine.embed(
        [" ".join(rng.choice(WORDS, size=4)) for _ in range(BENCH_BATCH)])
    idx_bits = max((shrunk._scan_setup()[0].shape[0]
                    // shrunk._scan_setup()[2] - 1).bit_length(), 1)
    keys_before = survivor_keys(shrunk, queries[:64], survivors, idx_bits)
    maxnorm = shrunk._corpus_maxnorm
    t0 = time.perf_counter()
    shrunk.remove_items(drop)
    remove_ms = (time.perf_counter() - t0) * 1e3
    check(len(shrunk) == len(all_ids) - REMOVED_ITEMS
          and len(engine.index) == len(all_ids),
          "removal changed the wrong index")
    check(shrunk._corpus_maxnorm == maxnorm, "removal moved the max norm")
    keys_after = survivor_keys(shrunk, queries[:64], survivors, idx_bits)
    check(torch.equal(keys_before, keys_after),
          "a surviving row's packed key moved")
    t0 = time.perf_counter()
    _, ids = shrunk.search_certified(queries, top_k=BENCH_K, method="fused")
    certified_ms = (time.perf_counter() - t0) * 1e3
    stats = shrunk.last_certified_stats
    check(stats["batch"] == BENCH_BATCH, "certified batch size")
    check(not np.isin(ids, drop).any(), "a removed id came back")
    positions = np.vectorize(shrunk._id_to_pos.__getitem__)(ids)
    check(all(len(set(row)) == BENCH_K for row in positions.tolist()),
          "duplicate answers")
    tight = quantum_scaled(index_quantum_bits(shrunk)) + 1e-6
    off = packed_rows_off_quantum(shrunk, queries, positions, tight,
                                  "certified search after removal")
    print(f"removal: {REMOVED_ITEMS} seeded ids removed from a copy of the "
          f"grown index in {remove_ms:.1f} ms host wall ({len(shrunk)} "
          f"left), the max norm kept and 64 survivors' packed keys "
          f"bit-equal for 64 queries; search_certified('fused') at "
          f"B={BENCH_BATCH}, k={BENCH_K}: {stats['pipeline_bad']} rows "
          f"answered by the dense fallback, the rest certified, every row == "
          f"dense exact top-k of the compacted corpus within one key quantum "
          f"({off} held in plain bf16 order instead); {certified_ms:.1f} ms "
          f"host wall, first call on the compacted corpus [{card}]")


# ---------------------------------------------------------------------------
# phase 4 (e, f): the IVF probe over the served catalogue; the portable
# encoder
# ---------------------------------------------------------------------------
IVF_REQUESTS = 64
# PortableEncoder (numpy f32) against the card's encoder at f32: both
# f32, with other summation orders and another LayerNorm variance
# formula (two-pass in numpy, E[x^2] - E[x]^2 in the port); the CPU
# parity test sees under 1e-5 at these widths
PORTABLE_TOL = 5e-5
PORTABLE_TEXTS = 1024


def held_to_dense_top_k(dense_row, got_pos, got_scores, k, what,
                        tol=1e-5) -> None:
    """An answer that claims to be exact against the dense scores of the
    rows it searched: the top-k set, up to exactly tied scores at the
    k-th place, with each score within `tol` of the dense one."""
    kth = torch.topk(dense_row, k).values[-1]
    pos = torch.as_tensor(got_pos, device=dense_row.device)
    check(len(set(got_pos.tolist())) == len(got_pos), f"{what}: duplicates")
    check(bool((dense_row[pos] >= kth).all()), f"{what}: item below the k-th")
    check(int((dense_row > kth).sum()) <= len(got_pos)
          and bool(torch.isin(torch.nonzero(dense_row > kth).squeeze(1),
                              pos).all()), f"{what}: missed a top item")
    got = torch.as_tensor(got_scores, device=dense_row.device)
    check(bool(((got - dense_row[pos]).abs() <= tol).all()),
          f"{what}: scores differ from dense")


def timed_requests(base, requests) -> tuple[list, list[float]]:
    """`recommend_with_item_id` with exclusions, one at a time: the
    answers and each request's host ms (HTTP on localhost included)."""
    bodies, lat = [], []
    for item_id, excl in requests:
        t0 = time.perf_counter()
        bodies.append(post_json(base, "recommend_with_item_id",
                                {"item_id": item_id,
                                 "exclude_item_ids": excl, "top_k": 20}))
        lat.append((time.perf_counter() - t0) * 1e3)
    return bodies, lat


def phase_ivf_serving(root: pathlib.Path, texts: list[str], dev,
                      card: str) -> dict:
    """The served catalogue (2^20 items at dim 32, the seeded text tower)
    behind `RecommenderEngine(index_kind="ivf", ivf_certified=True)`:
    built (k-means, spill, layout), cached under `ivf/`, restarted on the
    cache; `add_items` refused; 64 sequential `recommend_with_item_id`
    requests with exclusions over HTTP beside the exact engine's; a
    certified row == dense top-k over the served rows, a fallback row ==
    the exact engine's answer (kernel 1)."""
    launches = {name: 0 for name in kernels.LAUNCHES}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    first = RecommenderEngine(root, index_kind="ivf", ivf_certified=True,
                              device=dev)
    build_s = time.perf_counter() - t0
    ivf = first.ivf
    n = len(ivf)
    check(not first.ivf_cache_hit, "the first IVF load found a cache")
    check(ivf.num_clusters == max(4, int(4 * math.sqrt(n))),
          f"{ivf.num_clusters} clusters, not the 4 sqrt(N) rule")
    split = ", ".join(f"{k} {v:.2f} s" for k, v in ivf.build_seconds.items())
    print(f"ivf (served catalogue): {n} items at D={ivf.buckets.shape[2]}, "
          f"{ivf.num_clusters} clusters, bucket {ivf.bucket_size}, fill "
          f"{ivf.fill:.4f}, radii p50 / max "
          f"{ivf.radii.median().item():.4f} / {ivf.radii.max().item():.4f}; "
          f"engine load with the IVF build {build_s:.2f} s host wall "
          f"({split}; the cache write, the recall probe and the warm-up "
          f"the rest); probe recall@10 at nprobe {ivf.nprobe} "
          f"{first.ivf_probe_recall:.4f} [{card}]")
    assign, buckets = ivf._assign, ivf.buckets
    del first, ivf
    t0 = time.perf_counter()
    engine = RecommenderEngine(root, index_kind="ivf", ivf_certified=True,
                               device=dev)
    restart_s = time.perf_counter() - t0
    check(engine.ivf_cache_hit, "the restart did not load the cached IVF")
    check(np.array_equal(engine.ivf._assign, assign)
          and torch.equal(engine.ivf.buckets, buckets),
          "the cached IVF differs from the build")
    del buckets
    print(f"ivf restart on the cache: {restart_s:.2f} s host wall (sha256 "
          f"of index/corpus.npz, ivf.npz, the layout, the recall probe) "
          f"[{card}]")
    try:
        engine.add_items([ItemQuery(movie_rn=0, movie_id=n + 7,
                                    movie_text="new")])
        refused = False
    except RuntimeError:
        refused = True
    check(refused, "add_items answered under index_kind='ivf'")
    for name, count_ in kernels.launch_counts().items():
        launches[name] += count_

    exact = RecommenderEngine(root, device=dev)
    rng = np.random.default_rng(SEED + 11)
    requests = []
    for item_id in rng.integers(1, n + 1, size=IVF_REQUESTS):
        excl = [int(x) for x in rng.integers(1, n + 1, size=3)]
        requests.append((int(item_id), excl))
    servers = []
    try:
        bases = []
        for eng in (engine, exact):
            server = make_server(RecService(eng), port=0)
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            servers.append((server, thread))
            bases.append(f"http://127.0.0.1:{server.server_address[1]}")
        rows_before = dict(engine.ivf_rows)
        kernels.reset_launch_counts()
        ivf_bodies, ivf_lat = timed_requests(bases[0], requests)
        fallback_launches = kernels.launch_counts()
        rows = {k: engine.ivf_rows[k] - rows_before[k] for k in rows_before}
        exact_bodies, exact_lat = timed_requests(bases[1], requests)
    finally:
        for server, thread in servers:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    for name, count_ in fallback_launches.items():
        launches[name] += count_
    check(sum(rows.values()) == IVF_REQUESTS, f"ivf rows counted {rows}")
    check(fallback_launches["packed_scan"] == rows["fallback"],
          f"{rows['fallback']} fallback rows launched packed_scan "
          f"{fallback_launches['packed_scan']} times")
    corpus = engine.index.corpus.float()
    same_as_exact = certified_rows = 0
    for (item_id, excl), got, want in zip(requests, ivf_bodies, exact_bodies,
                                          strict=True):
        got_ids = [c["movie_id"] for c in got]
        want_ids = [c["movie_id"] for c in want]
        excl_all = [*excl, item_id]
        check(not set(excl_all) & set(got_ids), "ivf: an excluded id came back")
        q = engine.embed([texts[item_id - 1]])
        _, _, exact_flag = engine.ivf.search_certified(
            q, top_k=20, exclude_ids=[excl_all])
        if exact_flag[0]:
            certified_rows += 1
            dense = (torch.from_numpy(q).to(dev).bfloat16().float()
                     @ corpus.T)[0]
            dense[torch.tensor([i - 1 for i in excl_all], device=dev)] = (
                -math.inf)
            held_to_dense_top_k(dense, np.asarray(got_ids) - 1,
                                np.asarray([c["score"] for c in got],
                                           np.float32), 20,
                                f"ivf certified row (item {item_id})")
        else:
            check(got_ids == want_ids, f"ivf fallback row (item {item_id}) "
                  "differs from the exact engine's answer")
        same_as_exact += got_ids == want_ids
    check(certified_rows == rows["certified"],
          "the certified rows re-probed differ from the served ones")
    ivf_lat.sort()
    exact_lat.sort()
    print(f"ivf serving: {IVF_REQUESTS} sequential recommend_with_item_id "
          f"requests (top-20, 3 random exclusions and the item itself) over "
          f"HTTP: ivf_certified p50 {ivf_lat[len(ivf_lat) // 2]:.3f} ms, max "
          f"{ivf_lat[-1]:.3f} ms; the exact engine p50 "
          f"{exact_lat[len(exact_lat) // 2]:.3f} ms, max {exact_lat[-1]:.3f} "
          f"ms; certified {rows['certified']} of {IVF_REQUESTS} (share "
          f"{rows['certified'] / IVF_REQUESTS:.4f}), each == dense top-20 "
          f"over the served rows; {rows['fallback']} fallback rows answered "
          f"by the exact index (packed_scan launched "
          f"{fallback_launches['packed_scan']} times), each == the exact "
          f"engine's answer; {same_as_exact} of {IVF_REQUESTS} answers "
          f"id-for-id equal to the exact engine's; add_items refused "
          f"[{card}]")
    return {"launches": launches}


def check_portable(root: pathlib.Path, texts: list[str], dev,
                   card: str) -> None:
    """`PortableEncoder.embed` (numpy) on served texts against the card's
    encoder of the same artifact run in f32."""
    from xfmr_rec_torch.models.convert import build_encoder, load_portable
    from xfmr_rec_torch.serving.portable import PortableEncoder

    sample = texts[:PORTABLE_TEXTS]
    t0 = time.perf_counter()
    got = PortableEncoder.load(root).embed(sample)
    numpy_s = time.perf_counter() - t0
    config, _, state = load_portable(root)
    encoder = build_encoder(
        dataclasses.replace(config, compute_dtype="float32"), state, dev)
    tokens = HashingTokenizer(TokenizerConfig(
        vocab_size=30522, max_length=ENCODER["max_length"])
    ).encode_batch(sample)
    want = encoder(torch.from_numpy(tokens).to(dev)).cpu().numpy()
    err = float(np.abs(got - want).max())
    check(got.shape == want.shape and err <= PORTABLE_TOL,
          f"PortableEncoder differs from the card's f32 encoder by {err}")
    print(f"portable encoder: PortableEncoder.embed (numpy, f32) of "
          f"{PORTABLE_TEXTS} served texts in {numpy_s:.3f} s host wall; max "
          f"abs difference from the card's encoder at f32 {err:.2e} "
          f"(tolerance {PORTABLE_TOL:.0e}) [{card}]")


def packed_rows_off_quantum(index, queries, positions, tight, what,
                            rows_held=None) -> int:
    """Hold packed-order answers against dense exact top-k on the card.

    A row is exact in the packed order when every returned item scores
    within one key quantum (`tight`, scaled units) of the dense k-th
    score or above, and every item more than a quantum above it is
    returned. Rows that fail that (the ones a dense fallback answered)
    must be exact in the unscaled bf16 order instead. Returns how many
    rows took the second test; `rows_held` (bool per row) limits the
    check to some rows.
    """
    return rows_off_quantum(index.corpus.float(), index._corpus_maxnorm,
                            queries, positions, tight, what, rows_held)


def rows_off_quantum(corpus_f, maxnorm, queries, positions, tight, what,
                     rows_held=None, bound=None) -> int:
    """`packed_rows_off_quantum` over the (N, D) f32 corpus `corpus_f`
    (the stored rows, dequantized) whose largest row norm is `maxnorm`;
    `bound` is the search's own score bound where it is not the single
    card's host one."""
    dev = corpus_f.device
    if bound is None:
        qnorm = float(np.linalg.norm(queries, axis=-1).max())
        bound = torch.tensor(np.float32(max(maxnorm * qnorm * 1.05, 1e-6)),
                             device=dev)
    q_bf = torch.from_numpy(queries).to(dev, torch.bfloat16)
    scale = 0.25 / bound
    q_s = (q_bf.float() * scale).bfloat16().float()
    pos_all = torch.as_tensor(positions).to(dev, torch.int64)
    held = (torch.ones(len(queries), dtype=torch.bool, device=dev)
            if rows_held is None else rows_held.to(dev))
    off_quantum = 0
    for start in range(0, len(queries), 512):
        rows = slice(start, start + 512)
        dense = q_s[rows] @ corpus_f.T
        kth = torch.topk(dense, BENCH_K, dim=1).values[:, -1:]
        got = torch.gather(dense, 1, pos_all[rows])
        ok = (got >= kth - tight).all(1) & (
            (got > kth + tight).sum(1) == (dense > kth + tight).sum(1)
        )
        ok |= ~held[rows]
        if not bool(ok.all()):
            plain = q_bf[rows].float() @ corpus_f.T
            kth_p = torch.topk(plain, BENCH_K, dim=1).values[:, -1:]
            got_p = torch.gather(plain, 1, pos_all[rows])
            ok_p = (got_p >= kth_p - 1e-6).all(1)
            check(bool((ok | ok_p).all()), f"{what} not exact")
            off_quantum += int((~ok).sum())
    return off_quantum


# ---------------------------------------------------------------------------
# phase 5: guaranteed-exact search
# ---------------------------------------------------------------------------
def phase_guaranteed(dev, card: str) -> dict:
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    corpus = torch.nn.functional.normalize(
        torch.randn(BENCH_ITEMS, BENCH_DIM, device=dev, generator=g), dim=1
    )
    index = RetrievalIndex(corpus, np.arange(BENCH_ITEMS), method="scan",
                           device=dev)
    corpus_bf = index.corpus
    batches = [
        torch.nn.functional.normalize(
            torch.randn(BENCH_BATCH, BENCH_DIM, device=dev, generator=g),
            dim=1,
        ).cpu().numpy()
        for _ in range(5)
    ]
    index.search_certified(batches[0], top_k=BENCH_K, method="fused")  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times, pipeline_bad, results = [], 0, []
    for queries in batches[1:]:
        t0 = time.perf_counter()
        scores, ids = index.search_certified(queries, top_k=BENCH_K,
                                             method="fused")
        times.append(time.perf_counter() - t0)
        pipeline_bad += index.last_certified_stats["pipeline_bad"]
        results.append((queries, scores, ids))
    launches = kernels.launch_counts()
    ms = 1e3 * sum(times) / len(times)
    qps = BENCH_BATCH / (ms / 1e3)
    certified_frac = 1 - pipeline_bad / (BENCH_BATCH * len(times))

    # dense exact check at the packed order's resolution
    tight = quantum_scaled(index_quantum_bits(index)) + 1e-6
    fallback_rows = 0
    for queries, scores, ids in results:
        check(bool(np.isfinite(scores).all()), "non-finite scores")
        check(bool((np.diff(scores, axis=1) <= 1e-6).all()),
              "scores not descending")
        fallback_rows += packed_rows_off_quantum(index, queries, ids, tight,
                                                 "guaranteed search")
    check(fallback_rows <= pipeline_bad,
          "rows outside quantum semantics exceed the dense-fallback rows")
    print(f"guaranteed: 4 batches x B={BENCH_BATCH} over {BENCH_ITEMS} x "
          f"{BENCH_DIM} bf16, k={BENCH_K}: all rows == dense exact top-k "
          f"(one key quantum, {tight:.2e} scaled); certified_frac "
          f"{certified_frac:.6f}, pipeline_bad {pipeline_bad}; "
          f"{ms:.3f} ms per batch, {qps:.0f} qps (host wall) [{card}]")
    print(f"guaranteed path kernel launches: {launches}")
    check(launches["packed_scan"] > 0 and launches["threshold_select"] > 0,
          "guaranteed path missed a kernel")

    qf = torch.from_numpy(batches[1]).to(dev).float()
    corpus_f = corpus_bf.float()

    def library():
        return torch.topk(torch.matmul(qf, corpus_f.T), BENCH_K, dim=1)

    library_ms = cuda_ms(library, iters=3)
    print(f"library yardstick torch.matmul + torch.topk over ({BENCH_BATCH}, "
          f"{BENCH_ITEMS}) f32 scores: {library_ms:.3f} ms [{card}]")
    return {"launches": launches, "ms": ms, "qps": qps,
            "certified_frac": certified_frac, "pipeline_bad": pipeline_bad,
            "library_ms": library_ms, "corpus": corpus_bf, "index": index,
            "batch": batches[1], "warm": batches[0],
            "queries": torch.from_numpy(batches[1]).to(dev, torch.bfloat16)}


def phase_profile(guaranteed: dict, card: str, method: str) -> None:
    """Device time by kernel for one certified batch of `method` and the
    device's idle share of that batch's wall time (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        guaranteed["index"].search_certified(
            guaranteed["batch"], top_k=BENCH_K, method=method
        )
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((evt.self_device_time_total / 1e3, evt.count, evt.key)
         for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA and evt.self_device_time_total),
        reverse=True,
    )
    if not rows:
        print("profile: torch.profiler recorded no device time on this card")
        return
    busy_ms = sum(row[0] for row in rows)
    print(f"profile of one {method!r} batch (profiler on): wall {wall_ms:.3f} "
          f"ms, device busy {busy_ms:.3f} ms, device idle share "
          f"{1 - busy_ms / wall_ms:.4f} [{card}]")
    for dev_ms, count, name in rows[:8]:
        print(f"  {dev_ms:9.3f} ms  x{count:<4d} {name[:100]}")


# ---------------------------------------------------------------------------
# phase 6: the lane-max scan, count and fused scan-select kernels vs plain
# ---------------------------------------------------------------------------
def scores_at(q, c, positions) -> torch.Tensor:
    """f32 dots of each query row with the corpus rows at its positions,
    in row chunks so the gathered rows stay small."""
    out = [
        topk.exact_scores_at(q[s : s + 256], c, positions[s : s + 256])
        for s in range(0, q.shape[0], 256)
    ]
    return torch.cat(out)


def phase_lane_scan(dev, q, c) -> dict:
    gen = torch.Generator().manual_seed(SEED + 5)
    on = dict(track_discards=True)
    cases = [
        ("slots1", dict(slots=1, **on)),
        ("slots2", dict(slots=2, **on)),
        ("slots1_no_discards", dict(slots=1)),
        ("slots2_no_discards", dict(slots=2)),
        ("slots1_shuffle1", dict(slots=1, lane_shuffle=1, **on)),
        ("slots2_shuffle3", dict(slots=2, lane_shuffle=3, **on)),
        ("slots2_shuffle1_padding",
         dict(slots=2, lane_shuffle=1, true_num_items=60000, **on)),
        ("slots1_padding", dict(slots=1, true_num_items=60000, **on)),
        ("slots2_int8_scales", dict(slots=2, int8=True, **on)),
        ("slots1_int8_scales_shuffle3",
         dict(slots=1, int8=True, lane_shuffle=3, **on)),
        ("slots2_f32_inputs", dict(slots=2, f32=True, **on)),
        ("slots1_f32_inputs_shuffle1",
         dict(slots=1, f32=True, lane_shuffle=1, **on)),
    ]
    for name, opts in cases:
        opts = dict(opts)
        qd, cd, sd, _ = exact_tensors(
            gen, dev, int8=opts.pop("int8", False), f32=opts.pop("f32", False)
        )
        kw = dict(corpus_tile=2048, **opts)
        got = kernels.lane_max_scan(qd, cd, sd, **kw)
        want = topk_f32.lane_max_scan_plain(qd, cd, sd, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"lane scan values differ ({name})")
        check(torch.equal(got[1], want[1]),
              f"lane scan positions differ ({name})")
        if opts.get("track_discards"):
            check(torch.equal(got[2], want[2]),
                  f"lane scan dmax differs ({name})")
        else:
            check(got[2] is None, f"dmax returned untracked ({name})")
        print(f"lane scan exact case {name}: values, positions and dmax "
              "bit-identical (B=500, N=65536, D=64)")

    # random unit vectors at the retrieval geometry
    kw = dict(corpus_tile=2048, slots=2, track_discards=True)
    got_v, got_p, got_d = kernels.lane_max_scan(q, c, None, **kw)
    want_v, want_p, want_d = topk_f32.lane_max_scan_plain(q, c, None, **kw)
    # scores of unit vectors are at most 1, so 1e-5 relative to the score
    # scale; f32 sums of 64 products in another order differ by at most
    # 2 * 64 * 2^-24 = 7.6e-6
    tol = 1e-5
    err = (got_v - want_v).abs().max().item()
    err_d = (got_d - want_d).abs().max().item()
    same_pos = (got_p == want_p).float().mean().item()
    # every position must carry the value reported for it, so a position
    # that differs from the plain version's holds a score within 2 * tol
    err_p = (scores_at(q, c, got_p) - got_v).abs().max().item()
    print(f"lane scan random B={q.shape[0]} N={c.shape[0]} D={c.shape[1]} "
          f"slots=2: values max_abs_err {err:.3e}, dmax {err_d:.3e}, value "
          f"at each reported position {err_p:.3e} (tolerance {tol:.0e}: f32 "
          f"reassociation of 64 terms); {same_pos:.6f} of positions "
          "identical")
    check(max(err, err_d, err_p) <= tol, "lane scan random-input error")
    check_lane_splits(dev, q, c, got_v, got_p, got_d)
    return {"max_abs_err": max(err, err_d), "vals": got_v, "dmax": got_d}


def tied_corpus(gen, num_items, dim, distinct=3) -> torch.Tensor:
    """Every corpus row one of `distinct` rows of values k/16: each lane
    sees the same few scores again and again over its tiles, so the
    strict-`>` rule and the history it keeps decide most slots."""
    pool = torch.randint(-8, 9, (distinct, dim), generator=gen).float() / 16
    return pool[torch.randint(0, distinct, (num_items,), generator=gen)]


def check_lane_splits(dev, q, c, full_v, full_p, full_d) -> None:
    """The lane-max scan with its corpus tiles split over blocks: the
    split merges in tile order and must give the unsplit slots, ties
    included, whatever the splits and whichever block arrives last."""
    kw = dict(corpus_tile=2048, slots=2, track_discards=True)
    rows = 128  # the width `_host_escalation` pads its retries to
    q_rows = q[:rows].contiguous()
    num_tiles = c.shape[0] // 2048
    chosen = kernels.lane_max_scan_splits(q_rows, c, **kw)
    check(chosen > 1, "a 128-row lane scan was not split over blocks")
    runs = {
        "the unsplit B=4096 launch": (full_v[:rows], full_p[:rows],
                                      full_d[:rows]),
        "one split": kernels.lane_max_scan(q_rows, c, None, splits=1, **kw),
        f"the wrapper's {chosen} splits": kernels.lane_max_scan(
            q_rows, c, None, **kw),
        "a second run": kernels.lane_max_scan(q_rows, c, None, **kw),
    }
    for forced in (2, 7, num_tiles):
        runs[f"{forced} forced splits"] = kernels.lane_max_scan(
            q_rows, c, None, splits=forced, **kw)
    torch.cuda.synchronize()
    base = runs["one split"]
    for what, run in runs.items():
        check(all(torch.equal(x, y) for x, y in zip(base, run, strict=True)),
              f"split lane scan differs from {what}")
    print(f"lane scan random B={rows} (the retry width): values, positions "
          f"and dmax torch.equal across 1, {chosen} (the wrapper's), 2, 7 "
          f"and {num_tiles} (one tile a split) splits, run to run, and to "
          "the same rows of the unsplit B=4096 launch")

    gen = torch.Generator().manual_seed(SEED + 9)
    qt = (torch.randint(-8, 9, (rows, 64), generator=gen).float() / 16).to(
        dev, torch.bfloat16)
    ct = tied_corpus(gen, 1 << 16, 64).to(dev, torch.bfloat16)
    kw = dict(kw, lane_shuffle=1)
    want = topk_f32.lane_max_scan_plain(qt, ct, None, **kw)
    tiles = ct.shape[0] // 2048
    for splits in (1, 2, 7, tiles, None):
        got = kernels.lane_max_scan(qt, ct, None, splits=splits, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want, strict=True)),
              f"tied lane scan differs from plain at splits={splits}")
    tied = (want[0][:, :2048] == want[0][:, 2048:]).float().mean().item()
    print(f"lane scan tie case B={rows} N=65536 (3 distinct corpus rows, "
          f"{tied:.3f} of lanes hold two equal scores): values, positions "
          f"and dmax bit-identical to plain at 1, 2, 7, {tiles} and the "
          "wrapper's splits")


def phase_count(dev, q, c, lane: dict) -> dict:
    gen = torch.Generator().manual_seed(SEED + 6)
    for name, f32, true_n in (("base", False, None),
                              ("padding", False, 60000),
                              ("f32_inputs", True, None)):
        qd, cd, _, _ = exact_tensors(gen, dev, f32=f32)
        vals, _, _ = kernels.lane_max_scan(qd, cd, None, corpus_tile=2048,
                                           slots=2, true_num_items=true_n)
        # thresholds that are scores: every tie counts
        tau = topk.topk_stable(vals, BENCH_K)[0][:, -1].contiguous()
        kw = dict(corpus_tile=2048, true_num_items=true_n)
        got = kernels.count_at_least(qd, cd, tau, **kw)
        want = topk_f32.count_at_least_plain(qd, cd, tau, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"counts differ ({name})")
        check(bool((got >= BENCH_K).all()), f"count below k ({name})")
        print(f"count exact case {name}: counts identical (B=500, N=65536, "
              f"D=64, tau = {BENCH_K}th lane score)")

    # tau from the scan kernel on the random inputs: tau's own item must
    # count, so a certified row with no tie at tau counts exactly k
    top = topk.topk_stable(lane["vals"], BENCH_K + 1)[0]
    tau = top[:, BENCH_K - 1].contiguous()
    kw = dict(corpus_tile=2048)
    got = kernels.count_at_least(q, c, tau, **kw)
    want = topk_f32.count_at_least_plain(q, c, tau, **kw)
    # the plain version sums its dots in another order: a score within
    # 1e-5 of tau may fall on either side, so the counts may differ by at
    # most the number of scores in that band (counted by the kernel)
    band = (kernels.count_at_least(q, c, tau - 1e-5, **kw)
            - kernels.count_at_least(q, c, tau + 1e-5, **kw))
    diff = (got - want).abs()
    check(bool((diff <= band).all()), "count differs from plain beyond ties")
    check(bool((got >= BENCH_K).all()), "tau's own items were not counted")
    sure = (lane["dmax"] < tau) & (top[:, BENCH_K] < tau)
    check(bool((got[sure] == BENCH_K).all()),
          "certified rows without a tie did not count k")
    print(f"count random B={q.shape[0]} N={c.shape[0]}: tau from the lane "
          f"scan kernel; counts == {BENCH_K} on all {int(sure.sum())} rows "
          f"that the discard certificate proves and that have no tie at tau, "
          f">= {BENCH_K} on all rows; vs plain: {int((diff > 0).sum())} rows "
          f"differ, max by {int(diff.max())}, each within its tie band")
    return {"max_abs_err": float(diff.max()), "tau": tau}


def phase_fused_select(dev, q, c) -> dict:
    gen = torch.Generator().manual_seed(SEED + 7)
    cases = [
        ("keep2_level0", dict(merge_levels=0)),
        ("keep2_level1", dict(merge_levels=1)),
        ("keep2_level2", dict(merge_levels=2)),
        ("keep3", dict(merge_levels=1, merge_keep=3)),
        ("keep3_shuffle3", dict(merge_levels=1, merge_keep=3, lane_shuffle=3)),
        ("keep3_int8_scales", dict(merge_levels=1, merge_keep=3, int8=True)),
        ("keep3_padding_shuffle1",
         dict(merge_levels=1, merge_keep=3, true_num_items=60000,
              lane_shuffle=1)),
        ("keep3_bias_in_dot",
         dict(merge_levels=1, merge_keep=3, bias_in_dot=True)),
        # small batches: the corpus tiles split over blocks, merged in
        # the tail of the same launch
        ("keep3_batch64_shuffle3",
         dict(merge_levels=1, merge_keep=3, batch=64, lane_shuffle=3)),
        ("keep3_batch8_int8_scales",
         dict(merge_levels=1, merge_keep=3, batch=8, int8=True)),
        ("keep2_level1_batch8", dict(merge_levels=1, batch=8)),
        ("keep3_forced_splits5_padding",
         dict(merge_levels=1, merge_keep=3, splits=5, true_num_items=60000)),
    ]

    def both(qd, cd, sd, bound, opts):
        opts = dict(opts)
        splits = opts.pop("splits", None)
        levels = opts["merge_levels"]
        q_s, s_s, geom = topk.prepare_packed_scan(
            qd, cd, score_bound=bound, batch_tile=qd.shape[0],
            corpus_tile=2048, reserve_bits=levels, scales=sd,
            **{k: v for k, v in opts.items() if k not in
               ("merge_levels", "merge_keep")},
        )
        del geom["track_discards"], geom["reserve_bits"]
        kw = dict(merge_levels=levels, merge_keep=opts.get("merge_keep", 2),
                  capacity=128, **geom)
        before = kernels.launch_counts()
        got = kernels.packed_scan_select(q_s, cd, s_s, BENCH_K, splits=splits,
                                         **kw)
        after = kernels.launch_counts()
        check(after["packed_scan_select"] == before["packed_scan_select"] + 1
              and after["packed_scan"] == before["packed_scan"]
              and after["threshold_select"] == before["threshold_select"],
              "the fused kernel is not exactly one launch")
        want = topk.packed_lane_scan_select_plain(q_s, cd, s_s, BENCH_K, **kw)
        torch.cuda.synchronize()
        return got, want, q_s, geom, kw

    for name, opts in cases:
        opts = dict(opts)
        batch = opts.pop("batch", 500)
        qd, cd, sd, bound = exact_tensors(
            gen, dev, int8=opts.pop("int8", False),
            bias=opts.get("bias_in_dot", False), batch=batch,
        )
        got, want, q_s, _, kw = both(qd, cd, sd, bound, opts)
        chosen = opts.get("splits") or kernels.packed_scan_select_splits(
            q_s, cd, BENCH_K, **kw)
        for part, g, w in zip(("keys", "lanes (meta)", "dmax"), got, want,
                              strict=True):
            check(torch.equal(g, w), f"fused select {part} differ ({name})")
        check(chosen > 1 or batch == 500,
              f"unexpected corpus splits {chosen} ({name})")
        print(f"fused select exact case {name}: keys, lanes and dmax "
              f"bit-identical (B={batch}, N=65536, D={cd.shape[1]}, "
              f"k={BENCH_K}, corpus splits {chosen})")

    # random unit vectors at the retrieval geometry, the index's own
    # configuration (keep-3, one merge level)
    opts = dict(merge_levels=1, merge_keep=3)
    got, want, q_s, geom, kw = both(q, c, None, 1.05, opts)
    check(kernels.packed_scan_select_splits(q_s, c, BENCH_K, **kw) == 1,
          "the fused kernel split the full batch over blocks")
    qbits = geom["idx_bits"] + 1
    decode = dict(idx_bits=geom["idx_bits"], reserve_bits=1, score_bound=1.05)

    def top_scores(keys):
        return topk.decode_scores(topk.topk_stable(keys, BENCH_K)[0], **decode)

    err = (top_scores(got[0]) - top_scores(want[0])).abs().max().item()
    err_d = (topk.decode_scores(got[2], **decode)
             - topk.decode_scores(want[2], **decode)).abs().max().item()
    tol = quantum_scaled(qbits) * 1.05 / 0.25 + 64 * 2.0**-24 * 4
    raw_same = all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    # the two-kernel path on the same inputs runs the same sweep and the
    # same select: identical outputs, whatever the order of the dots; and
    # the plain select over that sweep's merged pool gives them too
    keys, dmax = kernels.packed_scan(q_s, c, None, reserve_bits=1, **geom)
    pool, dmax = topk._merge_slots(keys, dmax, 1, 3)
    sel = dict(capacity=128, quantum_bits=qbits, shared_exponent=True)
    two = kernels.threshold_select(pool.contiguous(), BENCH_K, **sel)
    plain_sel = topk.select_topk_keys_plain(pool, BENCH_K, **sel)
    torch.cuda.synchronize()
    check(torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])
          and torch.equal(got[2], dmax),
          "fused kernel differs from the two-kernel path")
    check(torch.equal(got[0], plain_sel[0])
          and torch.equal(got[1], plain_sel[1]),
          "fused kernel's select differs from the plain select of its pool")
    print(f"fused select random B={q.shape[0]} N={c.shape[0]} keep-3: top-"
          f"{BENCH_K} decoded scores max_abs_err {err:.3e} (dmax {err_d:.3e}) "
          f"vs plain, tolerance {tol:.3e} (one key quantum + f32 "
          f"reassociation); raw outputs identical to the plain scan + merge "
          f"+ select: {raw_same}; raw keys and meta torch.equal to "
          "packed_scan + merge + threshold_select and to the plain select "
          "of that merged pool")
    check(max(err, err_d) <= tol, "fused select random-input error")

    # with the corpus split over blocks the fused kernel counts arrivals
    # twice and merges the splits in place before its tail: two runs, and
    # a forced split, equal the same rows of the unsplit launch
    q_rows = q_s[:256].contiguous()
    chosen = kernels.packed_scan_select_splits(q_rows, c, BENCH_K, **kw)
    check(chosen > 1, "a 256-row fused sweep was not split over blocks")
    runs = {
        "the wrapper's splits": kernels.packed_scan_select(
            q_rows, c, None, BENCH_K, **kw),
        "a second run": kernels.packed_scan_select(
            q_rows, c, None, BENCH_K, **kw),
        "37 forced splits": kernels.packed_scan_select(
            q_rows, c, None, BENCH_K, splits=37, **kw),
    }
    torch.cuda.synchronize()
    for what, run in runs.items():
        check(all(torch.equal(r, g[:256]) for r, g in zip(run, got, strict=True)),
              f"split fused sweep ({what}) differs from the unsplit launch")
    print(f"fused select random B=256 with the corpus split {chosen} ways "
          "over blocks: keys, lanes and dmax torch.equal run to run, to 37 "
          "forced splits and to the same rows of the unsplit B=4096 launch")
    return {"max_abs_err": max(err, err_d)}


# ---------------------------------------------------------------------------
# phase 7: the other certified paths at full width
# ---------------------------------------------------------------------------
def phase_certified(dev, card: str, guaranteed: dict) -> dict:
    index = guaranteed["index"]
    queries = guaranteed["batch"]
    q_bf = guaranteed["queries"]
    corpus_f = index.corpus.float()
    tight = quantum_scaled(index_quantum_bits(index)) + 1e-6
    total = dict.fromkeys(kernels.LAUNCHES, 0)

    def drive(what, fn, needs, never=()):
        """Run one path with the counts at 0 before and read after."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        for name in needs:
            check(counts[name] > 0, f"{what} never launched {name}")
        for name in never:
            check(counts[name] == 0, f"{what} launched {name}")
        for name, count in counts.items():
            total[name] += count
        used = {k: v for k, v in counts.items() if v}
        return out, ms, used

    # (a) search_certified(method="f32"): the default method
    drive("f32 warm-up", lambda: index.search_certified(
        guaranteed["warm"], top_k=BENCH_K), ["lane_max_scan"])
    (scores, ids), f32_ms, used = drive(
        "search_certified f32",
        lambda: index.search_certified(queries, top_k=BENCH_K),
        ["lane_max_scan"], never=["packed_scan", "packed_scan_select"],
    )
    stats = dict(index.last_certified_stats)
    check(scores.shape == ids.shape == (BENCH_BATCH, BENCH_K), "f32 shape")
    check(bool(np.isfinite(scores).all()), "f32: non-finite scores")
    got_s = torch.from_numpy(scores).to(dev)
    pos = torch.from_numpy(ids.astype(np.int64)).to(dev)
    worst = 0.0
    for start in range(0, BENCH_BATCH, 512):
        rows = slice(start, start + 512)
        dense = q_bf[rows].float() @ corpus_f.T
        exact = torch.topk(dense, BENCH_K, dim=1).values
        worst = max(
            worst,
            (got_s[rows] - exact).abs().max().item(),
            (torch.gather(dense, 1, pos[rows]) - got_s[rows]).abs().max().item(),
        )
        check(bool((torch.sort(pos[rows], dim=1).values.diff(dim=1) > 0).all()),
              "f32: duplicate ids in a row")
    check(worst <= 1e-5, f"f32 certified search not exact ({worst:.3e})")
    f32_qps = BENCH_BATCH / (f32_ms / 1e3)
    print(f"certified f32: B={BENCH_BATCH} over {BENCH_ITEMS} x {BENCH_DIM} "
          f"bf16, k={BENCH_K}: every row's scores == dense exact top-k and "
          f"each id carries its score (max_abs_err {worst:.3e} <= 1e-5); "
          f"stats {stats}; {f32_ms:.3f} ms, {f32_qps:.0f} qps (host wall); "
          f"launches {used} [{card}]")

    # (b) search_certified(method="packed")
    drive("packed warm-up", lambda: index.search_certified(
        guaranteed["warm"], top_k=BENCH_K, method="packed"), ["packed_scan"])
    (scores, ids), packed_ms, used = drive(
        "search_certified packed",
        lambda: index.search_certified(queries, top_k=BENCH_K,
                                       method="packed"),
        ["packed_scan", "threshold_select"],
        never=["lane_max_scan", "packed_scan_select"],
    )
    stats = dict(index.last_certified_stats)
    check(bool(np.isfinite(scores).all()), "packed: non-finite scores")
    off = packed_rows_off_quantum(index, queries, ids, tight,
                                  "packed certified search")
    check(off <= stats["retry_bad"], "packed: rows off the key quantum "
          "exceed the dense-fallback rows")
    print(f"certified packed: every row == dense exact top-k (one key "
          f"quantum, {tight:.2e} scaled); stats {stats}; {packed_ms:.3f} ms, "
          f"{BENCH_BATCH / (packed_ms / 1e3):.0f} qps (host wall); launches "
          f"{used} [{card}]")

    # (c) the fused selector, on the index's padded corpus and geometry
    corpus_p, scales_p, tile, true_n = index._scan_setup()

    def fused():
        return topk.packed_guaranteed_topk(
            q_bf, corpus_p, BENCH_K, score_bound=index._score_bound(queries),
            batch_tile=512, corpus_tile=tile, merge_levels=1, merge_keep=3,
            true_num_items=true_n, scales=scales_p, retries=3,
            selector="fused",
        )

    drive("fused selector warm-up", fused, ["packed_scan_select"])
    (scores_t, pos_t, exact_t), fused_ms, used = drive(
        "packed_guaranteed_topk fused", fused, ["packed_scan_select"],
        never=["packed_scan", "threshold_select", "lane_max_scan"],
    )
    check(bool(torch.isfinite(scores_t).all()), "fused: non-finite scores")
    off = packed_rows_off_quantum(index, queries, pos_t, tight,
                                  "fused selector", rows_held=exact_t)
    check(off == 0, "fused selector: a certified row is off the key quantum")
    print(f"fused selector: packed_guaranteed_topk(selector='fused') "
          f"certified {int(exact_t.sum())} of {BENCH_BATCH} rows, each == "
          f"dense exact top-k (one key quantum); {fused_ms:.3f} ms (host "
          f"wall, results left on the card); launches {used} [{card}]")

    # (d) the discard and the count certificate on one batch
    kw = dict(corpus_tile=tile, true_num_items=true_n)
    (_, _, by_discard), _, _ = drive(
        "certified_topk discard",
        lambda: topk_f32.certified_topk(q_bf, corpus_p, BENCH_K,
                                        method="discard", **kw),
        ["lane_max_scan"], never=["count_at_least"],
    )
    (vals, _, by_count), count_ms, used = drive(
        "certified_topk count",
        lambda: topk_f32.certified_topk(q_bf, corpus_p, BENCH_K,
                                        method="count", **kw),
        ["lane_max_scan", "count_at_least"],
    )
    tau = vals[:, BENCH_K - 1].contiguous()
    above = torch.nextafter(tau, torch.full_like(tau, math.inf))
    at_tau = (kernels.count_at_least(q_bf, corpus_p, tau, **kw)
              - kernels.count_at_least(q_bf, corpus_p, above, **kw))
    no_tie = at_tau == 1
    check(bool((by_discard == by_count)[no_tie].all()),
          "discard and count certificates disagree on a row without a tie")
    print(f"certificates: discard certifies {int(by_discard.sum())} rows, "
          f"count {int(by_count.sum())}; equal on all {int(no_tie.sum())} "
          f"rows without a tie at the k-th score ({int((~no_tie).sum())} "
          f"rows tie); count method {count_ms:.3f} ms; launches {used} "
          f"[{card}]")

    # (e) exclusion search on an index with scan_kernel="f32"
    index32 = RetrievalIndex(index.corpus, np.arange(BENCH_ITEMS),
                             method="scan", scan_kernel="f32", device=dev)
    rng = np.random.default_rng(SEED + 8)
    excl = rng.integers(0, BENCH_ITEMS, size=(8, 5))
    (scores, ids), search_ms, used = drive(
        "f32 scan search",
        lambda: index32.search(queries[:8], top_k=BENCH_K,
                               exclude_ids=excl.tolist()),
        ["lane_max_scan"], never=["packed_scan"],
    )
    # the scan keeps the top-2 of every lane (column mod the tile) before
    # the exclusions are dropped: the answer is the top-k of those
    dense = q_bf[:8].float() @ corpus_f.T
    lanes = dense.view(8, BENCH_ITEMS // tile, tile)
    top2, tiles = torch.topk(lanes, 2, dim=1)
    positions = tiles * tile + torch.arange(tile, device=dev)
    top2, positions = top2.reshape(8, -1), positions.reshape(8, -1)
    hit = (positions[:, :, None] == torch.from_numpy(excl).to(dev)[:, None, :])
    want = torch.topk(torch.where(hit.any(-1), -math.inf, top2), BENCH_K,
                      dim=1).values
    got_s = torch.from_numpy(scores).to(dev)
    pos = torch.from_numpy(ids.astype(np.int64)).to(dev)
    err = max((got_s - want).abs().max().item(),
              (torch.gather(dense, 1, pos) - got_s).abs().max().item())
    check(err <= 1e-5, f"f32 scan search differs from dense ({err:.3e})")
    for row in range(8):
        check(not set(excl[row].tolist()) & set(ids[row].tolist()),
              "f32 scan search: an excluded id came back")
        check(len(set(ids[row].tolist())) == BENCH_K, "f32 scan: duplicates")
    masked = dense.scatter(1, torch.from_numpy(excl).to(dev), -math.inf)
    true_top = torch.topk(masked, BENCH_K, dim=1).indices
    recall = np.mean([
        len(set(true_top[row].tolist()) & set(ids[row].tolist())) / BENCH_K
        for row in range(8)
    ])
    print(f"f32 scan search: 8 queries x top-{BENCH_K} with exclusions == "
          f"dense top-k of the top-2-per-lane survivors (max_abs_err "
          f"{err:.3e} <= 1e-5); recall@{BENCH_K} vs unrestricted dense "
          f"{recall:.4f}; {search_ms:.2f} ms host wall; launches {used} "
          f"[{card}]")
    print(f"certified paths kernel launches: {total}")
    return {"launches": total, "f32_ms": f32_ms, "packed_ms": packed_ms,
            "fused_ms": fused_ms, "tau": tau}


# ---------------------------------------------------------------------------
# kernel timings and bounds at the main path's shapes
# ---------------------------------------------------------------------------
def bound_of(bytes_ms: float, *ops_ms: float) -> dict:
    """The least time for the work: the larger of the byte time and the
    operation times, and which of the two kinds it is."""
    bound = max(bytes_ms, *ops_ms)
    return dict(bound_ms=bound,
                bound_by="bytes" if bytes_ms >= bound else "operations")


def phase_timings(guaranteed: dict, select: dict, certified: dict,
                  card: str) -> dict:
    corpus = guaranteed["corpus"]
    q_s, _, geom = topk.prepare_packed_scan(
        guaranteed["queries"], corpus, score_bound=1.05, batch_tile=512,
        corpus_tile=2048, reserve_bits=1,
    )
    scan_ms = cuda_ms(lambda: kernels.packed_scan(q_s, corpus, None, **geom))
    scan_plain_ms = cuda_ms(
        lambda: topk.packed_lane_scan_plain(q_s, corpus, None, **geom),
        iters=2,
    )
    b, d = q_s.shape
    n = corpus.shape[0]
    ct = geom["corpus_tile"]
    scan_bytes = b * d * 2 + n * d * 2 + b * 2 * ct * 4 + b * 4
    dot_ms = 2 * b * n * d / BF16_FLOPS * 1e3
    # per score: and, or for the key; min, max, max for the top-2 contest;
    # min, max for the discard-max
    int_ms = 7 * b * n / INT32_OPS * 1e3
    bytes_ms = scan_bytes / HBM_BYTES_PER_S * 1e3
    scan_bound = max(bytes_ms, dot_ms, int_ms)
    print(f"packed_scan at B={b} N={n} D={d} ct={ct}: kernel {scan_ms:.3f} ms, "
          f"plain {scan_plain_ms:.3f} ms; bound {scan_bound:.3f} ms "
          f"(bytes {bytes_ms:.3f}, bf16 dot on tensor cores {dot_ms:.3f}, "
          f"int32 contest {int_ms:.3f}) [{card}]")
    # the guaranteed path's retry sweeps run at 256 and 64 rows, a
    # served micro-batch at 8
    retry, split = {}, {}
    for rows in (256, 64, 8):
        q_rows = q_s[:rows].contiguous()
        retry[rows] = cuda_ms(
            lambda q_rows=q_rows: kernels.packed_scan(q_rows, corpus, None, **geom)
        )
        split[rows] = kernels.packed_scan_splits(q_rows, corpus, **geom)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"packed_scan at the retry and serving widths: B=256 "
          f"{retry[256]:.3f} ms, B=64 {retry[64]:.3f} ms, B=8 {retry[8]:.3f} "
          f"ms (corpus splits {split[256]}, {split[64]}, {split[8]}; {sms} "
          f"SMs) [{card}]")

    # the two sweeps beside the asynchronous ring, at a retry width: plain
    # loads (the bias column makes D odd) and the f32 fmaf chain, each
    # with the splits that its own blocks an SM give it
    q64 = guaranteed["queries"][:64]
    c_bias = torch.cat([corpus, torch.full_like(corpus[:, :1], 1.5)], dim=1)
    others = {}
    for name, qo, co, extra in (
        ("bias_in_dot D=65", q64, c_bias, dict(bias_in_dot=True)),
        ("f32 x f32", q64.float(), corpus.float(), {}),
    ):
        qo_s, _, geom_o = topk.prepare_packed_scan(
            qo, co, score_bound=1.05, batch_tile=64, corpus_tile=2048,
            reserve_bits=1, **extra,
        )
        ms = cuda_ms(
            lambda qo_s=qo_s, co=co, geom_o=geom_o: kernels.packed_scan(
                qo_s, co, None, **geom_o),
            iters=5,
        )
        others[name] = (ms, kernels.packed_scan_splits(qo_s, co, **geom_o))
    del c_bias, co
    print("packed_scan at B=64 through its other sweeps: " + ", ".join(
        f"{name} {ms:.3f} ms (corpus splits {s})"
        for name, (ms, s) in others.items()) + f" [{card}]")

    pool = select["pool"]
    retry_pool = pool[:128].contiguous()
    opts = dict(capacity=128, quantum_bits=select["qbits"],
                shared_exponent=True)
    # CUDA graphs: at a few hundredths of a millisecond a call, the
    # wrapper's host work would set a reading of back-to-back calls
    sel_ms = graph_ms(lambda: kernels.threshold_select(pool, BENCH_K, **opts))
    sel_retry_ms = graph_ms(
        lambda: kernels.threshold_select(retry_pool, BENCH_K, **opts))
    sel_plain_ms = cuda_ms(
        lambda: topk.select_topk_keys_plain(pool, BENCH_K, **opts), iters=3
    )
    sel_lib_ms = graph_ms(lambda: torch.topk(pool, BENCH_K, dim=1))
    sel_lib_retry_ms = graph_ms(lambda: torch.topk(retry_pool, BENCH_K, dim=1))
    pb, w = pool.shape
    sel_bytes = pb * w * 4 + 2 * pb * 128 * 4
    sel_bytes_ms = sel_bytes / HBM_BYTES_PER_S * 1e3
    bits = 22 - select["qbits"] + 1
    sel_ops_ms = (bits + 3) * pb * w / INT32_OPS * 1e3
    sel_bound = max(sel_bytes_ms, sel_ops_ms)
    print(f"threshold_select at B={pb} W={w} k={BENCH_K} cap=128 (CUDA "
          f"graphs): kernel {sel_ms:.4f} ms, at B=128 {sel_retry_ms:.4f} ms; "
          f"plain {sel_plain_ms:.3f} ms; torch.topk {sel_lib_ms:.4f} ms, at "
          f"B=128 {sel_lib_retry_ms:.4f} ms; bound {sel_bound:.4f} ms (bytes "
          f"{sel_bytes_ms:.4f}, int32 compares {sel_ops_ms:.4f}) [{card}]")
    # kernel 3: the f32 lane-max scan as pass 1 of search_certified("f32")
    queries = guaranteed["queries"]
    lane_kw = dict(corpus_tile=ct, slots=2, track_discards=True)
    lane_ms = cuda_ms(
        lambda: kernels.lane_max_scan(queries, corpus, None, **lane_kw),
        iters=5,
    )
    lane_plain_ms = cuda_ms(
        lambda: topk_f32.lane_max_scan_plain(queries, corpus, None, **lane_kw),
        iters=2,
    )
    lane_retry, lane_split = {}, {}
    for rows in (256, 128, 64):
        q_rows = queries[:rows].contiguous()
        lane_retry[rows] = cuda_ms(
            lambda q_rows=q_rows: kernels.lane_max_scan(q_rows, corpus, None,
                                                        **lane_kw)
        )
        lane_split[rows] = kernels.lane_max_scan_splits(q_rows, corpus,
                                                        **lane_kw)
    lane_split[b] = kernels.lane_max_scan_splits(queries, corpus, **lane_kw)
    lane_bytes_ms = (b * d * 2 + n * d * 2 + 2 * b * 2 * ct * 4 + b * 4
                     ) / HBM_BYTES_PER_S * 1e3
    # per score: 2 compares, 5 selects, the discard max and the tile
    # bookkeeping (counted as one, as the data sheet's bound is kept)
    lane_ops_ms = 9 * b * n / INT32_OPS * 1e3
    lane_bound = bound_of(lane_bytes_ms, dot_ms, lane_ops_ms)
    print(f"lane_max_scan at B={b} N={n} D={d} ct={ct} slots=2: kernel "
          f"{lane_ms:.3f} ms, plain {lane_plain_ms:.3f} ms; at B=256 "
          f"{lane_retry[256]:.3f} ms, B=128 {lane_retry[128]:.3f} ms, B=64 "
          f"{lane_retry[64]:.3f} ms (corpus splits {lane_split[b]}, "
          f"{lane_split[256]}, {lane_split[128]}, {lane_split[64]}); bound "
          f"{lane_bound['bound_ms']:.3f} ms (bytes {lane_bytes_ms:.3f}, bf16 "
          f"dot on tensor cores {dot_ms:.3f}, f32/int32 contest "
          f"{lane_ops_ms:.3f}) [{card}]")

    # kernel 4: the count sweep of certified_topk(method="count")
    tau = certified["tau"]
    count_ms = cuda_ms(
        lambda: kernels.count_at_least(queries, corpus, tau, corpus_tile=ct),
        iters=5,
    )
    count_plain_ms = cuda_ms(
        lambda: topk_f32.count_at_least_plain(queries, corpus, tau,
                                              corpus_tile=ct),
        iters=2,
    )
    qf, corpus_f = queries.float(), corpus.float()
    count_lib_ms = cuda_ms(
        lambda: (torch.matmul(qf, corpus_f.T) >= tau[:, None]).sum(-1),
        iters=3,
    )
    del corpus_f
    count_bytes_ms = (b * d * 2 + n * d * 2 + 2 * b * 4) / HBM_BYTES_PER_S * 1e3
    count_ops_ms = 2 * b * n / INT32_OPS * 1e3  # a compare and an add
    count_bound = bound_of(count_bytes_ms, dot_ms, count_ops_ms)
    count_split = kernels.count_at_least_splits(queries, corpus,
                                                corpus_tile=ct)
    print(f"count_at_least at B={b} N={n} D={d} (corpus splits "
          f"{count_split}): kernel {count_ms:.3f} ms, "
          f"plain {count_plain_ms:.3f} ms, (q @ c.T >= tau).sum(-1) in f32 "
          f"{count_lib_ms:.3f} ms; bound {count_bound['bound_ms']:.3f} ms "
          f"(bytes {count_bytes_ms:.3f}, bf16 dot on tensor cores "
          f"{dot_ms:.3f}, compare + add {count_ops_ms:.3f}) [{card}]")

    # kernel 5: the fused selector's sweep (keep-3, one merge level)
    fused_geom = {k: v for k, v in geom.items()
                  if k not in ("track_discards", "reserve_bits")}
    fused_kw = dict(merge_levels=1, merge_keep=3, capacity=128, **fused_geom)
    fused_ms = cuda_ms(
        lambda: kernels.packed_scan_select(q_s, corpus, None, BENCH_K,
                                           **fused_kw),
        iters=5,
    )
    fused_plain_ms = cuda_ms(
        lambda: topk.packed_lane_scan_select_plain(q_s, corpus, None, BENCH_K,
                                                   **fused_kw),
        iters=2,
    )

    def two_kernels():
        keys, dmax = kernels.packed_scan(q_s, corpus, None, **geom)
        merged, dmax = topk._merge_slots(keys, dmax, 1, 3)
        return kernels.threshold_select(merged, BENCH_K, **opts), dmax

    two_ms = cuda_ms(two_kernels, iters=5)
    fused_retry = {}
    for rows in (256, 64):
        q_rows = q_s[:rows].contiguous()
        fused_retry[rows] = cuda_ms(
            lambda q_rows=q_rows: kernels.packed_scan_select(
                q_rows, corpus, None, BENCH_K, **fused_kw)
        )
    fused_bytes_ms = (b * d * 2 + n * d * 2 + 2 * b * 128 * 4 + b * 4
                      ) / HBM_BYTES_PER_S * 1e3
    # the contest, 8 per lane pair for the keep-3 merge, then the select
    fused_ops_ms = int_ms + (8 * b * (ct // 2) + (bits + 3) * b * w
                             ) / INT32_OPS * 1e3
    fused_bound = bound_of(fused_bytes_ms, dot_ms, fused_ops_ms)
    print(f"packed_scan_select at B={b} N={n} D={d} ct={ct} keep-3 k={BENCH_K}"
          f": kernel {fused_ms:.3f} ms, plain {fused_plain_ms:.3f} ms, "
          f"packed_scan + merge + threshold_select {two_ms:.3f} ms; at B=256 "
          f"{fused_retry[256]:.3f} ms, B=64 {fused_retry[64]:.3f} ms; bound "
          f"{fused_bound['bound_ms']:.3f} ms (bytes {fused_bytes_ms:.3f}, "
          f"bf16 dot on tensor cores {dot_ms:.3f}, int32 contest + merge + "
          f"select {fused_ops_ms:.3f}) [{card}]")
    return {
        "packed_scan": dict(ms=scan_ms, plain_ms=scan_plain_ms,
                            **bound_of(bytes_ms, dot_ms, int_ms)),
        "threshold_select": dict(ms=sel_ms, plain_ms=sel_plain_ms,
                                 library_ms=sel_lib_ms,
                                 **bound_of(sel_bytes_ms, sel_ops_ms)),
        "lane_max_scan": dict(ms=lane_ms, plain_ms=lane_plain_ms,
                              **lane_bound),
        "count_at_least": dict(ms=count_ms, plain_ms=count_plain_ms,
                               library_ms=count_lib_ms, **count_bound),
        "packed_scan_select": dict(ms=fused_ms, plain_ms=fused_plain_ms,
                                   **fused_bound),
    }


# ---------------------------------------------------------------------------
# phase 11: the IVF probe on clustered corpora
# ---------------------------------------------------------------------------
# tests/test_ivf.py's `_clustered_corpus` recipe at 2^20 x 64: unit
# centres, sigma a coordinate (a noise norm of about 0.32 at D=64, as
# 0.08 gives at that test's D=16), rows normalized. Each corpus is built
# with these spill factors. 4,096 centres is one a cluster at the
# 4 sqrt(N) rule; 512 is eight a cluster, where the reference's k-means
# (initial rows drawn at random) seeds every centre. With the default
# spill (4x the mean cluster size) a few rows of an overfull cluster move
# to a far centroid, and that cluster's radius then spans the sphere; so
# the 512-centre corpus is also built without the spill.
CLUSTERED_SIGMA = 0.04
CLUSTERED = ((4096, (4.0,)), (512, (4.0, None)))
IVF_BATCH = 256
IVF_NPROBE = 8


def clustered_corpus(centres: int, seed: int):
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(centres, BENCH_DIM))
    mus /= np.linalg.norm(mus, axis=1, keepdims=True)
    x = mus[rng.integers(0, centres, BENCH_ITEMS)] + CLUSTERED_SIGMA * (
        rng.normal(size=(BENCH_ITEMS, BENCH_DIM)))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = mus[rng.integers(0, centres, IVF_BATCH)] + CLUSTERED_SIGMA * (
        rng.normal(size=(IVF_BATCH, BENCH_DIM)))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x.astype(np.float32), q.astype(np.float32)


def phase_ivf_clustered(dev, card: str) -> None:
    """`IVFIndex` on clustered 2^20 x 64 corpora: the build, B=256
    certified searches at nprobe 8, every certified row held to dense
    exact top-k over the served bf16 rows, the probe's ms beside
    `search_certified("fused")` on the same corpus. The probe launches no
    kernel, and the fused search here is a yardstick, so no launch of
    this phase is counted."""
    certified_somewhere = False
    for centres, spills in CLUSTERED:
        t0 = time.perf_counter()
        x, q = clustered_corpus(centres, SEED + centres)
        gen_s = time.perf_counter() - t0
        dense = torch.from_numpy(q).to(dev).bfloat16().float() @ (
            torch.from_numpy(x).to(dev).bfloat16().float().T)
        want = torch.topk(dense, BENCH_K).indices.cpu().numpy()
        index = RetrievalIndex(x, np.arange(BENCH_ITEMS), method="scan",
                               device=dev)
        fused_ms = cuda_ms(lambda index=index: index.search_certified(
            q, top_k=BENCH_K, method="fused"), iters=3)
        del index
        for spill in spills:
            t0 = time.perf_counter()
            ivf = IVFIndex(x, np.arange(BENCH_ITEMS), nprobe=IVF_NPROBE,
                           spill_factor=spill, device=dev)
            build_s = time.perf_counter() - t0
            scores, ids, exact = ivf.search_certified(q, top_k=BENCH_K)
            check(scores.dtype == np.float32, "ivf scores are not f32")
            exact_rows = sum(set(want[row]) == set(ids[row])
                             for row in range(IVF_BATCH))
            for row in np.flatnonzero(exact):
                held_to_dense_top_k(dense[row], ids[row], scores[row],
                                    BENCH_K, f"clustered ivf row {row}")
            certified_somewhere |= bool(exact.any())
            probe_ms = cuda_ms(
                lambda ivf=ivf: ivf.search_certified(q, top_k=BENCH_K),
                iters=5)
            radii = ivf.radii
            split = ", ".join(f"{k} {v:.2f} s"
                              for k, v in ivf.build_seconds.items())
            print(f"ivf clustered corpus: {BENCH_ITEMS} x {BENCH_DIM} "
                  f"around {centres} seeded centres (sigma "
                  f"{CLUSTERED_SIGMA} a coordinate, generated in "
                  f"{gen_s:.2f} s host), spill factor {spill}; build "
                  f"{build_s:.2f} s ({split}); {ivf.num_clusters} clusters, "
                  f"bucket {ivf.bucket_size}, fill {ivf.fill:.4f}, radii "
                  f"p50 / p99 / max {radii.median().item():.4f} / "
                  f"{radii.quantile(0.99).item():.4f} / "
                  f"{radii.max().item():.4f}; B={IVF_BATCH}, k={BENCH_K}, "
                  f"nprobe {IVF_NPROBE}: certified {int(exact.sum())} rows "
                  f"(share {exact.mean():.4f}), each == dense top-"
                  f"{BENCH_K}; {exact_rows} of {IVF_BATCH} rows hold the "
                  f"dense top-k set; the certified probe {probe_ms:.3f} ms "
                  f"a batch, search_certified('fused') {fused_ms:.3f} ms a "
                  f"batch on the same corpus [{card}]")
            del ivf
        del dense
    check(certified_somewhere, "no clustered corpus certified a row")


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------
# ML-1M's published size; the synthetic generator caps each user's
# ratings, so it writes fewer rows than asked (printed)
ML1M = dict(num_users=6040, num_movies=3883, num_ratings=1_000_209)
TRAIN_STEPS = 300
# a catalog past RetrievalIndex's 65,536-item "auto" threshold, so the
# trainer's eval search runs the packed scan (kernel 1)
SCAN_CORPUS = dict(num_users=2000, num_movies=1 << 17, num_ratings=40_000)


def write_json(path: pathlib.Path, value: dict) -> pathlib.Path:
    path.write_text(json.dumps(value))
    return path


def train_step_ms(config, batch_np, dev, steps: int) -> dict:
    """One train step at the batch's size on the card: CUDA-event ms a
    step after 3 warm-up steps, and the device's idle share of that step
    time, from the device time a step of 5 steps under torch.profiler
    (whose own wall, longer by the profiler's host cost, is returned as
    `wall_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = train_mod.TrainState(config, seed=SEED, device=dev)
    batch = train_mod.batch_to_device(batch_np, dev)

    def step():
        return train_mod.train_step(state, batch)

    ms = cuda_ms(step, iters=steps, warmup=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((evt.self_device_time_total / 1e3 / 5, evt.count // 5, evt.key)
         for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA and evt.self_device_time_total),
        reverse=True,
    )
    busy_ms = sum(row[0] for row in rows)
    idle = 1 - busy_ms / ms if busy_ms else None
    return {"ms": ms, "idle": idle, "busy_ms": busy_ms, "wall_ms": wall_ms / 5,
            "kernels": sum(row[1] for row in rows), "top": rows[:6]}


def eval_search_ms(trainer) -> tuple[float, dict, np.ndarray]:
    """The trainer's eval search on its first val batch (256 users, the
    train histories excluded): mean ms a call over 10 calls between CUDA
    events, which include the call's host work and its copy of the
    answer to the host. Returns the ms, the batch and the user vectors."""
    batch = next(trainer.data.eval_batches("val"))
    users = trainer._encode_rows(batch["user_tokens"])

    def search():
        return trainer.index.search(
            users, top_k=trainer.config.top_k,
            exclude_positions=batch["exclude_positions"],
        )

    return cuda_ms(search, iters=10, warmup=2), batch, users


# card vs CPU, 3 steps from one init: (losses and grad_norm rtol, atol;
# largest parameter difference). bf16 rounds differently on the two
# devices; f32 differs by summation order only, but Adam divides each
# gradient by its own RMS, so a component near rounding noise still moves
# a fair part of lr either way (seen on an H100: 7.6e-6 at bf16, 6.4e-6 at
# f32). A zeroed gradient moves the parameters 3 * lr = 3e-4 away and a
# negated one up to 6e-4, so the bounds fail a broken update.
CARD_VS_CPU = {"bfloat16": ((3e-2, 1e-2), 5e-5), "float32": ((1e-4, 1e-5), 5e-5)}
# The history tower at bf16 parts further. Adam's first steps move each
# component by about lr in its gradient's sign, so a component whose
# gradient is within bf16 rounding of zero (the attention key biases,
# whose exact gradient is 0) takes opposite signs on the two devices and
# parts by up to 2 * lr a step. Which components these are is read from
# the CPU alone, so a fault on the card cannot widen the set: at each
# step, the f32 gradient at the CPU run's parameters against the bf16
# gradient the CPU's step used; a component whose f32 gradient is less
# than ROUNDING_MARGIN times that difference, at any step, is left out
# (one whose gradient is 0 on both is not).
# Past the first step the two runs' parameters differ in those
# components, and some word-embedding rows, whose gradients are sums of
# terms that nearly cancel, then take other directions (an H100 parted
# 188 of 36,637 such components; the CPU's own f32 run parts from its
# bf16 run on the same rows). So each leaf may hold at most
# LEAF_PARTED_SHARE of its other moved components beyond the bound:
# none in a leaf of fewer than 100, and never a whole leaf.
ROUNDING_MARGIN = 4.0
LEAF_PARTED_SHARE = 0.01


def grads_of(model) -> dict[str, torch.Tensor]:
    return {n: (p.grad.detach().clone() if p.grad is not None
                else torch.zeros_like(p)) for n, p in model.named_parameters()}


def f32_grads(state32, params, batch, config32) -> dict[str, torch.Tensor]:
    """The f32 gradient of the train loss at `params` (dropout off)."""
    state32.model.load_state_dict(params)
    state32.model.zero_grad(set_to_none=True)
    losses = train_mod.compute_batch_losses(state32.model, batch, config32)
    losses[config32.train_loss].backward()
    return grads_of(state32.model)


def card_and_cpu_steps(config, batches, dev, dtype: str,
                       rounding: bool = False) -> dict:
    """Train steps (dropout off) on the card and on the CPU from one init,
    each step's losses and grad_norm held within `CARD_VS_CPU[dtype]`.
    Returns the init and both runs' final parameters, and with `rounding`
    a mask a parameter of the components within bf16 rounding of zero
    (`ROUNDING_MARGIN`) at some step."""
    loss_tol = CARD_VS_CPU[dtype][0]
    run = dataclasses.replace(config, dropout_rate=0.0, compute_dtype=dtype)
    states = [train_mod.TrainState(run, seed=SEED, device=d)
              for d in ("cpu", dev)]
    init = {n: v.clone() for n, v in states[0].model.state_dict().items()}
    if rounding:
        run32 = dataclasses.replace(run, compute_dtype="float32")
        state32 = train_mod.TrainState(run32, seed=SEED, device="cpu")
        zeros = {n: torch.zeros_like(p, dtype=torch.bool)
                 for n, p in states[0].model.named_parameters()}
    for batch in batches:
        if rounding:
            g32 = f32_grads(state32, states[0].model.state_dict(),
                            train_mod.batch_to_device(batch, "cpu"), run32)
        cpu_m, card_m = (
            train_mod.train_step(s, train_mod.batch_to_device(batch, s.device))
            for s in states
        )
        for key, value in cpu_m.items():
            got, want = float(card_m[key]), float(value)
            check(abs(got - want) <= loss_tol[1] + loss_tol[0] * abs(want),
                  f"card vs cpu {dtype} {key}: {got} vs {want}")
        if rounding:
            for n, g16 in grads_of(states[0].model).items():
                zeros[n] |= g32[n].abs() < ROUNDING_MARGIN * (g16 - g32[n]).abs()
    out = {"init": init, "cpu": states[0].model.state_dict(),
           "card": {n: v.cpu() for n, v in states[1].model.state_dict().items()}}
    if rounding:
        out["zeros"] = zeros
    return out


def check_card_steps_match_cpu(config, batches, dev,
                               rounding: bool = False) -> dict:
    """Three train steps (dropout off) on the card and on the CPU from one
    init, at bf16 and at f32, held within `CARD_VS_CPU`; with `rounding`,
    the bf16 run as the comment above says. Returns the largest parameter
    difference per dtype, and with `rounding` a row per leaf."""
    worst = {}
    for dtype, (_, param_tol) in CARD_VS_CPU.items():
        run = card_and_cpu_steps(config, batches, dev, dtype,
                                 rounding=rounding and dtype == "bfloat16")
        diffs = {n: (run["card"][n] - v).abs() for n, v in run["cpu"].items()}
        worst[dtype] = max(d.max().item() for d in diffs.values())
        if "zeros" not in run:
            check(worst[dtype] <= param_tol,
                  f"card vs cpu {dtype} parameters differ by {worst[dtype]}")
            continue
        lr = config.learning_rate
        check(worst[dtype] <= 2 * lr * len(batches) * 1.01,
              f"card vs cpu {dtype} parameters differ by {worst[dtype]}")
        leaves = []
        for n, zero in run["zeros"].items():
            d = diffs[n]
            moved = torch.maximum((run["cpu"][n] - run["init"][n]).abs(),
                                  (run["card"][n] - run["init"][n]).abs()) > lr / 2
            held = moved & ~zero
            leaves.append(dict(
                name=n, moved=int(moved.sum()), zeros=int((moved & zero).sum()),
                parted_zeros=int((moved & zero & (d > param_tol)).sum()),
                held=int(held.sum()),
                parted_held=int((held & (d > param_tol)).sum()),
            ))
        worst["bf16_leaves"] = leaves
        bad = [leaf for leaf in leaves if leaf["parted_held"]
               > int(LEAF_PARTED_SHARE * leaf["held"])]
        check(not bad, f"card vs cpu {dtype}: leaves with more than "
              f"{LEAF_PARTED_SHARE} of their moved components outside bf16 "
              f"rounding of zero beyond {param_tol}: {bad}")
    return worst


# remat against plain steps: the same arithmetic, recomputed; a
# difference past this is a wrong replay (a lost dropout mask moves a
# parameter by lr, 1e-4, in the first step)
REMAT_BOUND = 5e-5


def remat_run(config, batches, dev) -> tuple[dict, torch.Tensor]:
    """3 steps from seed SEED with dropout on: (parameters, the dropout
    generator's state)."""
    state = train_mod.TrainState(config, seed=SEED, device=dev)
    for batch in batches:
        train_mod.train_step(state, train_mod.batch_to_device(batch, dev))
    torch.cuda.synchronize()
    return state.model.state_dict(), state.generator.get_state()


def step_peak_bytes(config, batch_np, dev) -> tuple[int, int]:
    """The second train step's peak of allocated device memory, and that
    peak less what was allocated before the step."""
    state = train_mod.TrainState(config, seed=SEED, device=dev)
    batch = train_mod.batch_to_device(batch_np, dev)
    train_mod.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    train_mod.train_step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - before


def check_remat(config, batches, dev, card: str, what: str) -> None:
    """3 steps with `remat=True` == 3 without, dropout on."""
    check(config.dropout_rate > 0, f"{what}: dropout is off")
    plain, plain_gen = remat_run(config, batches, dev)
    remat, remat_gen = remat_run(
        dataclasses.replace(config, remat=True), batches, dev)
    worst = max((remat[name].float() - value.float()).abs().max().item()
                for name, value in plain.items())
    check(worst <= REMAT_BOUND, f"{what}: remat steps part from plain "
          f"steps by {worst:.3e}")
    check(torch.equal(plain_gen, remat_gen),
          f"{what}: remat left the dropout generator elsewhere")
    print(f"{what} remat: 3 steps with remat=True (dropout "
          f"{config.dropout_rate}) == 3 without from one seed, largest "
          f"parameter difference {worst:.3e} (bound {REMAT_BOUND:.0e}), the "
          f"dropout generator's state equal [{card}]")


def remat_memory(config, big_batch, dev, card: str, what: str) -> None:
    """A step's peak device memory at `big_batch`'s size with and
    without remat."""
    size = len(big_batch["user_tokens"])
    fusion = config.history_layers if config.user_tower == "history" else 0
    peaks = {remat_: step_peak_bytes(
        dataclasses.replace(config, remat=remat_), big_batch, dev)
        for remat_ in (False, True)}
    print(f"{what} remat memory: a step at batch {size} with "
          f"{config.num_hidden_layers} text and {fusion} fusion layers: "
          f"peak device memory {peaks[False][0] / 2**20:.1f} "
          f"MiB without remat ({peaks[False][1] / 2**20:.1f} MiB above the "
          f"step's start), {peaks[True][0] / 2**20:.1f} MiB with "
          f"({peaks[True][1] / 2**20:.1f} MiB) [{card}]")


def check_trace(prof_dir: pathlib.Path, card: str) -> None:
    """The trace `profile_dir` wrote: steps 10-20 (ten AdamW steps) and
    their CUDA kernels."""
    files = sorted(prof_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"profile_dir holds {len(files)} traces")
    events = json.loads(files[0].read_text())["traceEvents"]
    # the host's record of each step ("gpu_user_annotation" mirrors it on
    # the device's timeline)
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("Optimizer.step#AdamW")]
    device = [e for e in events if e.get("cat") == "kernel"]
    check(len(steps) == 10, f"the trace holds {len(steps)} optimizer steps")
    check(len(device) > 0, "the trace holds no CUDA kernel")
    print(f"training profile_dir: one trace ({files[0].stat().st_size / 2**20:.1f}"
          f" MiB) of train steps 10-20: {len(steps)} AdamW steps, "
          f"{len(device)} CUDA kernel events [{card}]")


def check_predictions(trainer, path: pathlib.Path, card: str) -> None:
    """`predictions.npz` of the predict CLI: every predict user, each row
    == dense top-k of the lane-pair survivors with the user's train
    history excluded, within one key quantum."""
    with np.load(path) as saved:
        preds = {name: saved[name] for name in saved.files}
    data = trainer.data
    check(len(preds["user_id"]) == int(data.user_subsets["is_predict"].sum())
          and preds["rec_scores"].dtype == np.float32,
          "predictions.npz does not hold every predict user")
    index = trainer.index
    upos_of = {int(u): p for p, u in enumerate(data.user_ids)}
    tight = quantum_scaled(index_quantum_bits(index)) + 1e-6
    ct = index._scan_setup()[2]
    k = preds["rec_item_ids"].shape[1]
    corpus = index.corpus.float()
    for start in range(0, len(preds["user_id"]), 256):
        users = preds["user_id"][start:start + 256]
        upos = np.asarray([upos_of[int(u)] for u in users])
        vecs = trainer.eval_user_embeddings(upos)
        dense = scaled_queries(index, vecs).float() @ corpus.T
        excl = [data._train_items_by_user.get(int(u), []) for u in upos]
        got_pos = torch.tensor(
            [[index._id_to_pos[int(i)] for i in row]
             for row in preds["rec_item_ids"][start:start + 256]],
            device=dense.device)
        check_exclusion_search(dense, ct, excl, got_pos, k, tight,
                               "predict")
    print(f"training predict: `cli predict` wrote {path.name} for all "
          f"{len(preds['user_id'])} predict users of the {len(index)}-item "
          f"catalogue (top-{k}, train histories excluded), every row == "
          f"dense top-{k} of the lane-pair survivors within one key quantum "
          f"({tight:.2e} scaled) [{card}]")


def phase_training(dev, card: str, root: pathlib.Path) -> dict:
    """(a) generate and prepare a corpus at ML-1M's size under `root`,
    train the reference config through the CLI with two validations on
    the dense index, hold 3 card steps against the CPU and time the step;
    (b) a 2^17-item catalog whose eval search runs the scan index (kernel
    1), checked against dense scores; (c) serve the artifact of (a) with
    the engine and hold its answers against the trainer's own search.
    Both prepared corpora stay under `root` for phase 10."""
    # (a) ML-1M size, the reference config, through the CLI
    t0 = time.perf_counter()
    generate_movielens(root / "ml1m", seed=SEED, text_signal=True, **ML1M)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepare_movielens(root / "ml1m")
    etl_s = time.perf_counter() - t0
    table = load_table(root / "ml1m", "ratings")
    ratings = len(table["rating"])
    # validate twice, every TRAIN_STEPS / 3 steps (the run stops at
    # max_steps before a third)
    steps_per_epoch = int(table["is_train"].sum()) // 32
    val_interval = (TRAIN_STEPS // 3 + 0.5) / steps_per_epoch
    print(f"training corpus: synthetic ML-1M size ({ML1M['num_users']} "
          f"users, {ML1M['num_movies']} movies, {ratings} ratings "
          f"written of {ML1M['num_ratings']} asked), generated in "
          f"{gen_s:.2f} s, prepared by the port's ETL in {etl_s:.2f} s "
          "(host)")
    config_a = write_json(root / "ml1m.json", {
        "model": {},
        "data": {"data_dir": str(root / "ml1m")},
        "trainer": {"max_steps": TRAIN_STEPS,
                    "val_check_interval": val_interval,
                    "log_every_steps": 25, "log_dir": str(root / "runs"),
                    "run_name": "ml1m", "seed": SEED,
                    "profile_dir": str(root / "prof")},
    })
    artifact = root / "artifact"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, val = cli.run(["fit", "--config", str(config_a), "--device",
                            str(dev), "--save_artifact", str(artifact)])
    fit_s = time.perf_counter() - t0
    launches_a = kernels.launch_counts()
    config = trainer.config
    check(config == train_mod.TrainConfig(), "not the reference config")
    check(trainer.global_step == TRAIN_STEPS, "fit stopped early")
    rows = [json.loads(line) for line in
            (trainer.logger.log_dir / "metrics.jsonl").read_text()
            .splitlines()]
    train_rows = [r for r in rows if "train/grad_norm" in r]
    val_rows = [r for r in rows if "val/RetrievalNormalizedDCG" in r]
    check(len(train_rows) == TRAIN_STEPS // 25, "train rows missing")
    check(len(val_rows) >= 2, f"{len(val_rows)} validations, not 2")
    check(all(math.isfinite(v) for r in rows for v in r.values()),
          "a logged value is not finite")
    retrieval = {k: v for k, v in val.items() if "/Retrieval" in k}
    check(len(retrieval) == 6
          and all(0.0 <= v <= 1.0 for v in retrieval.values()),
          f"val metrics out of [0, 1]: {retrieval}")
    check(trainer.index.method == "dense",
          f"eval index is {trainer.index.method!r}, not dense")
    init = init_encoder(config, SEED).state_dict()
    moved = max((v.cpu() - init[n]).abs().max().item()
                for n, v in trainer.state.model.state_dict().items())
    check(moved > 0, "the parameters did not move")
    print(f"training fit: {TRAIN_STEPS} steps of the reference config "
          f"(BERT 1 layer, hidden 32, 4 heads, intermediate 32, vocab "
          f"30522, max_length 64, bf16, PairwiseHingeLoss, batch 32) "
          f"through `cli fit` in {fit_s:.2f} s host wall with "
          f"{len(val_rows)} validations on the {trainer.index.method!r} "
          f"index; first / last logged train loss "
          f"{train_rows[0]['train/PairwiseHingeLoss']:.4f} / "
          f"{train_rows[-1]['train/PairwiseHingeLoss']:.4f}, grad_norm "
          f"{train_rows[-1]['train/grad_norm']:.4f}; parameters moved "
          f"by up to {moved:.3e}; val "
          + ", ".join(f"{k.split('/Retrieval')[1]} {v:.4f}"
                      for k, v in retrieval.items())
          + f" [{card}]")
    print(f"training (a) kernel launches: {launches_a}")
    check_trace(root / "prof", card)
    dense_ms, _, _ = eval_search_ms(trainer)
    print(f"training eval search, dense index of {trainer.data.num_items} "
          f"items: {dense_ms:.3f} ms a batch of "
          f"{trainer.data.config.eval_batch_size} users, top-"
          f"{config.top_k} with the train histories excluded [{card}]")

    batches = [b for _, b in zip(range(3), trainer.data.train_batches(0))]
    worst = check_card_steps_match_cpu(config, batches, dev)
    print("training card vs cpu: 3 steps (dropout off) from one init "
          "agree; largest parameter difference "
          + ", ".join(f"{d} {w:.3e} (bound {CARD_VS_CPU[d][1]:.0e})"
                      for d, w in worst.items()) + f" [{card}]")
    big = RecDataModule(dataclasses.replace(trainer.data.config,
                                            batch_size=4096))
    big.setup()
    big_batch = next(big.train_batches(0))
    check_remat(config, batches, dev, card, "training")
    # one layer (the reference config) and four: remat keeps one layer's
    # activations at a time, so only a deeper tower can show a saving
    for layers in (1, 4):
        remat_memory(dataclasses.replace(config, num_hidden_layers=layers),
                     big_batch, dev, card, "training")
    timing = {
        32: train_step_ms(config, batches[0], dev, steps=50),
        4096: train_step_ms(config, big_batch, dev, steps=10),
    }
    for size, t in timing.items():
        idle = ("not measured (the profiler recorded no device time)"
                if t["idle"] is None else f"{t['idle']:.4f}")
        print(f"train step at batch {size}: {t['ms']:.3f} ms (CUDA "
              f"events, dropout on); profiler: device busy "
              f"{t['busy_ms']:.3f} ms and {t['kernels']} device "
              f"operations a step (profiled wall {t['wall_ms']:.3f} "
              f"ms), device idle share of the step {idle} [{card}]")
        for dev_ms, count, name in t["top"]:
            print(f"  {dev_ms:9.3f} ms  x{count:<4d} {name[:100]}")

    # (b) a catalog past the scan threshold
    t0 = time.perf_counter()
    generate_movielens(root / "scan", seed=SEED + 1, text_signal=True,
                       **SCAN_CORPUS)
    prepare_movielens(root / "scan")
    scan_prep_s = time.perf_counter() - t0
    config_b = write_json(root / "scan.json", {
        "model": {},
        "data": {"data_dir": str(root / "scan")},
        "trainer": {"max_steps": 20, "limit_val_batches": 2,
                    "limit_val_loss_batches": 2, "checkpointing": False,
                    "log_dir": str(root / "runs"), "run_name": "scan",
                    "seed": SEED},
    })
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    scan_trainer, scan_val = cli.run(["fit", "--config", str(config_b),
                                      "--device", str(dev)])
    scan_fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    index = scan_trainer.index
    check(index.method == "scan",
          f"eval index at 2^17 items is {index.method!r}, not scan")
    check(launches["packed_scan"] > 0,
          "the eval search never launched packed_scan")
    check(all(0.0 <= v <= 1.0 for k, v in scan_val.items()
              if "/Retrieval" in k), "scan val metrics out of [0, 1]")
    scan_ms, batch, users = eval_search_ms(scan_trainer)
    top_k = scan_trainer.config.top_k
    _, got_ids = index.search(users, top_k=top_k,
                              exclude_positions=batch["exclude_positions"])
    got_pos = torch.tensor(
        [[index._id_to_pos[int(i)] for i in row] for row in got_ids],
        device=dev,
    )
    n = len(index)
    excl = [[int(p) for p in row if p < n]
            for row in batch["exclude_positions"]]
    dense = (scaled_queries(index, users).float()
             @ index.corpus.float().T)
    tight = quantum_scaled(index_quantum_bits(index)) + 1e-6
    check_exclusion_search(dense, index._scan_setup()[2], excl, got_pos,
                           top_k, tight, "trainer eval search")
    print(f"training (b): {SCAN_CORPUS['num_movies']} movies, "
          f"{len(scan_trainer.data.train_user_pos)} train interactions "
          f"(corpus generated and prepared in {scan_prep_s:.2f} s); "
          f"`cli fit` of 20 steps + validation in {scan_fit_s:.2f} s on "
          f"the {index.method!r} index; {len(got_ids)} eval queries with "
          f"their train histories excluded == dense top-{top_k} of the "
          f"lane-pair survivors within one key quantum ({tight:.2e} "
          f"scaled) [{card}]")
    print(f"training (b) kernel launches: {launches}")
    print(f"training eval search, scan index of {n} items: "
          f"{scan_ms:.3f} ms a batch of {len(got_ids)} users, top-"
          f"{top_k} with the train histories excluded [{card}]")

    # (b) predict: the full predict cohort of the 2^17-item catalogue
    # through the CLI (a seeded init: the CLI restores no checkpoint)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pred_trainer, _ = cli.run(["predict", "--config", str(config_b),
                               "--device", str(dev)])
    predict_s = time.perf_counter() - t0
    predict_launches = kernels.launch_counts()
    check(predict_launches["packed_scan"] > 0,
          "predict never launched packed_scan")
    print(f"training predict: `cli predict` in {predict_s:.2f} s host wall "
          f"(setup, the catalogue encoded, the cohort searched); kernel "
          f"launches {predict_launches}")
    check_predictions(pred_trainer,
                      pred_trainer.logger.log_dir / "predictions.npz", card)

    # (c) serve what (a) trained
    engine = RecommenderEngine(artifact, device=dev)
    n = trainer.data.num_items
    for pos in (0, n // 3, 2 * n // 3, n - 1):
        item_id = int(trainer.data.item_ids[pos])
        text = trainer.data.item_texts[pos]
        served = engine.search_items(Query(text=text),
                                     exclude_item_ids=[item_id], top_k=20)
        _, want = trainer.index.search(trainer.embed_texts([text]),
                                       top_k=20, exclude_ids=[[item_id]])
        check([c.movie_id for c in served] == want[0].tolist(),
              f"served answer for item {item_id} differs from the "
              "trainer's search")
    print(f"training (c): the saved artifact serves from "
          f"RecommenderEngine on the card; 4 item queries with the item "
          f"excluded == the trainer's own index search [{card}]")
    return {"launches": {name: launches_a[name] + launches[name]
                         + predict_launches[name]
                         for name in kernels.LAUNCHES},
            "timing": timing}


# ---------------------------------------------------------------------------
# phase 10: the history tower
# ---------------------------------------------------------------------------
# the repo's quality flagship (runs/ml1m-r4-flagship-s*/config.json): the
# reference text tower fused with the user's 16 most recent rated items,
# trained with InfoNCE over 4 negatives
FLAGSHIP = dict(user_tower="history", max_history=16, history_layers=1,
                use_history_ratings=True,
                train_loss="InfomationNoiseContrastiveEstimationLoss",
                num_negatives=4)
# every item channel at once on the 2^17-item catalog: index rows of
# 32 + 1 (bias) + 128 (CF factors) + 1 (popularity) = 162 columns
WIDE = dict(FLAGSHIP, item_id_embedding="bloom", item_bias=True, max_bag=16,
            cf_rank=128)
SERVE_USERS = 64


def post_json(base: str, endpoint: str, payload: dict):
    req = urllib.request.Request(
        f"{base}/{endpoint}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def user_answer(trainer, upos: int, excl: list[int], index=None,
                top_k: int = 20):
    """The trainer's own query vector of a dataset user and its search
    (on `index`, default the trainer's) with `excl` excluded."""
    vec = trainer.eval_user_embeddings(np.array([upos]))
    index = trainer.index if index is None else index
    _, ids = index.search(vec, top_k=top_k, exclude_ids=[excl])
    return vec, ids[0].tolist()


def served_user_answers(engine, user_ids) -> dict:
    """Each user's served answer (`recommend_with_user_id`, top 20) and
    the engine's query vector for that user."""
    service = RecService(engine)
    return {
        user_id: (
            [c.movie_id for c in service.recommend_with_user_id(user_id,
                                                                top_k=20)],
            torch.tensor(engine.embed_user_query(
                engine.get_user(user_id)).embedding),
        )
        for user_id in user_ids
    }


def check_served_users(trainer, engine, served, what, index=None):
    """Each served user's query vector (`served_user_answers`) against the
    trainer's own, and the served answer against the search of that
    vector on `index` (default the trainer's); returns the largest vector
    difference."""
    pos_of = {int(u): p for p, u in enumerate(trainer.data.user_ids)}
    worst = 0.0
    for user_id, (got, got_vec) in served.items():
        user = engine.get_user(user_id)
        excl = [a.movie_id for a in (user.history or []) + (user.target or [])]
        vec, want = user_answer(trainer, pos_of[user_id], excl, index)
        diff = (got_vec - vec[0].cpu()).abs().max().item()
        check(diff <= 1e-5, f"{what}: served user {user_id}'s vector differs "
              f"from the trainer's by {diff}")
        worst = max(worst, diff)
        check(got == want, f"{what}: served user {user_id} differs from the "
              "search of the trainer's vector")
    return worst


def fit_history(root, name, model, data_dir, trainer_kw, artifact, dev):
    config = write_json(root / f"{name}.json", {
        "model": model, "data": {"data_dir": str(data_dir)},
        "trainer": {"log_dir": str(root / "runs"), "run_name": name,
                    "seed": SEED, **trainer_kw},
    })
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, val = cli.run(["fit", "--config", str(config), "--device",
                            str(dev), "--save_artifact", str(artifact)])
    return trainer, val, time.perf_counter() - t0, kernels.launch_counts()


def phase_history(dev, card: str, root: pathlib.Path) -> dict:
    """(a) the flagship history tower at full width on phase 9's ML-1M
    size corpus: 300 steps through `cli fit` with two validations, 3 card
    steps against the CPU at bf16 and f32, the step's time at batch 32 and
    1024, and the saved artifact served over HTTP (`recommend_with_user_id`
    for 64 users in one burst, `recommend_with_user` with a request
    history), every answer equal to the trainer's own; (b) every item
    channel on phase 9's 2^17-item catalog: 20 steps and a validation on
    the scan index at 162 columns (kernel 1), its answers against dense
    scores, kernel 1 at that width against its plain version, and the
    artifact served."""
    from xfmr_rec_torch.models.history import init_two_tower

    launches = {name: 0 for name in kernels.LAUNCHES}

    def add(counts):
        for name in launches:
            launches[name] += counts[name]

    # (a) the flagship
    steps_per_epoch = int(load_table(root / "ml1m", "ratings")["is_train"]
                          .sum()) // 32
    artifact = root / "history_artifact"
    trainer, val, fit_s, counts = fit_history(
        root, "history", FLAGSHIP, root / "ml1m",
        {"max_steps": TRAIN_STEPS, "log_every_steps": 25,
         "val_check_interval": (TRAIN_STEPS // 3 + 0.5) / steps_per_epoch},
        artifact, dev,
    )
    add(counts)
    config = trainer.config
    check(config == train_mod.TrainConfig(**FLAGSHIP), "not the flagship")
    check(trainer.global_step == TRAIN_STEPS, "history fit stopped early")
    rows = [json.loads(line) for line in
            (trainer.logger.log_dir / "metrics.jsonl").read_text()
            .splitlines()]
    loss = "train/InfomationNoiseContrastiveEstimationLoss"
    train_rows = [r for r in rows if loss in r]
    val_rows = [r for r in rows if "val/RetrievalNormalizedDCG" in r]
    check(len(train_rows) == TRAIN_STEPS // 25, "history train rows missing")
    check(len(val_rows) >= 2, f"{len(val_rows)} history validations, not 2")
    check(all(math.isfinite(v) for r in rows for v in r.values()),
          "a logged history value is not finite")
    retrieval = {k: v for k, v in val.items() if "/Retrieval" in k}
    check(len(retrieval) == 6
          and all(0.0 <= v <= 1.0 for v in retrieval.values()),
          f"history val metrics out of [0, 1]: {retrieval}")
    init = init_two_tower(config, SEED).state_dict()
    moved = {n: (v.cpu() - init[n]).abs().max().item()
             for n, v in trainer.state.model.state_dict().items()}
    check(min(v for n, v in moved.items() if n.startswith("fusion."))
          > 0 and max(moved.values()) > 0, "the fusion did not train")
    print(f"history (a) fit: {TRAIN_STEPS} steps of the flagship (history "
          f"tower, 16 slots with ratings, 1 fusion layer, InfoNCE over 4 "
          f"negatives, the reference text tower at bf16, batch 32) through "
          f"`cli fit` in {fit_s:.2f} s host wall with {len(val_rows)} "
          f"validations on the {trainer.index.method!r} index; first / last "
          f"logged loss {train_rows[0][loss]:.4f} / {train_rows[-1][loss]:.4f}"
          f", grad_norm {train_rows[-1]['train/grad_norm']:.4f}; val "
          + ", ".join(f"{k.split('/Retrieval')[1]} {v:.4f}"
                      for k, v in retrieval.items()) + f" [{card}]")
    print(f"history (a) kernel launches: {counts}")

    batches = [b for _, b in zip(range(3), trainer.data.train_batches(0))]
    worst = check_card_steps_match_cpu(config, batches, dev, rounding=True)
    leaves = worst["bf16_leaves"]
    print(f"history card vs cpu: 3 steps (dropout off) from one init agree; "
          f"float32: every parameter within "
          f"{CARD_VS_CPU['float32'][1]:.0e} (largest {worst['float32']:.3e}); "
          f"bfloat16: largest difference {worst['bfloat16']:.3e}; of "
          f"{sum(leaf['moved'] for leaf in leaves)} moved components "
          f"{sum(leaf['zeros'] for leaf in leaves)} are within bf16 rounding "
          f"of zero (read from the CPU), "
          f"{sum(leaf['parted_zeros'] for leaf in leaves)} of them parted "
          f"beyond {CARD_VS_CPU['bfloat16'][1]:.0e}; of the other "
          f"{sum(leaf['held'] for leaf in leaves)}, "
          f"{sum(leaf['parted_held'] for leaf in leaves)} parted (at most "
          f"{LEAF_PARTED_SHARE} of a leaf) [{card}]")
    print("  leaf: moved, within rounding of zero (parted), other (parted)")
    for leaf in leaves:
        print(f"  {leaf['name']}: {leaf['moved']}, {leaf['zeros']} "
              f"({leaf['parted_zeros']}), {leaf['held']} "
              f"({leaf['parted_held']})")
    big = RecDataModule(dataclasses.replace(trainer.data.config,
                                            batch_size=1024))
    big.setup()
    big_batch = next(big.train_batches(0))
    check_remat(config, batches, dev, card, "history")
    remat_memory(config, big_batch, dev, card, "history")
    timing = {
        32: train_step_ms(config, batches[0], dev, steps=50),
        1024: train_step_ms(config, big_batch, dev, steps=10),
    }
    for size, t in timing.items():
        idle = ("not measured (the profiler recorded no device time)"
                if t["idle"] is None else f"{t['idle']:.4f}")
        print(f"history train step at batch {size} ({(3 + 16) * size} text "
              f"rows a step): {t['ms']:.3f} ms (CUDA events, dropout on); "
              f"profiler: device busy {t['busy_ms']:.3f} ms and "
              f"{t['kernels']} device operations a step (profiled wall "
              f"{t['wall_ms']:.3f} ms), device idle share {idle} [{card}]")
        for dev_ms, count, name in t["top"]:
            print(f"  {dev_ms:9.3f} ms  x{count:<4d} {name[:100]}")

    # (a) the artifact over HTTP
    kernels.reset_launch_counts()
    engine = RecommenderEngine(artifact, device=dev)
    service = RecService(engine)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    users = [int(u) for u in engine.users.arrays["user_id"][:SERVE_USERS]]
    try:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVE_USERS) as pool:
            bodies = list(pool.map(
                lambda u: post_json(base, "recommend_with_user_id",
                                    {"user_id": u, "top_k": 20}), users))
        burst_s = time.perf_counter() - t0
        lat = []
        for u in users:
            t0 = time.perf_counter()
            post_json(base, "recommend_with_user_id",
                      {"user_id": u, "top_k": 20})
            lat.append((time.perf_counter() - t0) * 1e3)
        # a request history: the user's 5 most recent items and an unknown
        # movie id, under no user id
        req_user = engine.get_user(users[7])
        recent = req_user.history[-5:]
        request = {"user_text": req_user.user_text,
                   "history": [dataclasses.asdict(a) for a in recent]
                   + [dict(dataclasses.asdict(recent[0]), movie_id=-7)]}
        got_hist = post_json(base, "recommend_with_user",
                             {"user": request, "top_k": 20})
        # BM25 over the user store's profile text
        user_texts = [str(t) for t in engine.users.arrays["user_text"]]
        text_rng = np.random.default_rng(SEED + 50)
        user_queries = []
        for row in text_rng.choice(len(user_texts), size=16, replace=False):
            words = re.findall(r"[a-z0-9]+", user_texts[row].lower())
            user_queries.append(" ".join(
                text_rng.choice(words, size=2, replace=False)))
        check_text_search(
            base, "search_users_text", engine.search_users_text,
            [{"user_text": t} for t in user_texts], "user_text",
            engine.users.arrays["user_id"], "user_id", user_queries, card)
        check(engine._user_fts._native is not None,
              "the served user BM25 answered from the Python path")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    add(kernels.launch_counts())
    pos_of = {int(u): p for p, u in enumerate(trainer.data.user_ids)}
    for user_id, body in zip(users, bodies, strict=True):
        user = engine.get_user(user_id)
        excl = [a.movie_id for a in user.history + user.target]
        _, want = user_answer(trainer, pos_of[user_id], excl)
        check([c["movie_id"] for c in body] == want,
              f"served user {user_id} differs from the trainer's search")
    worst_vec = check_served_users(
        trainer, engine, served_user_answers(engine, users[:8]), "history (a)")
    # the trainer's side of the request history: positions most recent
    # first, gathered from its f32 corpus
    item_pos = {int(i): p for p, i in enumerate(trainer.data.item_ids)}
    hist = np.zeros((1, 16), np.int64)
    mask = np.zeros((1, 16), bool)
    rates = np.zeros((1, 16), np.int64)
    for j, a in enumerate(reversed(recent)):
        hist[0, j], mask[0, j], rates[0, j] = item_pos[a.movie_id], True, a.rating
    tokens = trainer.data.tokenizer.encode_batch([req_user.user_text])
    vec = trainer.state.model.encode_users_from_corpus(
        torch.from_numpy(tokens).to(dev),
        trainer._corpus_f32,
        *(torch.from_numpy(x).to(dev) for x in (hist, mask, rates)),
    )
    _, want = trainer.index.search(
        vec, top_k=20, exclude_ids=[[a.movie_id for a in recent] + [-7]])
    check([c["movie_id"] for c in got_hist] == want[0].tolist(),
          "recommend_with_user with a request history differs from the "
          "trainer's fusion over the same items")
    lat.sort()
    print(f"history (a) serving over HTTP: {SERVE_USERS} "
          f"recommend_with_user_id requests in one burst answered in "
          f"{burst_s * 1e3:.1f} ms wall; {SERVE_USERS} sequential requests "
          f"p50 {lat[len(lat) // 2]:.3f} ms, max {lat[-1]:.3f} ms (host "
          f"clock, HTTP on localhost included); every answer == the "
          f"trainer's own user vector and search (vectors within "
          f"{worst_vec:.1e}); recommend_with_user with a 5-item request "
          f"history and an unknown movie id == the trainer's fusion of "
          f"those items [{card}]")

    # (b) every item channel on the 2^17-item catalog
    wide_artifact = root / "wide_artifact"
    wide, wide_val, wide_fit_s, counts = fit_history(
        root, "wide", WIDE, root / "scan",
        {"max_steps": 20, "limit_val_batches": 2,
         "limit_val_loss_batches": 2, "checkpointing": False},
        wide_artifact, dev,
    )
    add(counts)
    index = wide.index
    check(index.method == "scan", f"wide index is {index.method!r}")
    check(index.dim == 32 + 1 + 128 + 1, f"wide index has {index.dim} columns")
    check(counts["packed_scan"] > 0, "the wide eval never launched packed_scan")
    check(all(0.0 <= v <= 1.0 for k, v in wide_val.items()
              if "/Retrieval" in k), "wide val metrics out of [0, 1]")
    batch = next(wide.data.eval_batches("val"))
    users_q = wide._eval_user_embeds(batch)
    top_k = wide.config.top_k
    _, got_ids = index.search(users_q, top_k=top_k,
                              exclude_positions=batch["exclude_positions"])
    got_pos = torch.tensor(
        [[index._id_to_pos[int(i)] for i in row] for row in got_ids],
        device=dev)
    n = len(index)
    excl = [[int(p) for p in row if p < n]
            for row in batch["exclude_positions"]]
    scaled = scaled_queries(index, users_q)
    dense = scaled.float() @ index.corpus.float().T
    tight = quantum_scaled(index_quantum_bits(index)) + 1e-6
    check_exclusion_search(dense, index._scan_setup()[2], excl, got_pos,
                           top_k, tight, "wide eval search")
    # kernel 1 at the widened row against its plain version
    corpus, _, tile, true_n = index._scan_setup()
    q_bf16 = users_q.bfloat16()
    qnorm = torch.linalg.vector_norm(q_bf16.float(), dim=-1).max()
    q_s, _, geom = topk.prepare_packed_scan(
        q_bf16, corpus,
        score_bound=torch.clamp(index._corpus_maxnorm * qnorm * 1.05,
                                min=1e-6).float(),
        batch_tile=len(q_bf16), corpus_tile=tile, reserve_bits=1,
        true_num_items=true_n,
    )
    got_keys, got_dmax = kernels.packed_scan(q_s, corpus, None, **geom)
    want_keys, want_dmax = topk.packed_lane_scan_plain(q_s, corpus, None,
                                                       **geom)
    low = geom["idx_bits"] + geom["reserve_bits"]
    steps = max(((got_keys >> low) - (want_keys >> low)).abs().max().item(),
                ((got_dmax >> low) - (want_dmax >> low)).abs().max().item())
    check(steps <= 1, f"kernel 1 at D={corpus.shape[1]} is {steps} key "
          "quanta from its plain version")
    # each kernel key names an item (its tile bits and lane) whose plain
    # key holds the same value within one quantum: a right value with a
    # wrong position fails here
    live = got_keys != 0
    lanes = torch.arange(got_keys.shape[1], device=dev).expand_as(got_keys)
    named = topk.unpack_positions(
        got_keys, lanes, corpus_tile=tile, idx_bits=geom["idx_bits"],
        lane_shuffle=geom["lane_shuffle"], reserve_bits=geom["reserve_bits"])
    check(bool((named[live] < n).all()),
          f"kernel 1 at D={corpus.shape[1]} names a padded item")
    named_scores = torch.gather(q_s.float() @ corpus.float().T, 1,
                                named.long().clamp(max=corpus.shape[0] - 1))
    named_keys = topk._packed_keys(named_scores, 0, geom["idx_bits"],
                                   geom["reserve_bits"],
                                   biased=geom["bias_in_dot"])
    named_steps = ((got_keys >> low) - (named_keys >> low))[live].abs().max()
    check(named_steps.item() <= 1, f"kernel 1 at D={corpus.shape[1]}: a key "
          f"is {named_steps.item()} quanta from the plain key of the item "
          "it names")
    b, d = q_s.shape
    n_pad = corpus.shape[0]
    wide_ms = cuda_ms(lambda: kernels.packed_scan(q_s, corpus, None, **geom))
    wide_plain_ms = cuda_ms(
        lambda: topk.packed_lane_scan_plain(q_s, corpus, None, **geom),
        iters=2)
    wide_bytes = b * d * 2 + n_pad * d * 2 + b * 2 * tile * 4 + b * 4
    wide_bound = max(wide_bytes / HBM_BYTES_PER_S * 1e3,
                     2 * b * n_pad * d / BF16_FLOPS * 1e3,
                     7 * b * n_pad / INT32_OPS * 1e3)
    print(f"history (b) fit: every item channel (Bloom ids, bias, a 16-item "
          f"CF bag, cf_rank 128) on {n} movies, 20 steps + validation "
          f"through `cli fit` in {wide_fit_s:.2f} s host wall (CF "
          f"factorization included); the {index.method!r} index at D="
          f"{index.dim}: {len(got_ids)} eval queries with the train "
          f"histories excluded == dense top-{top_k} of the lane-pair "
          f"survivors within one key quantum ({tight:.2e} scaled) [{card}]")
    print(f"history (b) kernel launches: {counts}")
    print(f"packed_scan at the widened row B={b} N={n_pad} D={d} ct={tile} "
          f"(trained index, eval users): keys and dmax within {steps} key "
          f"quantum of the plain version, and each key within "
          f"{named_steps.item()} of the plain key of the item it names; "
          f"kernel {wide_ms:.3f} ms, plain "
          f"{wide_plain_ms:.3f} ms, bound {wide_bound:.3f} ms [{card}]")
    kernels.reset_launch_counts()
    wide_engine = RecommenderEngine(wide_artifact, device=dev)
    served = served_user_answers(
        wide_engine, [int(u) for u in wide_engine.users.arrays["user_id"][:8]])
    add(kernels.launch_counts())
    # the loaded scan index takes its score bound from the stored bf16
    # rows, the trainer's from its f32 rows: the keys' scale differs in the
    # last bits, so the served answers are held against the loaded index
    worst_wide = check_served_users(wide, wide_engine, served, "history (b)",
                                    index=wide_engine.index)
    print(f"history (b) serving: the saved artifact (CF channel, bias, bag) "
          f"answers recommend_with_user_id for 8 users; each query vector "
          f"== the trainer's own (within {worst_wide:.1e}) and each answer == "
          f"the loaded index's search of it [{card}]")

    # (c) the serve CLI on the flagship's artifact, in its own process
    t0 = time.perf_counter()
    cli_run = subprocess.run(
        [sys.executable, "-m", "xfmr_rec_torch.serving.prepare",
         "--artifact_dir", str(artifact)],
        cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=600, check=False,
    )
    cli_s = time.perf_counter() - t0
    check(cli_run.returncode == 0
          and "golden-value checks passed" in cli_run.stderr,
          f"the serve CLI failed ({cli_run.returncode}):\n"
          f"{cli_run.stdout[-4000:]}\n{cli_run.stderr[-4000:]}")
    print(f"serve CLI: python -m xfmr_rec_torch.serving.prepare "
          f"--artifact_dir <the flagship artifact> exited 0 with its golden "
          f"checks passed in {cli_s:.2f} s wall (process start, engine load "
          f"and checks) [{card}]")
    return {"launches": launches, "wide": wide}


# ---------------------------------------------------------------------------
# phase 12: multi-device (the mesh, sharded search, the engine, training)
# ---------------------------------------------------------------------------
MESH_SIZE = 4
MESH_BATCHES = 3  # B=4096 batches a path a mesh, the first a warm-up
MESH_REQUESTS = 64
MESH_STEPS = 3
MESH_FIT_STEPS = 20
# sharded steps against the single-device steps (dropout off): the repo's
# parameter rule (PERF.md section 2)
MESH_PARAM_TOL = 5e-5


def mesh_devices(dev) -> tuple[list[torch.device], str]:
    """Four real cards when the machine has them, else a virtual mesh of
    four slots on one card."""
    if torch.cuda.device_count() >= MESH_SIZE:
        return ([torch.device("cuda", i) for i in range(MESH_SIZE)],
                f"{MESH_SIZE} cards")
    return [dev] * MESH_SIZE, (
        f"a virtual mesh of {MESH_SIZE} slots on {dev}: the shards' sweeps "
        "queue on one card one after another, so these times claim no "
        "scaling")


def sharded_tight(index, merge_levels: int) -> float:
    """One key quantum (scaled units) of a sharded packed search: the
    shard's tile bits plus the merge's reserved bits."""
    local = index.corpus.shape[0] // index.num_shards
    ct = topk.pick_corpus_tile(local, index.dim)
    idx_bits = max((local // ct - 1).bit_length(), 1)
    return quantum_scaled(idx_bits + merge_levels) + 1e-6


def check_sharded_certified(index, corpus_f, queries, ids, merge_levels,
                            what) -> int:
    """Certified sharded answers == dense exact top-k at the key quantum
    (rows the dense path answered: exact in the bf16 order). Returns the
    rows that took the dense path's test."""
    bound = index._score_bound(
        torch.from_numpy(queries).to(corpus_f.device, torch.bfloat16))
    return rows_off_quantum(corpus_f, index._corpus_maxnorm, queries, ids,
                            sharded_tight(index, merge_levels), what,
                            bound=bound)


def digest(*arrays) -> str:
    """sha256 of the arrays' bytes: two processes' answers compared."""
    h = hashlib.sha256()
    for array in arrays:
        if torch.is_tensor(array):
            array = array.detach().cpu().numpy()
        h.update(np.ascontiguousarray(array).tobytes())
    return h.hexdigest()


def mesh_search(index, corpus_f, batches, rng, what: str, card: str,
                hold: bool = True) -> tuple[dict, dict]:
    """On one sharded index: exclusion search, `search_certified` by both
    methods and the f32 `sharded_certified_topk`, every row held against
    dense top-k on the card (with `hold`; a process of a group whose
    answers another process holds passes False). Returns the mean host ms
    a batch by path, and the digest of each path's answers."""
    from xfmr_rec_torch.parallel.retrieval import sharded_certified_topk

    dev = corpus_f.device
    shards = index.num_shards
    ms, answers = {}, {}
    held = "every row == dense exact" if hold else "answers digested for"
    for method, merge in (("fused", 1), ("packed", 0)):
        index.search_certified(batches[0], top_k=BENCH_K, method=method)
        torch.cuda.synchronize()
        times, dense_rows, bad, got = [], 0, 0, []
        for queries in batches[1:]:
            t0 = time.perf_counter()
            _, ids = index.search_certified(queries, top_k=BENCH_K,
                                            method=method)
            times.append(time.perf_counter() - t0)
            got.append(ids)
            bad += index.last_certified_stats["pass1_bad"]
            if hold:
                dense_rows += check_sharded_certified(
                    index, corpus_f, queries, ids, merge,
                    f"{what} search_certified({method!r})")
        check(dense_rows <= bad, f"{what} {method}: rows off the quantum "
              "exceed the rows the dense path answered")
        ms[method] = 1e3 * sum(times) / len(times)
        answers[method] = digest(*got)
        print(f"{what} search_certified({method!r}): {held} "
              f"top-{BENCH_K} (one key quantum); {bad} rows to the dense "
              f"path; {ms[method]:.3f} ms a batch (host wall) [{card}]")

    # exclusion search: top-k of each shard's lane-pair survivors
    q_bf = torch.from_numpy(batches[1]).to(dev, torch.bfloat16)
    q_s = (q_bf.float() * (0.25 / index._score_bound(q_bf))).bfloat16()
    excl = []
    for start in range(0, len(q_bf), 512):
        top = torch.topk(q_s[start:start + 512].float() @ corpus_f.T, 3,
                         dim=1).indices.cpu().numpy()
        excl += [[int(p) for p in row] for row in top]
    excl = [row + [int(p) for p in rng.integers(0, len(corpus_f), 5)]
            for row in excl]
    t0 = time.perf_counter()
    _, got = index.search(batches[1], top_k=BENCH_K, exclude_ids=excl)
    ms["search"] = 1e3 * (time.perf_counter() - t0)
    answers["search"] = digest(got)
    ct = topk.pick_corpus_tile(index.corpus.shape[0] // shards, index.dim)
    got = torch.from_numpy(got.astype(np.int64)).to(dev)
    tight = sharded_tight(index, 1)
    for start in range(0, len(q_bf), 512) if hold else ():
        rows = slice(start, start + 512)
        check_exclusion_search(q_s[rows].float() @ corpus_f.T, ct,
                               excl[rows], got[rows], BENCH_K, tight,
                               f"{what} search", shards=shards)
    print(f"{what} search with 8 exclusions a row (each row's dense top-3 "
          f"among them): {held} top-{BENCH_K} of each shard's "
          f"lane-pair survivors (one key quantum); {ms['search']:.3f} ms "
          f"[{card}]")

    # the f32 certificate (kernel 3) over the same shards
    vals, pos, exact = sharded_certified_topk(q_bf, index.corpus, BENCH_K,
                                              index.mesh)
    answers["f32"] = digest(vals, pos, exact)
    certified = int(exact.sum())
    check(certified > 0, f"{what} f32: no row certified")
    rows = exact.nonzero().flatten()
    for start in range(0, len(rows), 512) if hold else ():
        sel = rows[start:start + 512]
        dense = q_bf[sel].float() @ corpus_f.T
        want = torch.topk(dense, BENCH_K, dim=1).values
        check(bool(((vals[sel] - want).abs() <= 1e-5).all()),
              f"{what} f32: certified values off dense top-k")
        at = torch.gather(dense, 1, pos[sel].long())
        check(bool(((at - vals[sel]).abs() <= 1e-5).all()),
              f"{what} f32: positions do not hold their values")
    print(f"{what} sharded_certified_topk (f32): {certified} of {len(q_bf)} "
          f"rows certified, {'each == dense top-' if hold else 'top-'}"
          f"{BENCH_K}{' within 1e-5' if hold else ' digested'} [{card}]")
    return ms, answers


def phase_mesh_search(dev, card: str, guaranteed: dict, devices,
                      note: str) -> dict:
    """(a) the guaranteed-search corpus split over 4 model shards, then
    over a 2 x 2 (data x model) mesh, and int8 on 4 shards."""
    from xfmr_rec_torch.index.sharded import ShardedRetrievalIndex
    from xfmr_rec_torch.parallel.mesh import create_mesh

    corpus_bf = guaranteed["corpus"]
    corpus_f = corpus_bf.float()
    ids = np.arange(BENCH_ITEMS)
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    batches = [
        torch.nn.functional.normalize(
            torch.randn(BENCH_BATCH, BENCH_DIM, device=dev, generator=g),
            dim=1).cpu().numpy()
        for _ in range(MESH_BATCHES)
    ]
    rng = np.random.default_rng(SEED + 12)
    single = guaranteed["index"]
    single.search_certified(batches[0], top_k=BENCH_K, method="fused")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for queries in batches[1:]:
        single.search_certified(queries, top_k=BENCH_K, method="fused")
    single_ms = 1e3 * (time.perf_counter() - t0) / (len(batches) - 1)
    print(f"mesh: {note}")
    kernels.reset_launch_counts()
    ms = {}
    for data, model in ((1, MESH_SIZE), (2, MESH_SIZE // 2)):
        mesh = create_mesh(model_parallel=model, devices=devices)
        index = ShardedRetrievalIndex(corpus_bf, ids, mesh=mesh)
        check(index.num_shards == model and mesh.shape["data"] == data,
              "the mesh is not the asked shape")
        ms[(data, model)], _ = mesh_search(
            index, corpus_f, batches, rng,
            f"sharded {data}x{model} ({BENCH_ITEMS} x {BENCH_DIM} bf16, "
            f"B={BENCH_BATCH})", card)
        del index
    mesh = create_mesh(model_parallel=MESH_SIZE, devices=devices)
    index8 = ShardedRetrievalIndex(corpus_bf, ids, mesh=mesh, dtype="int8")
    deq = index8.dequantized(dev)
    index8.search_certified(batches[0], top_k=BENCH_K)
    bad = dense_rows = 0
    for queries in batches[1:]:
        _, got = index8.search_certified(queries, top_k=BENCH_K)
        bad += index8.last_certified_stats["pass1_bad"]
        dense_rows += check_sharded_certified(
            index8, deq, queries, got, 1, "sharded int8 search_certified")
    check(dense_rows <= bad, "int8: rows off the quantum exceed the dense "
          "path's rows")
    print(f"sharded 1x{MESH_SIZE} int8: search_certified('fused') every row "
          f"== dense exact top-{BENCH_K} over the dequantized rows (one key "
          f"quantum); {bad} rows to the dense path [{card}]")
    del index8, deq
    launches = kernels.launch_counts()
    print(f"mesh search kernel launches: {launches}")
    for name in ("packed_scan", "threshold_select", "lane_max_scan"):
        check(launches[name] > 0, f"the sharded paths never launched {name}")
    for (data, model), row in ms.items():
        print(f"sharded {data}x{model} ms a batch of {BENCH_BATCH}: "
              f"search_certified('fused') {row['fused']:.3f}, ('packed') "
              f"{row['packed']:.3f}, search {row['search']:.3f}; the single "
              f"card's search_certified('fused') {single_ms:.3f} (host wall, "
              f"this call; {note}) [{card}]")
    return {"launches": launches, "ms": ms, "single_ms": single_ms}


def phase_mesh_engine(dev, card: str, serve_root: pathlib.Path, devices,
                      texts: list[str]) -> None:
    """(b) the served artifact behind `index_kind="sharded"`: 64 requests
    in one burst over HTTP (micro-batched), each answered as the exact
    engine answers it; `add_items` refused."""
    from xfmr_rec_torch.parallel.mesh import create_mesh

    t0 = time.perf_counter()
    engine = RecommenderEngine(
        serve_root, index_kind="sharded", device=dev,
        mesh=create_mesh(model_parallel=MESH_SIZE, devices=devices))
    exact = RecommenderEngine(serve_root, device=dev)
    load_s = time.perf_counter() - t0
    service = RecService(engine, micro_batch=MESH_REQUESTS,
                         micro_batch_wait_ms=20)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(SEED + 13)
    requests = [item_text(rng, i) for i in range(MESH_REQUESTS)]
    thread.start()
    try:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(MESH_REQUESTS) as pool:
            futures = [pool.submit(post_json, base, "recommend_with_query",
                                   {"query": {"text": t}, "top_k": 10})
                       for t in requests]
            served = [f.result(timeout=300) for f in futures]
        burst_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    # a batched request shares the batch's score bound (the bf16 query
    # moves by up to a rounding step): held within 1e-2 of a unit score,
    # as the serving phase holds its burst
    loose = 1e-2
    same = 0
    for text, body in zip(requests, served, strict=True):
        want = exact.search_items(Query(text=text), top_k=10)
        got_ids = [c["movie_id"] for c in body]
        want_ids = [c.movie_id for c in want]
        same += got_ids == want_ids
        check(len(got_ids) == len(want_ids), "a sharded answer is short")
        check(all(abs(c["score"] - w.score) <= loose
                  for c, w in zip(body, want, strict=True)),
              "sharded scores off the exact engine's")
        firm = {w.movie_id for w in want if w.score > want[-1].score + 2 * loose}
        check(firm <= set(got_ids), "the sharded engine missed a firm item")
    refused = False
    try:
        engine.add_items([ItemQuery(movie_rn=0, movie_id=-5, movie_text="x")])
    except RuntimeError:
        refused = True
    check(refused, "add_items answered under index_kind='sharded'")
    print(f"sharded engine ({MESH_SIZE} model shards of {len(texts)} served "
          f"items; both engines loaded in {load_s:.2f} s): "
          f"{MESH_REQUESTS} requests in one burst in {burst_s:.2f} s host "
          f"wall, every answer the exact engine's within {loose} (the same "
          f"lists in {same}); add_items refused [{card}]")


def phase_mesh_training(dev, card: str, train_root: pathlib.Path, devices,
                        note: str) -> None:
    """(c) the reference config: 3 steps on a 4-device mesh and 3 with
    `shard_vocab` at model_parallel=2, each held to the single-device
    steps; the step's ms beside the single device's; then `Trainer.fit`
    with `mesh=True, model_parallel=2` and one validation through the
    sharded eval."""
    from xfmr_rec_torch.data.module import DataConfig
    from xfmr_rec_torch.parallel import (
        create_mesh,
        make_sharded_train_step,
        shard_batch,
    )
    from xfmr_rec_torch.parallel.train import gathered_state_dict, place_state
    from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig

    data = RecDataModule(DataConfig(data_dir=str(train_root / "ml1m")))
    data.setup()
    batches = [b for _, b in zip(range(MESH_STEPS), data.train_batches(0))]
    config = dataclasses.replace(train_mod.TrainConfig(), dropout_rate=0.0)
    single = train_mod.TrainState(config, seed=SEED, device=dev)
    want = [train_mod.train_step(single, train_mod.batch_to_device(b, dev))
            for b in batches]
    single_params = {n: v.clone() for n, v in single.model.state_dict().items()}
    one_batch = train_mod.batch_to_device(batches[0], dev)
    one_ms = cuda_ms(lambda: train_mod.train_step(single, one_batch),
                     iters=10, warmup=2)
    for model_parallel, shard_vocab in ((1, False), (2, True)):
        mesh = create_mesh(model_parallel=model_parallel, devices=devices)
        state = train_mod.TrainState(config, seed=SEED, device=dev)
        place_state(state, mesh, config, shard_vocab=shard_vocab)
        step = make_sharded_train_step(config, mesh, shard_vocab=shard_vocab,
                                       state=state)
        worst_loss = 0.0
        for batch, one in zip(batches, want, strict=True):
            got = step(state, shard_batch(batch, mesh))
            for key, value in one.items():
                diff = abs(float(got[key]) - float(value))
                worst_loss = max(worst_loss, diff / max(abs(float(value)), 1))
                check(diff <= 1e-5 + 1e-4 * abs(float(value)),
                      f"mesh step {key}: {float(got[key])} vs {float(value)}")
        params = gathered_state_dict(state.model)
        worst = max((params[n] - v).abs().max().item()
                    for n, v in single_params.items())
        check(worst <= MESH_PARAM_TOL,
              f"mesh steps' parameters differ by {worst}")
        what = (f"{mesh.shape['data']}x{mesh.shape['model']} mesh"
                + (", shard_vocab" if shard_vocab else ""))
        batch = shard_batch(batches[0], mesh)
        mesh_ms = cuda_ms(lambda: step(state, batch), iters=10, warmup=2)
        print(f"training on a {what}: {MESH_STEPS} steps of the reference "
              f"config (dropout off) == the single-device steps (losses "
              f"within {worst_loss:.2e} relative, parameters within "
              f"{worst:.2e}); a step at batch {len(batches[0]['target'])}: "
              f"{mesh_ms:.3f} ms against {one_ms:.3f} ms on one device "
              f"(CUDA events; {note}) [{card}]")
    t0 = time.perf_counter()
    trainer = Trainer(
        train_mod.TrainConfig(), data=data,
        trainer_config=TrainerConfig(
            mesh=True, model_parallel=2, max_steps=MESH_FIT_STEPS,
            checkpointing=False, log_dir=str(train_root / "runs"),
            run_name="mesh", seed=SEED),
        device=dev, devices=devices)
    val = trainer.fit()
    fit_s = time.perf_counter() - t0
    check(trainer.global_step == MESH_FIT_STEPS, "the mesh fit stopped early")
    check(trainer._sharded_corpus is not None, "the eval corpus is not split")
    retrieval = {k: v for k, v in val.items() if "/Retrieval" in k}
    check(len(retrieval) == 6
          and all(0.0 <= v <= 1.0 for v in retrieval.values()),
          f"mesh fit metrics out of range: {val}")
    check(all(math.isfinite(v) for v in val.values()), "mesh fit: not finite")
    print(f"Trainer.fit(mesh=True, model_parallel=2): {MESH_FIT_STEPS} steps "
          f"and one validation through sharded_topk over the split corpus "
          f"in {fit_s:.2f} s host wall; val/RetrievalNormalizedDCG "
          f"{val['val/RetrievalNormalizedDCG']:.4f} [{card}]")


def phase_mesh(dev, card: str, guaranteed: dict, serve_root: pathlib.Path,
               texts: list[str], train_root: pathlib.Path) -> dict:
    devices, note = mesh_devices(dev)
    search = phase_mesh_search(dev, card, guaranteed, devices, note)
    phase_mesh_engine(dev, card, serve_root, devices, texts)
    phase_mesh_training(dev, card, train_root, devices, note)
    return search

# ---------------------------------------------------------------------------
# phase 14: many processes (a process group over the card)
# ---------------------------------------------------------------------------
MP_WORLD = 2
MP_SLOTS = 2  # mesh slots a process (four in all, as phase 12's mesh)
MP_BATCHES = 2  # B=4096 batches a path a mesh, the first a warm-up
MP_REQUESTS = 64
MP_STEPS = 3
MP_TIMEOUT_S = 300  # a worker's wall, its start included
MP_LOOSE = 1e-2  # a served score against the exact engine's (phase 12's)
# step 1 of the bf16 step over the processes against one device's, before
# Adam amplifies the rounding of half-batch passes: every metric (losses
# and the gradient norm) within this gap, relative (absolute below 1; the
# H100 readings behind it are in PERF.md)
MP_BF16_STEP1_RTOL = 1e-4


def mp_corpus(dev) -> torch.Tensor:
    """Phase 5's corpus, drawn again from its seed: (N, D) bf16 rows."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    return torch.nn.functional.normalize(
        torch.randn(BENCH_ITEMS, BENCH_DIM, device=dev, generator=g), dim=1
    ).bfloat16()


def mp_search(dev, rank: int, spec: dict, card: str, say) -> dict:
    """(a) phase 5's corpus in a `ShardedRetrievalIndex` over a 1 x 4 mesh
    (the model axis across the processes) and a 2 x 2 one (each model row
    inside a process, the reference's layout): phase 12's searches, held
    to dense top-k by process 0; every process's answers digested."""
    from xfmr_rec_torch.index.sharded import ShardedRetrievalIndex
    from xfmr_rec_torch.parallel.mesh import create_mesh

    corpus_bf = mp_corpus(dev)
    check(digest(corpus_bf.view(torch.int16)) == spec["corpus"],
          "the worker's corpus is not phase 5's")
    corpus_f = corpus_bf.float()
    root = pathlib.Path(spec["root"])
    batches = [np.load(root / f"queries_{i}.npy") for i in range(MP_BATCHES)]
    out = {}
    for data, model in ((1, MESH_SIZE), (2, MESH_SIZE // 2)):
        mesh = create_mesh(model_parallel=model, devices=[dev] * MP_SLOTS)
        crosses = [len(set(row)) > 1 for row in mesh.owners.tolist()]
        check(mesh.shape == {"data": data, "model": model}
              and all(crosses) == (model > MP_SLOTS),
              f"the process mesh is not the asked layout: {mesh}")
        index = ShardedRetrievalIndex(corpus_bf, np.arange(BENCH_ITEMS),
                                      mesh=mesh)
        tag = f"{data}x{model}"
        out[tag] = mesh_search(
            index, corpus_f, batches, np.random.default_rng(SEED + 14),
            f"[p{rank}] {MP_WORLD}-process {tag} ({BENCH_ITEMS} x "
            f"{BENCH_DIM} bf16, B={BENCH_BATCH})", card, hold=rank == 0)
        if data > 1:
            out[tag][0].update(data_sharded_search(index, batches[1], card,
                                                   say))
        del index
    launches = kernels.launch_counts()
    say(f"(a) kernel launches of this process: {launches}")
    for name in ("packed_scan", "threshold_select", "lane_max_scan"):
        check(launches[name] > 0, f"process {rank} never launched {name}")
    return {tag: {"ms": ms, "answers": answers}
            for tag, (ms, answers) in out.items()}


def data_sharded_search(index, queries: np.ndarray, card: str,
                        say) -> dict:
    """The packed search (no exclusions) with the batch split over the
    data axis (each process sweeping its own rows; the index replicates
    queries across processes, the reference's rule): the replicated
    call's answer bit for bit, and each process's own rows
    `process_allgather`ed back to it. Returns the host ms of both."""
    from xfmr_rec_torch.parallel.mesh import process_allgather
    from xfmr_rec_torch.parallel.retrieval import sharded_packed_topk_excluding

    mesh = index.mesh
    q = torch.from_numpy(queries).to(mesh.lead, torch.bfloat16)
    kw = dict(score_bound=index._score_bound(q))
    ms, answers = {}, {}
    for split in (False, True):
        for _ in range(2):  # a warm-up, then the timed call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers[split] = sharded_packed_topk_excluding(
                q, index.corpus, BENCH_K, mesh, shard_queries=split, **kw)
            torch.cuda.synchronize()
            ms[split] = 1e3 * (time.perf_counter() - t0)
    want, got = answers[False], answers[True]
    check(all(torch.equal(g, w) for g, w in zip(got, want, strict=True)),
          "the data-sharded search differs from the replicated one")
    per = len(q) // mesh.shape["data"]
    own = torch.cat([got[1][i * per:(i + 1) * per]
                     for i in range(mesh.shape["data"]) if mesh.owns_row(i)])
    check(torch.equal(process_allgather(own.cpu(), tiled=True),
                      got[1].cpu()),
          "process_allgather of the processes' own rows is not the answer")
    say(f"(a) packed search (no exclusions) with the batch split over the "
        f"data axis (shard_queries=True): the replicated answer bit for "
        f"bit, each process's own rows process_allgather'ed back; "
        f"{ms[True]:.3f} ms against {ms[False]:.3f} ms replicated [{card}]")
    return {"split": ms[True], "replicated": ms[False]}


def mp_serve(dev, rank: int, spec: dict, card: str, say) -> dict:
    """(b) phase 4's artifact behind `index_kind="sharded"` over a 1 x 4
    mesh: 64 requests through `RecService`'s handlers in every process,
    in one order, each held to the exact engine's answer."""
    from xfmr_rec_torch.parallel.mesh import create_mesh

    mesh = create_mesh(model_parallel=MP_WORLD * MP_SLOTS,
                       devices=[dev] * MP_SLOTS)
    t0 = time.perf_counter()
    engine = RecommenderEngine(spec["serve_root"], index_kind="sharded",
                               device=dev, mesh=mesh)
    load_s = time.perf_counter() - t0
    service = RecService(engine)
    expected = json.loads(pathlib.Path(spec["exact"]).read_text())
    served, same = [], 0
    t0 = time.perf_counter()
    for text in expected:
        served.append(service.recommend_with_query(Query(text=text), top_k=10))
    wall = time.perf_counter() - t0
    for body, (want_ids, want_scores) in zip(served, expected.values(),
                                             strict=True):
        got_ids = [c.movie_id for c in body]
        same += got_ids == want_ids
        check(len(got_ids) == len(want_ids), "a sharded answer is short")
        check(all(abs(c.score - w) <= MP_LOOSE
                  for c, w in zip(body, want_scores, strict=True)),
              "sharded scores off the exact engine's")
        firm = {i for i, w in zip(want_ids, want_scores, strict=True)
                if w > want_scores[-1] + 2 * MP_LOOSE}
        check(firm <= set(got_ids), "the sharded engine missed a firm item")
    say(f"(b) sharded engine over {mesh.shape} ({SERVE_ITEMS} served items, "
        f"loaded in {load_s:.2f} s): {len(served)} requests one after "
        f"another through RecService in {wall:.2f} s host wall, each the "
        f"exact engine's within {MP_LOOSE} (the same lists in {same}) "
        f"[{card}]")
    return {"answers": digest(np.array([[c.movie_id for c in body]
                                        for body in served]),
                              np.array([[c.score for c in body]
                                        for body in served])),
            "wall_s": wall}


def mp_train(dev, rank: int, spec: dict, card: str, say) -> dict:
    """(c) the reference config, then the flagship history tower, both in
    f32: 3 steps on a 4 x 1 mesh over the processes against 3
    single-device steps from the same init, held to `MESH_PARAM_TOL`;
    then the reference config in bf16, the port's default, whose step 1
    is held to `MP_BF16_STEP1_RTOL` (the halves of the batch that each
    process encodes round otherwise than the whole batch does, and Adam's
    sign steps lift that to lr by step 3: that parameter gap is only
    reported); the step's ms beside one device's."""
    from xfmr_rec_torch.parallel import make_sharded_train_step, shard_batch
    from xfmr_rec_torch.parallel.mesh import create_mesh
    from xfmr_rec_torch.parallel.train import gathered_state_dict, place_state

    saved = torch.load(spec["batches"], weights_only=False)
    out = {}
    for name, model_kw, dtype in (("reference", {}, "float32"),
                                  ("flagship", FLAGSHIP, "float32"),
                                  ("reference-bf16", {}, "bfloat16")):
        config = dataclasses.replace(train_mod.TrainConfig(**model_kw),
                                     dropout_rate=0.0, compute_dtype=dtype)
        batches = saved[name.removesuffix("-bf16")]
        single = train_mod.TrainState(config, seed=SEED, device=dev)
        want = [train_mod.train_step(single, train_mod.batch_to_device(b, dev))
                for b in batches]
        state = train_mod.TrainState(config, seed=SEED, device=dev)
        mesh = create_mesh(model_parallel=1, devices=[dev] * MP_SLOTS)
        place_state(state, mesh, config)
        step = make_sharded_train_step(config, mesh, state=state)
        worst_loss, step1 = 0.0, 0.0
        for index, (batch, one) in enumerate(zip(batches, want, strict=True)):
            got = step(state, shard_batch(batch, mesh))
            for key, value in one.items():
                diff = abs(float(got[key]) - float(value))
                worst_loss = max(worst_loss, diff / max(abs(float(value)), 1))
                if dtype == "float32":
                    check(diff <= 1e-5 + 1e-4 * abs(float(value)),
                          f"{name} step {key}: {float(got[key])} vs "
                          f"{float(value)}")
                elif index == 0:
                    step1 = max(step1, diff / max(abs(float(value)), 1))
        check(step1 <= MP_BF16_STEP1_RTOL,
              f"{name} step 1: the metrics differ by {step1:.3e} relative")
        params = gathered_state_dict(state.model)
        theirs = single.model.state_dict()
        worst = max((params[n] - v).abs().max().item()
                    for n, v in theirs.items())
        check(dtype != "float32" or worst <= MESH_PARAM_TOL,
              f"{name}: the process mesh's parameters differ by {worst}")
        first = shard_batch(batches[0], mesh)
        mesh_ms = cuda_ms(lambda: step(state, first), iters=10, warmup=2)
        one = train_mod.batch_to_device(batches[0], dev)
        one_ms = cuda_ms(lambda: train_mod.train_step(single, one), iters=10,
                         warmup=2)
        held = (f"step 1's losses and gradient norm within {step1:.3e} "
                f"(bound {MP_BF16_STEP1_RTOL}); over the {MP_STEPS} "
                if dtype == "bfloat16" else "")
        say(f"(c) {name} config ({dtype}) on a {mesh.shape['data']}x"
            f"{mesh.shape['model']} process mesh: {MP_STEPS} steps (dropout "
            f"off) against the single-device steps: {held}losses within "
            f"{worst_loss:.3e} relative, parameters within {worst:.3e}; a "
            f"step at batch {len(batches[0]['target'])}: {mesh_ms:.3f} ms "
            f"against {one_ms:.3f} ms on one device (CUDA events) [{card}]")
        out[name] = {"params": digest(*(params[n] for n in sorted(params))),
                     "ms": mesh_ms, "single_ms": one_ms}
    return out


def mp_checkpoint(dev, rank: int, spec: dict, phase: str, say) -> dict:
    """(d) the reference config (dropout on) through `Trainer(mesh=True)`
    over the processes. Group A: 2 steps, `save_checkpoint` (the first
    process writes), step 3. Group B, fresh: restore, step 3."""
    from xfmr_rec_torch.parallel.train import gathered_state_dict

    root = pathlib.Path(spec["root"])
    trainer = Trainer(
        train_mod.TrainConfig(),
        data=RecDataModule(DataConfig(data_dir=str(root / "ckpt_data"))),
        trainer_config=TrainerConfig(
            mesh=True, model_parallel=2, log_dir=str(root / "runs"),
            run_name="mp_ckpt", ckpt_dir=str(root / "ckpt"), seed=SEED),
        device=dev, devices=[dev] * MP_SLOTS)
    trainer.setup()
    batches = [b for _, b in zip(range(3), trainer.data.train_batches(0))]
    if phase == "a":
        for batch in batches[:2]:
            trainer.train_step(batch)
        trainer.save_checkpoint("step2")
    else:
        trainer.restore_checkpoint("step2")
        check(trainer.global_step == 2, "the restored step is not 2")
    loss = float(trainer.train_step(batches[2])["train/PairwiseHingeLoss"])
    check(math.isfinite(loss), "the step-3 loss is not finite")
    params = gathered_state_dict(trainer.state.model)
    say(f"(d) group {phase.upper()}: step 3 loss {loss!r} on a "
        f"{trainer.mesh.shape} mesh over the processes")
    return {"loss": loss.hex(),
            "params": digest(*(params[n] for n in sorted(params)))}


def worker_main(argv: list[str]) -> int:
    """One process of phase 14 (`chip_smoke.py --worker <rank> <spec>`):
    joins the group, runs (a)-(d), writes `worker_<rank>.json`. Prints
    no result line."""
    from xfmr_rec_torch.parallel.mesh import (
        describe_transport,
        initialize_distributed,
        shutdown_distributed,
    )

    rank, spec_path = int(argv[0]), pathlib.Path(argv[1])
    spec = json.loads(spec_path.read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def say(msg: str) -> None:
        print(f"[p{rank}] {msg}", flush=True)

    t_start = time.perf_counter()
    # "cuda": the card LOCAL_RANK (here the rank) names, modulo the cards
    dev = initialize_distributed(spec["init"][0], MP_WORLD, rank,
                                 device=spec["device"])
    try:
        card = card_line()
        say(f"joined a group of {MP_WORLD} processes on {dev} "
            f"({torch.cuda.device_count()} card(s) visible): "
            f"{describe_transport()}")
        # the library phase 1 built; this process builds nothing
        check(pathlib.Path(spec["library"]).exists()
              and str(kernels.build()) == spec["library"],
              "the worker did not find the built kernel library")
        kernels.load()
        kernels.reset_launch_counts()
        result = {"rank": rank, "transport": describe_transport()}
        t0 = time.perf_counter()
        result["search"] = mp_search(dev, rank, spec, card, say)
        result["search_s"] = time.perf_counter() - t0
        result["serve"] = mp_serve(dev, rank, spec, card, say)
        result["train"] = mp_train(dev, rank, spec, card, say)
        result["ckpt_a"] = mp_checkpoint(dev, rank, spec, "a", say)
        shutdown_distributed()
        initialize_distributed(spec["init"][1], MP_WORLD, rank,
                               device=spec["device"])
        result["ckpt_b"] = mp_checkpoint(dev, rank, spec, "b", say)
        result["launches"] = kernels.launch_counts()
    finally:
        shutdown_distributed()
    result["wall_s"] = time.perf_counter() - t_start
    (spec_path.parent / f"worker_{rank}.json").write_text(json.dumps(result))
    say(f"done in {result['wall_s']:.1f} s")
    return 0


def mp_inputs(dev, root: pathlib.Path, serve_root: pathlib.Path,
              train_root: pathlib.Path) -> dict:
    """What the workers read: the query batches, the exact engine's
    answers to the 64 requests, 3 training batches of each config, and a
    small prepared corpus for the checkpoint cycle."""
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    for i in range(MP_BATCHES):
        np.save(root / f"queries_{i}.npy", torch.nn.functional.normalize(
            torch.randn(BENCH_BATCH, BENCH_DIM, device=dev, generator=g),
            dim=1).cpu().numpy())
    exact = RecommenderEngine(serve_root, device=dev)
    rng = np.random.default_rng(SEED + 15)
    answers = {}
    for i in range(MP_REQUESTS):
        text = item_text(rng, i)
        want = exact.search_items(Query(text=text), top_k=10)
        answers[text] = ([c.movie_id for c in want], [c.score for c in want])
    write_json(root / "exact.json", answers)
    del exact
    batches = {}
    for name, model_kw in (("reference", {}), ("flagship", FLAGSHIP)):
        widths = {"max_history": FLAGSHIP["max_history"]} if model_kw else {}
        data = RecDataModule(DataConfig(data_dir=str(train_root / "ml1m"),
                                        **widths))
        data.setup()
        batches[name] = [b for _, b in zip(range(MP_STEPS),
                                           data.train_batches(0))]
    torch.save(batches, root / "batches.pt")
    RecDataModule(DataConfig(data_dir=str(root / "ckpt_data"))).prepare_data()
    return {"exact": str(root / "exact.json"),
            "batches": str(root / "batches.pt")}


def mp_answers(result: dict) -> dict:
    """A worker's digests: every path's answers, the served lists, the
    trained parameters."""
    out = {f"search {tag} {path}": value
           for tag, part in result["search"].items()
           for path, value in part["answers"].items()}
    out["serve"] = result["serve"]["answers"]
    out.update({f"train {name}": part["params"]
                for name, part in result["train"].items()})
    return out


def phase_multiprocess(dev, card: str, guaranteed: dict, mesh: dict,
                       serve_root: pathlib.Path, train_root: pathlib.Path,
                       lib_path: pathlib.Path) -> dict:
    """Phase 14: two processes on the card (two mesh slots each) joined by
    `initialize_distributed`, (a)-(d) in each (`worker_main`); their
    answers the same bits, their launches added up."""
    t_phase = time.perf_counter()
    root = train_root / "multiprocess"
    root.mkdir()
    spec = {
        "root": str(root),
        "device": dev.type,
        "serve_root": str(serve_root),
        "library": str(lib_path),
        "corpus": digest(guaranteed["corpus"].view(torch.int16)),
        "init": [f"file://{root / 'store_a'}", f"file://{root / 'store_b'}"],
        **mp_inputs(dev, root, serve_root, train_root),
    }
    spec_path = write_json(root / "spec.json", spec)
    setup_s = time.perf_counter() - t_phase
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker",
         str(rank), str(spec_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(MP_WORLD)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=MP_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, out) in enumerate(zip(procs, outs, strict=True)):
        print(out.rstrip())
        check(proc.returncode == 0,
              f"phase 14: worker {rank} exited {proc.returncode}")
    results = [json.loads((root / f"worker_{rank}.json").read_text())
               for rank in range(MP_WORLD)]
    first, second = results
    theirs = mp_answers(second)
    for key, value in mp_answers(first).items():
        check(theirs[key] == value, f"phase 14 ({key}): the processes' "
              "answers differ")
    for result in results:
        check(result["ckpt_a"] == result["ckpt_b"],
              f"phase 14 (d): process {result['rank']}'s resumed step 3 is "
              "not the uninterrupted one, bit for bit")
    check(first["ckpt_a"] == second["ckpt_a"],
          "phase 14 (d): the processes' step-3 states differ")
    launches = {name: sum(r["launches"][name] for r in results)
                for name in kernels.LAUNCHES}
    print(f"multi-process: {MP_WORLD} processes x {MP_SLOTS} slots on "
          f"{dev} over {first['transport']}; every answer, parameter and "
          f"step-3 state the same bits in both; launches of kernels 1 / 2 / "
          f"3 by process: "
          + ", ".join(f"p{r['rank']} {r['launches']['packed_scan']} / "
                      f"{r['launches']['threshold_select']} / "
                      f"{r['launches']['lane_max_scan']}" for r in results))
    phase12 = mesh["ms"]
    for tag, part in first["search"].items():
        data, model = map(int, tag.split("x"))
        ms, one = part["ms"], phase12[(data, model)]
        split = (f"; the packed search without exclusions, the batch split "
                 f"over the data axis {ms['split']:.3f} against replicated "
                 f"{ms['replicated']:.3f}" if "split" in ms else "")
        print(f"{MP_WORLD}-process {tag} ms a batch of {BENCH_BATCH}: "
              f"search_certified('fused') {ms['fused']:.3f}, ('packed') "
              f"{ms['packed']:.3f}, search {ms['search']:.3f}{split}; phase 12's "
              f"one-process {tag} virtual mesh {one['fused']:.3f}, "
              f"{one['packed']:.3f}, {one['search']:.3f} (host wall; four "
              f"slots on one card either way, so no scaling is claimed) "
              f"[{card}]")
    for name, part in first["train"].items():
        print(f"{MP_WORLD}-process step of the {name} config at batch 32: "
              f"{part['ms']:.3f} ms against {part['single_ms']:.3f} ms on "
              f"one device (CUDA events, process 0) [{card}]")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 14: {phase_s:.1f} s ({setup_s:.1f} s of it the inputs; "
          f"workers {first['wall_s']:.1f} / {second['wall_s']:.1f} s, "
          f"(a) {first['search_s']:.1f} s)")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 13: tuning and the recommend surface
# ---------------------------------------------------------------------------
TUNE_CONFIGS = 4
# rungs of 40, 80 and 160 train steps (limit_train_batches as a count)
TUNE_RUNGS = (40, 160)
TUNE_TRAINER = {"limit_val_batches": 2, "limit_val_loss_batches": 1,
                "val_check_interval": 1.0, "checkpointing": False,
                "seed": SEED}
# a worker's trial against the in-process trial of the same config on
# the same card: every metric it returns (the retrieval metrics, at most
# 5e-4 at these lengths, and the val loss family, of order 1 to 25)
# within TUNE_ABS_TOL + TUNE_REL_TOL * |in-process value|. The embedding
# backward sums with atomics, so no bit equality is claimed; the H100
# readings behind these bounds are in PERF.md
TUNE_ABS_TOL = 1e-5
TUNE_REL_TOL = 1e-4
PROBE_STEPS = 10
RECOMMEND_QUERIES = 64


def probe_trial(config: dict, resource: float) -> dict:
    """A trial worker's view (the executor's `"import"` spec): its pid,
    the cards it sees, and the kernel-1 launches of one trainer trial of
    the default point of `resource` steps on `config["data_dir"]`."""
    kernels.reset_launch_counts()
    metrics = hpo.make_trainer_evaluator(
        base_data={"data_dir": config["data_dir"]},
        base_trainer={**TUNE_TRAINER, "log_dir": config["log_dir"],
                      "run_name": "probe"},
        device=config["device"],
    )(hpo.SearchSpace().default_point(), int(resource))
    return {**metrics, "pid": float(os.getpid()),
            "device_count": float(torch.cuda.device_count()),
            "packed_scan": float(kernels.launch_counts()["packed_scan"])}


def metric_gap(got: dict, want: dict) -> tuple[float, float]:
    """The largest |got - want| over a trial's metrics, and the largest
    such difference over its bound (TUNE_ABS_TOL + TUNE_REL_TOL * |want|;
    above 1 is out of bounds)."""
    check(set(got) == set(want), f"metric names differ: {sorted(got)} "
          f"against {sorted(want)}")
    diffs = [abs(got[k] - want[k]) for k in want]
    ratios = [abs(got[k] - want[k]) / (TUNE_ABS_TOL + TUNE_REL_TOL
                                       * abs(want[k])) for k in want]
    return max(diffs), max(ratios)


def raw_text_queries(trainer, texts: list[str]) -> torch.Tensor:
    """Query rows of raw texts built from the index's column layout,
    apart from the trainer's own assembly: the text embedding, then 1
    against the bias column (`item_bias`), then zero CF columns and the
    popularity weight (a CF channel)."""
    q = trainer.embed_texts(texts)
    cols = [q]
    if trainer.config.item_bias:
        cols.append(torch.ones_like(q[:, :1]))
    if trainer.cf is not None:
        cols.append(q.new_zeros((len(texts), trainer.cf.rank)))
        cols.append(torch.full_like(q[:, :1], trainer.config.cf_pop_weight))
    out = torch.cat(cols, dim=1)
    check(out.shape[1] == trainer.index.dim, f"raw-text rows of "
          f"{out.shape[1]} columns against a {trainer.index.dim}-column "
          f"index")
    return out


def check_recommend(trainer, lists, queries, exclude, top_k, what) -> None:
    """Each list of `recommend` / `recommend_users` against dense exact
    top-k on the card of the trainer's own query vectors over the index's
    rows, within one key quantum (`check_exclusion_search`), no excluded
    id in it."""
    index = trainer.index
    check(index.method == "scan", f"{what}: the index is {index.method!r}")
    check(all(len(row) == top_k for row in lists), f"{what}: short list")
    got_pos = torch.tensor(
        [[index._id_to_pos[c["movie_id"]] for c in row] for row in lists],
        device=index.device)
    excl = [[index._id_to_pos[int(i)] for i in ids] for ids in exclude]
    for row, ids in zip(lists, exclude, strict=True):
        check(not {c["movie_id"] for c in row} & set(map(int, ids)),
              f"{what}: an excluded id came back")
    dense = scaled_queries(index, queries).float() @ index.corpus.float().T
    tight = quantum_scaled(index_quantum_bits(index)) + 1e-6
    check_exclusion_search(dense, index._scan_setup()[2], excl, got_pos,
                           top_k, tight, what)


def phase_tuning(dev, card: str, root: pathlib.Path, wide) -> dict:
    """(a) `tune` in the process through `make_trainer_evaluator` on phase
    9's 2^17-item catalogue (every validation on kernel 1): 4 configs, the
    default point first, three rungs; (b) a `TrialExecutor` on the card
    (clamped to the cards present) runs (a)'s first rung in a spawned
    worker, and a probe trial shows the worker ran on the card; (c) the
    recommend surface on the winner's trainer, `cli predict --user_id` in
    a subprocess, and `recommend` with a raw text on phase 10 (b)'s
    item-channel trainer. Every list is held against dense top-k."""
    t_phase = time.perf_counter()
    data_dir = root / "scan"
    steps_per_epoch = int(load_table(data_dir, "ratings")["is_train"]
                          .sum()) // 32
    base_data = {"data_dir": str(data_dir)}
    base_trainer = {**TUNE_TRAINER, "log_dir": str(root / "tune_runs")}
    log_path = root / "tune" / "trials.jsonl"
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = hpo.tune(
        hpo.make_trainer_evaluator(base_data=base_data,
                                   base_trainer=base_trainer,
                                   device=str(dev)),
        num_samples=TUNE_CONFIGS, min_resource=TUNE_RUNGS[0],
        max_resource=TUNE_RUNGS[1], reduction_factor=2, seed=SEED,
        log_path=log_path,
    )
    tune_s = time.perf_counter() - t0
    tune_launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    resources = sorted({t.resource for t in result.trials})
    check(resources == [40, 80, 160], f"rungs at {resources}")
    check([sum(t.resource == r for t in result.trials) for r in resources]
          == [4, 2, 1], "the rungs did not halve 4 -> 2 -> 1")
    check(result.trials[0].config == hpo.SearchSpace().default_point(),
          "the first trial is not the default point")
    metric = hpo.METRIC["name"]
    for t in result.trials:
        check(bool(t.metrics) and math.isfinite(t.metrics.get(metric, -1.0))
              and 0.0 <= t.metrics[metric] <= 1.0,
              f"trial {t.trial_id} failed or has no finite {metric} "
              f"in [0, 1]: {t.metrics}")
    validations = sum(
        metric in json.loads(line)
        for path in (root / "tune_runs").glob("*/metrics.jsonl")
        for line in path.read_text().splitlines())
    check(validations >= len(result.trials),
          f"{validations} validations for {len(result.trials)} trials")
    check(tune_launches["packed_scan"] >= validations,
          f"kernel 1 launched {tune_launches['packed_scan']} times over "
          f"{validations} validations")
    logged = [json.loads(line) for line in log_path.read_text().splitlines()]
    check([(r["trial_id"], r["config"], r["resource"], r["metric"])
           for r in logged] == [(t.trial_id, t.config, t.resource, t.metric)
                                for t in result.trials],
          "the trial log does not read back to the trials")
    sampler = hpo.AdaptiveSampler(hpo.SearchSpace(), seed=SEED, n_startup=2)
    loaded = hpo.warm_start_sampler(sampler, log_path)
    check(loaded == len(result.trials), f"warm start loaded {loaded}")
    space = sampler.space
    for prop in (sampler.propose() for _ in range(8)):
        check(prop["train_loss"] in space.train_losses
              and prop["num_negatives"] in {2 ** e for e in range(7)}
              and space.sigma[0] <= prop["sigma"] <= space.sigma[1]
              and space.margin[0] <= prop["margin"] <= space.margin[1]
              and (space.learning_rate[0] <= prop["learning_rate"]
                   <= space.learning_rate[1]),
              f"a warm-started proposal lies outside the space: {prop}")
    best = result.best_trial
    print(f"tuning (a): `tune` of {TUNE_CONFIGS} configs (seed {SEED}, the "
          f"default point first, reduction factor 2) through "
          f"make_trainer_evaluator(device={str(dev)!r}) on {steps_per_epoch} "
          f"steps an epoch: rungs of {resources} train steps "
          f"(limit_train_batches), {len(result.trials)} trials, "
          f"{validations} validations, kernel 1 launched "
          f"{tune_launches['packed_scan']} times; wall {tune_s:.2f} s "
          f"(host); trials "
          + ", ".join(f"#{t.trial_id}@{t.resource} {t.metric:.4f} "
                      f"({t.seconds:.2f} s)" for t in result.trials)
          + f"; winner #{best.trial_id} {metric} {best.metric:.4f} "
          f"{best.config}; the log reads back, warm start loaded {loaded} "
          f"and proposed 8 configs inside the space [{card}]")

    # (b) the executor on the card, and a probe of its worker
    rung = [t for t in result.trials if t.resource == TUNE_RUNGS[0]]
    t0 = time.perf_counter()
    with TrialExecutor(
        {"kind": "trainer", "base_data": base_data,
         "base_trainer": {**base_trainer, "log_dir": str(root / "exec_runs")}},
        workers=2, platform=dev.type,
    ) as ex:
        clamped = ex.workers
        par = hpo.tune(None, executor=ex,
                       configs=[t.config for t in rung],
                       min_resource=TUNE_RUNGS[0],
                       max_resource=TUNE_RUNGS[0], seed=SEED)
        exec_s = time.perf_counter() - t0
        # the same worker, now given the probe by the "import" spec
        ex.spec = {"kind": "import", "path": "chip_smoke:probe_trial"}
        (probe,) = ex.run([(0, {"data_dir": str(data_dir),
                                "log_dir": str(root / "exec_runs"),
                                "device": dev.type}, PROBE_STEPS)])
    n_cards = torch.cuda.device_count()
    check(clamped == min(2, n_cards), f"{clamped} workers on {n_cards} cards")
    check([(t.trial_id, t.config, t.resource) for t in par.trials]
          == [(t.trial_id, t.config, t.resource) for t in rung],
          "the executor's trials differ from the in-process rung")
    worst, worst_ratio = 0.0, 0.0
    for got, want in zip(par.trials, rung, strict=True):
        check(bool(got.metrics) and math.isfinite(got.metric),
              f"worker trial {got.trial_id} failed: {got.metrics}")
        diff, ratio = metric_gap(got.metrics, want.metrics)
        worst, worst_ratio = max(worst, diff), max(worst_ratio, ratio)
    check(worst_ratio <= 1.0, f"worker metrics part from the in-process "
          f"ones by {worst} ({worst_ratio:.3g} times the bound)")
    probe_m = probe.metrics
    check(bool(probe_m), "the probe trial failed in its worker")
    # the bound tells trainings apart: the probe is the default point
    # (trial 0's config) after PROBE_STEPS steps instead of 40
    _, apart = metric_gap({k: probe_m[k] for k in rung[0].metrics},
                          rung[0].metrics)
    check(apart > 1.0, f"the default point after {PROBE_STEPS} and after "
          f"{TUNE_RUNGS[0]} steps lies within the bound ({apart:.3g} times "
          f"it)")
    check(probe_m["pid"] == probe.worker_pid != os.getpid(),
          "the probe did not run in a worker process")
    check(probe_m["device_count"] == 1, f"the worker sees "
          f"{probe_m['device_count']:.0f} cards, not 1")
    check(probe_m["packed_scan"] > 0, "the worker's trial never launched "
          "kernel 1")
    print(f"tuning (b): TrialExecutor(platform='cuda', workers=2) on "
          f"{n_cards} card(s) clamped to {clamped} worker(s); (a)'s first "
          f"rung ({len(rung)} trials of {TUNE_RUNGS[0]} steps) in the "
          f"spawned worker in {exec_s:.2f} s wall (process start "
          f"included): trial ids, configs and resources == (a)'s, "
          f"every one of {len(rung[0].metrics)} metrics within "
          f"{worst:.3e} of (a)'s, {worst_ratio:.3g} times the bound "
          f"({TUNE_ABS_TOL} + {TUNE_REL_TOL} x |value|; the "
          f"{PROBE_STEPS}-step probe of trial 0's config lies "
          f"{apart:.3g} times it away); the probe in that worker: pid "
          f"{probe_m['pid']:.0f} "
          f"(parent {os.getpid()}), "
          f"torch.cuda.device_count() {probe_m['device_count']:.0f}, "
          f"kernel 1 launched {probe_m['packed_scan']:.0f} times by one "
          f"{PROBE_STEPS}-step trial [{card}]")

    # (c) the recommend surface on the winner's trainer
    t0 = time.perf_counter()
    winner = Trainer(
        train_mod.TrainConfig(**best.config),
        data=RecDataModule(DataConfig(**base_data)),
        trainer_config=TrainerConfig(
            **{**base_trainer, "checkpointing": True, "run_name": "winner",
               "limit_train_batches": best.resource}),
        device=dev,
    )
    winner.fit()
    winner_s = time.perf_counter() - t0
    top_k = winner.config.top_k
    rng = np.random.default_rng(SEED + 13)
    upos = rng.choice(winner.data.num_users, RECOMMEND_QUERIES,
                      replace=False)
    texts = [str(winner.data.user_texts[u]) for u in upos]
    plain = winner.recommend(texts)
    exclude = [[c["movie_id"] for c in row[:3]] for row in plain]
    t0 = time.perf_counter()
    lists = winner.recommend(texts, exclude_ids=exclude)
    rec_ms = (time.perf_counter() - t0) * 1e3
    # the dense reference's queries come from the eval path (the data
    # module's user tokens, validation's bias and CF columns), not from
    # `recommend`'s tokenization and assembly; the text tower with no CF
    # makes the two the same rows
    check(winner.config.user_tower == "text" and winner.cf is None,
          "the winner is not a text tower without a CF channel")
    check(np.array_equal(
        winner.data.tokenizer.encode_batch(texts, winner.config.max_length),
        winner.data.user_tokens[upos]),
        "the user texts tokenize apart from the data module's user tokens")
    user_queries = winner.eval_user_embeddings(upos)
    text_queries = raw_text_queries(winner, texts)
    check(torch.equal(text_queries, user_queries),
          "recommend's query rows differ from the eval path's")
    check_recommend(winner, lists, user_queries, exclude, top_k, "recommend")
    history = [winner.data.train_history_item_ids(int(u)) for u in upos]
    t0 = time.perf_counter()
    user_lists = winner.recommend_users(upos, exclude_ids=history)
    rec_users_ms = (time.perf_counter() - t0) * 1e3
    check_recommend(winner, user_lists, user_queries, history, top_k,
                    "recommend_users")
    # `cli predict --user_id` in its own process on the winner's checkpoint
    config = write_json(root / "winner.json", {
        "model": best.config, "data": base_data,
        "trainer": {**base_trainer, "run_name": "winner_cli"},
    })
    user_id = int(winner.data.user_ids[upos[0]])
    t0 = time.perf_counter()
    cli_run = subprocess.run(
        [sys.executable, "-m", "xfmr_rec_torch.training.cli", "predict",
         "--config", str(config), "--device", str(dev), "--ckpt",
         str(winner._ckpt_path("last")), "--user_id", str(user_id)],
        cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=600, check=False,
    )
    cli_s = time.perf_counter() - t0
    check(cli_run.returncode == 0, f"cli predict --user_id failed "
          f"({cli_run.returncode}):\n{cli_run.stderr[-4000:]}")
    printed = json.loads(cli_run.stdout)
    # the same one-user call (a batch's score bound, and so its keys'
    # quantum, depends on the queries in it)
    want = winner.recommend_users(upos[:1], exclude_ids=history[:1])[0]
    check([c["movie_id"] for c in printed] == [c["movie_id"] for c in want],
          "cli predict --user_id differs from recommend_users")
    score_diff = max(abs(a["score"] - b["score"])
                     for a, b in zip(printed, want, strict=True))
    check(score_diff <= 1e-6, f"cli predict --user_id scores part by "
          f"{score_diff}")
    # a raw text on the item-channel trainer (bias + CF columns)
    raw = ["a quiet drama about family", "action thriller in space"]
    wide_lists = wide.recommend(raw)
    check_recommend(wide, wide_lists, raw_text_queries(wide, raw),
                    [[] for _ in raw], wide.config.top_k, "wide recommend")
    launches = kernels.launch_counts()
    print(f"tuning (c): the winner retrained to {best.resource} steps in "
          f"{winner_s:.2f} s; recommend for {RECOMMEND_QUERIES} user texts "
          f"(the first 3 ids of each excluded) in {rec_ms:.1f} ms and "
          f"recommend_users for {RECOMMEND_QUERIES} users (train histories "
          f"excluded) in {rec_users_ms:.1f} ms (host wall), every list == "
          f"dense top-{top_k} on the card within one key quantum, no "
          f"excluded id; `cli predict --user_id {user_id}` in a subprocess "
          f"in {cli_s:.2f} s printed recommend_users' list (scores within "
          f"{score_diff:.1e}); recommend with a raw text on the "
          f"{wide.index.dim}-column item-channel index gave "
          f"{len(wide_lists[0])} rows == dense top-k; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s [{card}]")
    launches = {name: tune_launches[name] + launches[name]
                for name in kernels.LAUNCHES}
    print(f"tuning kernel launches in this process (the worker's not "
          f"counted): {launches}")
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib_path = kernels.build(verbose=True)
    build_s = time.perf_counter() - t0
    spills = 0
    for line in kernels.last_build_log.splitlines():
        if "registers" in line or "spill" in line or "==" in line:
            print(f"ptxas: {line.strip()}")
        if "spill stores" in line and "0 bytes spill stores" not in line:
            spills += 1
    check(spills == 0, f"ptxas reports register spills in {spills} kernels")
    kernels.load()
    t0 = time.perf_counter()
    # the host libraries: a failed g++ build fails here, where the library
    # calls' default (native=None) would fall back to the Python path
    tokenizer_native.load()
    bm25_native.load()
    native_s = time.perf_counter() - t0
    print(f"native: the tokenizer and BM25 libraries built with g++ and "
          f"loaded in {native_s:.2f} s")
    print(f"build: {build_s:.2f} s -> {lib_path.relative_to(pathlib.Path.cwd()) if lib_path.is_relative_to(pathlib.Path.cwd()) else lib_path}")

    scan = phase_scan(dev)
    select = phase_select(scan)
    lane = phase_lane_scan(dev, scan["queries"], scan["corpus"])
    count = phase_count(dev, scan["queries"], scan["corpus"], lane)
    fused = phase_fused_select(dev, scan["queries"], scan["corpus"])
    del lane["vals"], scan["keys"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as serve_tmp, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        serve_root = pathlib.Path(serve_tmp)
        serving = phase_serving(dev, card, serve_root)
        guaranteed = phase_guaranteed(dev, card)
        certified = phase_certified(dev, card, guaranteed)
        timings = phase_timings(guaranteed, select, certified, card)
        phase_profile(guaranteed, card, "fused")
        phase_profile(guaranteed, card, "f32")
        phase_ivf_clustered(dev, card)
        training = phase_training(dev, card, pathlib.Path(tmp))
        history = phase_history(dev, card, pathlib.Path(tmp))
        mesh = phase_mesh(dev, card, guaranteed, serve_root,
                          serving["texts"], pathlib.Path(tmp))
        multiprocess = phase_multiprocess(dev, card, guaranteed, mesh,
                                          serve_root, pathlib.Path(tmp),
                                          lib_path)
        tuning = phase_tuning(dev, card, pathlib.Path(tmp), history.pop("wide"))

    # launches on the main paths only: each path ran with the counts set
    # to 0 just before it and read just after
    launches = {
        name: sum(phase["launches"][name]
                  for phase in (serving, guaranteed, certified, training,
                                history, mesh, multiprocess, tuning))
        for name in kernels.LAUNCHES
    }
    for name, count_ in launches.items():
        check(count_ > 0, f"no main path launched {name}")
    # name -> (line of the TPU kernel, error against the plain version,
    # library yardstick where the timings hold none)
    ported = {
        "packed_scan": (658, scan["max_abs_err"], guaranteed["library_ms"]),
        "threshold_select": (1365, select["max_abs_err"], None),
        "lane_max_scan": (127, lane["max_abs_err"], guaranteed["library_ms"]),
        "count_at_least": (456, count["max_abs_err"], None),
        "packed_scan_select": (938, fused["max_abs_err"],
                               guaranteed["library_ms"]),
    }
    entries = [
        {
            "name": name,
            "route": "cuda",
            "source": f"xfmr_rec_torch/csrc/{name}.cu",
            "replaces": f"xfmr_rec_tpu/ops/topk_pallas.py:{line}",
            "launches": launches[name],
            "max_abs_err": err,
            "library_ms": library_ms,
            **timings[name],
        }
        for name, (line, err, library_ms) in ported.items()
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries = [{key: entry[key] for key in keys} for entry in entries]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker_main(sys.argv[2:]))
    sys.exit(main())
