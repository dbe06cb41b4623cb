#!/usr/bin/env python3
"""Drive the PyTorch port's serving, certified-search and training paths
on one CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA card (H100, sm_90a) and nvcc; builds the kernels from
`xfmr_rec_torch/csrc/` into `build/kernels/` first. Exits non-zero,
printing no result, when there is no card or any phase fails. Phases:

1. build the kernels;
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
   search over HTTP against its `native=False` oracle; 1,024 items added
   over HTTP under traffic (no request may fail; the grown index held
   against dense exact top-k); 1,024 items removed from a copy of the
   grown index, then `search_certified("fused")` on it held against
   dense exact top-k, the surviving rows' packed keys unmoved;
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
   batch 32 and 4096 with its device-idle share; (b) a 2^17-item catalog whose eval search
   runs the scan index (kernel 1), its answers held against dense
   scores; (c) the artifact of (a) served by `RecommenderEngine`, its
   answers equal to the trainer's own search;
10. the history tower: (a) the repo's flagship (history user tower, 16
   rated slots, InfoNCE) at full width on phase 9's corpus, 300 steps
   through `cli fit` with two validations, 3 card steps against the CPU
   at bf16 and f32, the step's time at batch 32 and 1024, and the saved
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
then the card, one JSON line for the kernels, and the result line.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import json
import math
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

from xfmr_rec_torch.data.module import RecDataModule
from xfmr_rec_torch.data.prepare import load_table, prepare_movielens
from xfmr_rec_torch.data.synthetic import generate_movielens
from xfmr_rec_torch.index.mips import BM25Index, RetrievalIndex
from xfmr_rec_torch.models.convert import torch_name
from xfmr_rec_torch.models.encoder import ModelConfig, TextEncoder, init_encoder
from xfmr_rec_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from xfmr_rec_torch.ops import kernels, topk, topk_f32
from xfmr_rec_torch.serving.engine import RecommenderEngine
from xfmr_rec_torch.serving.schemas import Query
from xfmr_rec_torch.serving.service import RecService, make_server
from xfmr_rec_torch.training import cli
from xfmr_rec_torch.training import module as train_mod

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
    tokens = tok.encode_batch(texts[:ENCODED_ITEMS])
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


def check_exclusion_search(dense, ct, exclude, got_pos, k, tol, what):
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
    """
    batch, n = dense.shape
    half = ct // 2
    # a partial last tile: its padded lanes hold no item (the scan masks
    # them), so they score -inf and survive nothing
    dense = torch.nn.functional.pad(dense, (0, -n % ct), value=-math.inf)
    per_pair = dense.view(batch, -1, 2, half).permute(0, 3, 1, 2)
    top3 = torch.topk(per_pair.reshape(batch, half, -1), 3, dim=-1).values
    pair_of = torch.arange(dense.shape[1], device=dense.device) % half
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


def phase_serving(dev, card: str) -> dict:
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    root = pathlib.Path(tmp.name)
    texts, _ = synthesize_artifact(root, dev, card)
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
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
        tmp.cleanup()
    print(f"serving path kernel launches: {launches}")
    check(launches["packed_scan"] > 0, "serving path never launched packed_scan")
    return {"launches": launches}


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
    dev = index.device
    corpus_f = index.corpus.float()
    qnorm = float(np.linalg.norm(queries, axis=-1).max())
    bound = np.float32(max(index._corpus_maxnorm * qnorm * 1.05, 1e-6))
    q_bf = torch.from_numpy(queries).to(dev, torch.bfloat16)
    scale = 0.25 / torch.tensor(bound, device=dev)
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
                    "run_name": "ml1m", "seed": SEED},
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
    timing = {
        32: train_step_ms(config, batches[0], dev, steps=50),
        4096: train_step_ms(config, next(big.train_batches(0)), dev,
                            steps=10),
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
    timing = {
        32: train_step_ms(config, batches[0], dev, steps=50),
        1024: train_step_ms(config, next(big.train_batches(0)), dev,
                            steps=10),
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
    print(f"build: {build_s:.2f} s -> {lib_path.relative_to(pathlib.Path.cwd()) if lib_path.is_relative_to(pathlib.Path.cwd()) else lib_path}")

    scan = phase_scan(dev)
    select = phase_select(scan)
    lane = phase_lane_scan(dev, scan["queries"], scan["corpus"])
    count = phase_count(dev, scan["queries"], scan["corpus"], lane)
    fused = phase_fused_select(dev, scan["queries"], scan["corpus"])
    del lane["vals"], scan["keys"]
    serving = phase_serving(dev, card)
    guaranteed = phase_guaranteed(dev, card)
    certified = phase_certified(dev, card, guaranteed)
    timings = phase_timings(guaranteed, select, certified, card)
    phase_profile(guaranteed, card, "fused")
    phase_profile(guaranteed, card, "f32")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        training = phase_training(dev, card, pathlib.Path(tmp))
        history = phase_history(dev, card, pathlib.Path(tmp))

    # launches on the main paths only: each path ran with the counts set
    # to 0 just before it and read just after
    launches = {
        name: sum(phase["launches"][name]
                  for phase in (serving, guaranteed, certified, training,
                                history))
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
    sys.exit(main())
