#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card (H100, sm_90a) and nvcc; builds the kernels from
`xfmr_rec_torch/csrc/` into `build/kernels/` first. Exits non-zero,
printing no result, when there is no card or any phase fails. Phases:

1. build the kernels;
2. the packed scan kernel against its plain PyTorch version: bit for bit
   on inputs whose dot products are exact in f32, and within one key
   quantum on random unit vectors at the retrieval geometry;
3. the threshold-select kernel against its plain version on real pools;
4. the serving path: a synthesized artifact (text tower at the trained
   widths, 2^20 items), `RecService` over HTTP on localhost, every answer
   held against dense exact top-k on the card;
5. guaranteed-exact search (`search_certified(method="fused")`) at
   2^20 x 64 bf16, B=4096, k=100, against dense exact top-k, with its
   throughput, each kernel's time, its plain version's and a library
   yardstick, and a profile of one batch (device time by kernel and the
   device's idle share);
then the card, one JSON line for the kernels, and the result line.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from xfmr_rec_torch.index.mips import RetrievalIndex
from xfmr_rec_torch.models.convert import torch_name
from xfmr_rec_torch.models.encoder import ModelConfig, TextEncoder
from xfmr_rec_torch.models.tokenizer import HashingTokenizer, TokenizerConfig
from xfmr_rec_torch.ops import kernels, topk
from xfmr_rec_torch.serving.engine import RecommenderEngine
from xfmr_rec_torch.serving.service import RecService, make_server

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
ENCODED_ITEMS = 16384
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
    ]
    for name, opts in cases:
        opts = dict(opts)
        int8 = opts.pop("int8", False)
        f32 = opts.pop("f32", False)
        q, c, scales, bound = exact_inputs(gen, 500, 1 << 16, 64, int8=int8)
        if opts.get("bias_in_dot"):
            c = torch.cat([c, torch.full((len(c), 1), 1.5)], dim=1)
        qdt = torch.float32 if f32 else torch.bfloat16
        cdt = torch.int8 if int8 else qdt
        qd, cd = q.to(dev, qdt), c.to(dev, cdt)
        sd = None if scales is None else scales.to(dev)
        q_s, s_s, geom = topk.prepare_packed_scan(
            qd, cd, score_bound=bound, batch_tile=500, corpus_tile=2048,
            scales=sd, **opts,
        )
        got = kernels.packed_scan(q_s, cd, s_s, **geom)
        want = topk.packed_lane_scan_plain(q_s, cd, s_s, **geom)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"scan keys differ ({name})")
        if geom["track_discards"]:
            check(torch.equal(got[1], want[1]), f"scan dmax differs ({name})")
        else:
            check(got[1] is None, f"dmax returned untracked ({name})")
        print(f"scan exact case {name}: keys and dmax bit-identical "
              f"(B=500, N=65536, D={c.shape[1]})")

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
    return {"max_abs_err": max(err, err_dmax), "keys": got_keys,
            "idx_bits": geom["idx_bits"]}


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
    worst = 0
    for width, (pool, qbits) in pools.items():
        pool = pool.contiguous()
        opts = dict(capacity=128, quantum_bits=qbits, shared_exponent=True)
        got = kernels.threshold_select(pool, BENCH_K, **opts)
        want = topk.select_topk_keys_plain(pool, BENCH_K, **opts)
        torch.cuda.synchronize()
        got_sorted = torch.sort(got[0], dim=1).values
        want_sorted = torch.sort(want[0], dim=1).values
        check(torch.equal(got_sorted, want_sorted),
              f"select keys differ as multisets (W={width})")
        # lanes must agree wherever the key is unique at the quantum
        quanta = got[0] >> qbits
        dup = (quanta[:, :, None] == quanta[:, None, :]).sum(-1) > 1
        lanes_ok = (got[1] == want[1]) | dup | (got[0] == 0)
        check(bool(lanes_ok.all()), f"select lanes differ (W={width})")
        raw_same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        worst = max(worst, int((got_sorted - want_sorted).abs().max()))
        print(f"select W={width} B={pool.shape[0]} k={BENCH_K} cap=128: "
              f"key multisets equal, lanes equal where unique; raw outputs "
              f"identical: {raw_same}")
    return {"max_abs_err": float(worst), "pool": pools[3072][0].contiguous(),
            "qbits": pools[3072][1]}


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------
def item_text(rng, i: int) -> str:
    words = rng.choice(WORDS, size=rng.integers(3, 9))
    return f"{' '.join(words)} ({1950 + i % 70})"


def synthesize_artifact(root: pathlib.Path, dev) -> tuple[list[str], float]:
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
    # encode the first ENCODED_ITEMS texts through the port's encoder;
    # the pure-Python tokenizer cannot do 2^20 texts inside the time
    # limit, so the rest are seeded unit vectors
    from xfmr_rec_torch.models.convert import build_encoder, load_portable

    _, _, state = load_portable(root)
    encoder = build_encoder(config, state, dev)
    tok = HashingTokenizer(TokenizerConfig(vocab_size=30522,
                                           max_length=ENCODER["max_length"]))
    t0 = time.perf_counter()
    encoded = []
    for start in range(0, ENCODED_ITEMS, 2048):
        chunk = texts[start:min(start + 2048, ENCODED_ITEMS)]
        ids = torch.from_numpy(tok.encode_batch(chunk))
        encoded.append(encoder(ids.to(dev)))
    encoded = torch.cat(encoded)
    encode_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rest = torch.nn.functional.normalize(
        torch.randn(SERVE_ITEMS - ENCODED_ITEMS, ENCODER["hidden_size"],
                    device=dev, generator=g), dim=1,
    )
    corpus = torch.cat([encoded, rest])
    ids = np.arange(1, SERVE_ITEMS + 1)
    metadata = [{"movie_text": t, "movie_rn": int(i)}
                for t, i in zip(texts, ids, strict=True)]
    index = RetrievalIndex(corpus, ids, metadata, id_col="movie_id",
                           method="auto", device=dev)
    check(index.method == "scan", "method='auto' did not pick the scan")
    index.save(root / "index")
    print(f"artifact: {ENCODED_ITEMS} item texts encoded on the card in "
          f"{encode_s:.2f} s; {SERVE_ITEMS - ENCODED_ITEMS} further items "
          "are seeded unit vectors (the pure-Python tokenizer cannot "
          "tokenize 2^20 texts inside the time limit); index method "
          f"'auto' -> {index.method!r}")
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
    per_pair = dense.view(batch, n // ct, 2, half).permute(0, 3, 1, 2)
    top3 = torch.topk(per_pair.reshape(batch, half, -1), 3, dim=-1).values
    pair_of = torch.arange(n, device=dense.device) % half
    maybe = dense >= top3[:, pair_of, 1] - tol
    sure = dense > top3[:, pair_of, 2] + tol
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


def phase_serving(dev, card: str) -> dict:
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    root = pathlib.Path(tmp.name)
    texts, _ = synthesize_artifact(root, dev)
    t0 = time.perf_counter()
    engine = RecommenderEngine(root, device=dev, warmup=True)
    print(f"engine load + warmup {time.perf_counter() - t0:.2f} s")
    service = RecService(engine, micro_batch=64, micro_batch_wait_ms=20)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    base = f"http://127.0.0.1:{server.server_address[1]}"

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
        queries = [" ".join(rng.choice(WORDS, size=4)) for _ in range(8)]
        excl = [[int(x) for x in rng.integers(1, SERVE_ITEMS, size=5)]
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
        check_exclusion_search(dense, ct, excl_pos, got_pos, BENCH_K, tight,
                               "direct search")
        exact_top = 0
        for row in range(len(queries)):
            pos = got_pos[row]
            masked = dense[row].clone()
            masked[torch.tensor([i - 1 for i in excl[row]], device=dev)] = (
                -math.inf
            )
            true_top = set(torch.topk(masked, BENCH_K).indices.tolist())
            exact_top += len(true_top & set(pos.tolist()))
            check(not set(excl[row]) & set(got_ids[row].tolist()),
                  "an excluded id came back")
        recall = exact_top / (BENCH_K * len(queries))
        print(f"serving direct: 8 queries x top-{BENCH_K} with exclusions == "
              "dense top-k of the lane-pair survivors up to one key quantum "
              f"({tight:.2e} scaled); recall@{BENCH_K} vs unrestricted dense "
              f"{recall:.4f}; {direct_ms:.2f} ms host wall [{card}]")

        # (b) HTTP requests through RecService
        answers = []
        for text in queries[:3]:
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
        launches = kernels.launch_counts()
        print(f"serving http: {len(answers)} answers (3 recommend_with_query, "
              "3 recommend_with_item_id with exclusions, 3 item_id lookups, "
              f"a 64-request burst in {burst_s:.2f} s host wall served in "
              f"{batcher.batches_dispatched} micro-batches) all == dense "
              f"top-k of the lane-pair survivors within {loose} [{card}]")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
        tmp.cleanup()
    print(f"serving path kernel launches: {launches}")
    check(launches["packed_scan"] > 0, "serving path never launched packed_scan")
    return {"launches": launches}


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
    index.search_certified(batches[0], top_k=BENCH_K)  # warm-up, unchecked
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times, pipeline_bad, results = [], 0, []
    for queries in batches[1:]:
        t0 = time.perf_counter()
        scores, ids = index.search_certified(queries, top_k=BENCH_K)
        times.append(time.perf_counter() - t0)
        pipeline_bad += index.last_certified_stats["pipeline_bad"]
        results.append((queries, scores, ids))
    launches = kernels.launch_counts()
    ms = 1e3 * sum(times) / len(times)
    qps = BENCH_BATCH / (ms / 1e3)
    certified_frac = 1 - pipeline_bad / (BENCH_BATCH * len(times))

    # dense exact check at the packed order's resolution
    tight = quantum_scaled(index_quantum_bits(index)) + 1e-6
    corpus_f = corpus_bf.float()
    fallback_rows = 0
    for queries, scores, ids in results:
        check(bool(np.isfinite(scores).all()), "non-finite scores")
        check(bool((np.diff(scores, axis=1) <= 1e-6).all()),
              "scores not descending")
        qnorm = float(np.linalg.norm(queries, axis=-1).max())
        bound = np.float32(max(index._corpus_maxnorm * qnorm * 1.05, 1e-6))
        q_bf = torch.from_numpy(queries).to(dev, torch.bfloat16)
        scale = 0.25 / torch.tensor(bound, device=dev)
        q_s = (q_bf.float() * scale).bfloat16().float()
        pos_all = torch.from_numpy(ids.astype(np.int64)).to(dev)
        for start in range(0, BENCH_BATCH, 512):
            rows = slice(start, start + 512)
            dense = q_s[rows] @ corpus_f.T
            kth = torch.topk(dense, BENCH_K, dim=1).values[:, -1:]
            got = torch.gather(dense, 1, pos_all[rows])
            ok = (got >= kth - tight).all(1) & (
                (got > kth + tight).sum(1) == (dense > kth + tight).sum(1)
            )
            if not bool(ok.all()):
                # rows the dense fallback answered: exact in the unscaled
                # bf16 order instead
                plain = q_bf[rows].float() @ corpus_f.T
                kth_p = torch.topk(plain, BENCH_K, dim=1).values[:, -1:]
                got_p = torch.gather(plain, 1, pos_all[rows])
                ok_p = (got_p >= kth_p - 1e-6).all(1)
                check(bool((ok | ok_p).all()), "guaranteed search not exact")
                fallback_rows += int((~ok).sum())
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

    def library():
        return torch.topk(torch.matmul(qf, corpus_f.T), BENCH_K, dim=1)

    library_ms = cuda_ms(library, iters=3)
    print(f"library yardstick torch.matmul + torch.topk over ({BENCH_BATCH}, "
          f"{BENCH_ITEMS}) f32 scores: {library_ms:.3f} ms [{card}]")
    return {"launches": launches, "ms": ms, "qps": qps,
            "certified_frac": certified_frac, "pipeline_bad": pipeline_bad,
            "library_ms": library_ms, "corpus": corpus_bf, "index": index,
            "batch": batches[1],
            "queries": torch.from_numpy(batches[1]).to(dev, torch.bfloat16)}


def phase_profile(guaranteed: dict, card: str) -> None:
    """Device time by kernel for one guaranteed-exact batch and the
    device's idle share of that batch's wall time (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        guaranteed["index"].search_certified(guaranteed["batch"], top_k=BENCH_K)
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
    print(f"profile of one guaranteed batch (profiler on): wall {wall_ms:.3f} "
          f"ms, device busy {busy_ms:.3f} ms, device idle share "
          f"{1 - busy_ms / wall_ms:.4f} [{card}]")
    for dev_ms, count, name in rows[:8]:
        print(f"  {dev_ms:9.3f} ms  x{count:<4d} {name[:100]}")


# ---------------------------------------------------------------------------
# kernel timings and bounds at the main path's shapes
# ---------------------------------------------------------------------------
def phase_timings(guaranteed: dict, select: dict, card: str) -> dict:
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
    # the guaranteed path's retry sweeps run at 256 and 64 rows
    retry = {}
    for rows in (256, 64):
        q_rows = q_s[:rows].contiguous()
        retry[rows] = cuda_ms(
            lambda q_rows=q_rows: kernels.packed_scan(q_rows, corpus, None, **geom)
        )
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"packed_scan at the retry widths: B=256 {retry[256]:.3f} ms, B=64 "
          f"{retry[64]:.3f} ms ({sms} SMs) [{card}]")

    pool = select["pool"]
    opts = dict(capacity=128, quantum_bits=select["qbits"],
                shared_exponent=True)
    sel_ms = cuda_ms(lambda: kernels.threshold_select(pool, BENCH_K, **opts))
    sel_plain_ms = cuda_ms(
        lambda: topk.select_topk_keys_plain(pool, BENCH_K, **opts), iters=3
    )
    sel_lib_ms = cuda_ms(lambda: torch.topk(pool, BENCH_K, dim=1))
    pb, w = pool.shape
    sel_bytes = pb * w * 4 + 2 * pb * 128 * 4
    sel_bytes_ms = sel_bytes / HBM_BYTES_PER_S * 1e3
    bits = 22 - select["qbits"] + 1
    sel_ops_ms = (bits + 3) * pb * w / INT32_OPS * 1e3
    sel_bound = max(sel_bytes_ms, sel_ops_ms)
    print(f"threshold_select at B={pb} W={w} k={BENCH_K} cap=128: kernel "
          f"{sel_ms:.3f} ms, plain {sel_plain_ms:.3f} ms, torch.topk "
          f"{sel_lib_ms:.3f} ms; bound {sel_bound:.4f} ms (bytes "
          f"{sel_bytes_ms:.4f}, int32 compares {sel_ops_ms:.4f}) [{card}]")
    return {
        "packed_scan": dict(ms=scan_ms, plain_ms=scan_plain_ms,
                            bound_ms=scan_bound,
                            bound_by="bytes" if bytes_ms >= max(dot_ms, int_ms)
                            else "operations"),
        "threshold_select": dict(ms=sel_ms, plain_ms=sel_plain_ms,
                                 bound_ms=sel_bound,
                                 bound_by="bytes" if sel_bytes_ms >= sel_ops_ms
                                 else "operations",
                                 library_ms=sel_lib_ms),
    }


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
    for line in kernels.last_build_log.splitlines():
        if "registers" in line or "spill" in line or "==" in line:
            print(f"ptxas: {line.strip()}")
    kernels.load()
    print(f"build: {build_s:.2f} s -> {lib_path.relative_to(pathlib.Path.cwd()) if lib_path.is_relative_to(pathlib.Path.cwd()) else lib_path}")

    scan = phase_scan(dev)
    select = phase_select(scan)
    serving = phase_serving(dev, card)
    guaranteed = phase_guaranteed(dev, card)
    timings = phase_timings(guaranteed, select, card)
    phase_profile(guaranteed, card)

    launches = {
        name: serving["launches"][name] + guaranteed["launches"][name]
        for name in kernels.LAUNCHES
    }
    entries = [
        {
            "name": "packed_scan",
            "route": "cuda",
            "source": "xfmr_rec_torch/csrc/packed_scan.cu",
            "replaces": "xfmr_rec_tpu/ops/topk_pallas.py:658",
            "launches": launches["packed_scan"],
            "max_abs_err": scan["max_abs_err"],
            "library_ms": guaranteed["library_ms"],
            **timings["packed_scan"],
        },
        {
            "name": "threshold_select",
            "route": "cuda",
            "source": "xfmr_rec_torch/csrc/threshold_select.cu",
            "replaces": "xfmr_rec_tpu/ops/topk_pallas.py:1365",
            "launches": launches["threshold_select"],
            "max_abs_err": select["max_abs_err"],
            **timings["threshold_select"],
        },
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
