"""Batch exact retrieval: back-to-back guaranteed-exact top-k batches.

Set-up draws the corpus (`items` seeded unit vectors at the
configuration's `hidden_size`, stored in `index_dtype`) and every query
batch of the window on the card, builds the port's `RetrievalIndex` with
the packed scan, and runs `warmup_batches` batches. The window calls
`RetrievalIndex.search_certified(queries, top_k=k, method=...)` back to
back, each batch new, each answer copied to the host, until `--seconds`
have passed. `retrieval_qps` is the rows answered over the window's wall
time.

The check: a sample of the window's batches, drawn from the seed, is
answered again by exact float32 scoring of the same bf16 queries and
corpus (`reference/search.py`); the number compared is the widest gap by
which a returned item's exact score lies below the row's exact k-th best.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark.harness import Outcome, Run, checks_from, log
from benchmark.reference.precision import set_exact_float32
from benchmark.reference.search import answer_gap


def unit_rows(gen: torch.Generator, shape: tuple, device, dtype):
    rows = torch.randn(shape, generator=gen, device=device)
    return torch.nn.functional.normalize(rows, dim=-1).to(dtype)


def make_inputs(run: Run) -> tuple[torch.Tensor, torch.Tensor]:
    """(corpus (N, D), queries (M, B, D)) in the index dtype, on the card."""
    p, dim = run.traffic, run.config["hidden_size"]
    dtype = getattr(torch, run.config["index_dtype"])
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    corpus = unit_rows(gen, (p["items"], dim), run.device, dtype)
    queries = unit_rows(gen, (p["max_batches"], p["batch"], dim), run.device,
                        dtype)
    return corpus, queries


def sample_batches(seed: int, expected: int, count: int) -> set[int]:
    """Batches the check answers again, drawn from the seed among the
    first `expected` of the window; the window's last batch joins them."""
    return set(random.Random(seed).sample(range(expected),
                                          min(count - 1, expected)))


def run(run: Run) -> Outcome:
    from xfmr_rec_torch.index.mips import RetrievalIndex

    p = run.traffic
    batch, top_k, method = p["batch"], p["top_k"], p["method"]
    run.mark("imports done")
    corpus, queries = make_inputs(run)
    run.mark("corpus and queries drawn")
    index = RetrievalIndex(
        corpus, np.arange(1, p["items"] + 1, dtype=np.int64),
        id_col="movie_id", dtype=run.config["index_dtype"], method="scan",
        device=run.device,
    )
    for i in range(p["warmup_batches"]):
        begin = time.perf_counter()
        index.search_certified(queries[i % p["max_batches"]], top_k=top_k,
                               method=method)
        per_batch = time.perf_counter() - begin
    run.mark("index built and warmed up")
    expected = max(1, int(0.8 * run.seconds / per_batch))
    picks = sample_batches(run.seed, expected, p["check_batches"])
    run.tracer.wrap(index, "search_certified", "bench.search",
                    lambda q, **kw: {"batch": int(q.shape[0]),
                                     "items": p["items"],
                                     "dim": int(q.shape[1]),
                                     "top_k": kw["top_k"]})
    counters = {"rows": 0, "dense_rows": 0, "batches": 0}

    def search(i: int):
        ids = index.search_certified(queries[i % p["max_batches"]],
                                     top_k=top_k, method=method)[1]
        stats = index.last_certified_stats
        counters["rows"] += stats["batch"]
        counters["dense_rows"] += stats["pipeline_bad"]
        counters["batches"] += 1
        return ids

    kept: dict[int, np.ndarray] = {}
    done = 0
    run.window_starts()
    start = time.perf_counter()
    ends = []
    while True:
        ids = search(done)
        if done in picks:
            kept[done] = ids
        done += 1
        ends.append(time.perf_counter())
        elapsed = ends[-1] - start
        run.tracer.tick(elapsed, run.seconds, lambda: dict(counters))
        if elapsed >= run.seconds:
            break
    window_s = ends[-1] - start
    run.tracer.finish(lambda: dict(counters))
    kept[done - 1] = ids
    if done > p["max_batches"]:
        log(f"the window ran {done} batches, more than the "
            f"{p['max_batches']} drawn: queries repeat")
    run.read_memory_peak()
    qps = done * batch / window_s
    each = np.diff([start, *ends]) * 1e3
    log(f"retrieve: {done} batches of {batch} in {window_s:.3f} s, "
        f"{1e3 * window_s / done:.3f} ms a batch (p10 / p50 / p90 "
        f"{np.percentile(each, 10):.3f} / {np.percentile(each, 50):.3f} / "
        f"{np.percentile(each, 90):.3f}), {counters['dense_rows']} "
        f"rows answered by the dense path, peak device memory "
        f"{run.memory_peak_bytes} bytes")
    log("retrieve: ms a batch by fifth of the window: " + " ".join(
        f"{np.mean(part):.3f}" for part in np.array_split(each, 5)))
    del index
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    gap = check_answers(run, corpus, queries, kept, top_k)
    return Outcome(
        metrics={"retrieval_qps": qps},
        attempted=done * batch,
        failed=0,
        checks=checks_from({"retrieve_gap": gap}, p["limits"]),
    )


def check_answers(run: Run, corpus, queries, kept, top_k) -> float:
    set_exact_float32()
    worst = 0.0
    for i in sorted(kept):
        answers = torch.from_numpy(kept[i] - 1).to(run.device)
        worst = max(worst, answer_gap(
            queries[i % run.traffic["max_batches"]], corpus, answers, top_k))
    log(f"retrieve check: batches {sorted(kept)} answered again by exact float32 "
        f"scoring; widest gap below the k-th best {worst!r}")
    return worst
