"""Readings that set a cell's limits: its control and its faults.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--seconds S]

On the cell's own sizes, for each seed, the number each check compares is
read for the control: the plain reference put in the port's place and
computed one precision below the configuration's (bf16 compute and a bf16
index become per-tensor scaled float8 e4m3). A training cell also reads
the fault of half of each batch left out (the mean taken over the rest is
the loss over the other half). A state left unchanged reads 1 on the
change gap by its definition and needs no run. The benchmark's own runs
never run this; `PERF.md` gives the readings and the limits set from them.
Each reading is also judged as a run judges it (`harness.checks_from`
against the mix's limits) and the verdict logged beside it: the control's
and each fault's have to come out as not correct, the port's as correct.
The last line of standard output is a JSON object of every reading and
verdict.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import numpy as np
import torch

from benchmark import harness
from benchmark.reference.precision import rounder, set_exact_float32
from benchmark.reference.search import answer_gap, exact_topk
from benchmark.reference.train import run_steps

LOWER = "float8_e4m3fn"


def retrieve_readings(run: harness.Run) -> dict:
    """The port's answers to the cell's first batches and the control's."""
    from xfmr_rec_torch.index.mips import RetrievalIndex

    from benchmark.drivers import retrieve

    p = run.traffic
    corpus, queries = retrieve.make_inputs(run)
    index = RetrievalIndex(
        corpus, np.arange(1, p["items"] + 1, dtype=np.int64),
        id_col="movie_id", dtype=run.config["index_dtype"], method="scan",
        device=run.device)
    low = rounder(LOWER)
    corpus_low = low(corpus.float())
    program = control = 0.0
    for i in range(p["check_batches"]):
        q = queries[i]
        ids = index.search_certified(q, top_k=p["top_k"], method=p["method"])[1]
        got = torch.from_numpy(ids - 1).to(run.device)
        program = max(program, answer_gap(q, corpus, got, p["top_k"]))
        _, got = exact_topk(low(q.float()), corpus_low, p["top_k"])
        control = max(control, answer_gap(q, corpus, got, p["top_k"]))
    return {"program": {"retrieve_gap": program},
            "control": {"retrieve_gap": control}}


def train_readings(run: harness.Run) -> dict:
    """The port's first steps, the control's and half of each batch's."""
    from benchmark.drivers import train

    first = train.first_steps(run)
    first.trainer = first.feed = None
    program, ref = train.check_steps(run, first)
    tensors, weights0 = ref["tensors"], first.weights0
    seed = run.seed + 1
    half = [{k: (v[: len(v) // 2] if k != "item_idx" else torch.cat([
        v[: len(v) // 4], v[len(v) // 2 : 3 * len(v) // 4]]))
        for k, v in b.items()} for b in tensors]
    readings = {"program": program}
    for what, outcome in (
        ("control", run_steps(weights0, tensors, run.config,
                              dropout_seed=seed, precision=LOWER)),
        ("half_batch", run_steps(weights0, half, run.config,
                                 dropout_seed=seed)),
    ):
        readings[what], _ = train.step_readings(
            train.reference_side(outcome, weights0),
            train.reference_side(ref, weights0))
    return readings


READINGS = {"retrieve": retrieve_readings, "train": train_readings}


def verdict(readings: dict, limits: dict) -> bool:
    """Whether a run reading these numbers comes out as correct: the
    run's own checks, on the numbers the mix gives a limit."""
    held = {name: limit for name, limit in limits.items() if name in readings}
    return all(c.ok for c in harness.checks_from(readings, held))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=None)
    args = parser.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.cell_entry(spec, args.workload)
    config = harness.config_of(spec, cell)
    traffic = harness.traffic_of(cell)
    seconds = args.seconds or spec["run_seconds"]
    device = torch.device("cuda")
    set_exact_float32()
    out = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        with tempfile.TemporaryDirectory(prefix="control-") as tmp:
            run = harness.Run(cell=cell, config=config, traffic=traffic,
                              seed=seed, seconds=seconds, trace=False,
                              device=device, run_dir=pathlib.Path(tmp),
                              process_start=0.0)
            readings = READINGS[traffic["driver"]](run)
        out[seed] = {what: {"readings": values,
                            "correct": verdict(values, traffic["limits"])}
                     for what, values in readings.items()}
        harness.log(f"{args.workload} seed {seed}: {json.dumps(out[seed])}")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
