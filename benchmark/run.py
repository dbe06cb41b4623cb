"""Run one cell of the benchmark of the PyTorch + CUDA port once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device` and, traced,
`breakdown`; `checks` comes last, each number compared beside its limit.
Everything else goes to standard error, whose last lines are those checks
again. It exits non-zero with no result when the cards are missing, when a
module of JAX or of the JAX package is loaded, or when the port is absent.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import traceback

from benchmark import harness

PROCESS_START = harness.process_start_epoch()


def parse(argv: list[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def _json_number(value: float) -> float:
    """JSON has no infinity: a non-finite number prints as the largest
    float, which exceeds every limit."""
    return value if math.isfinite(value) else sys.float_info.max


def emit(result: dict) -> None:
    for name, check in result["checks"].items():
        check["value"] = _json_number(check["value"])
    for name, check in result["checks"].items():
        harness.log(f"check {name}: {check['value']!r} (limit "
                    f"{check['limit']!r})")
    print(json.dumps(result), flush=True)


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    harness.set_cache_dirs()
    bad = harness.reference_imports()
    if bad:
        harness.log(f"the reference imports what it may not: {bad}")
        return 3
    loaded = harness.forbidden_loaded()
    if loaded:
        harness.log(f"loaded before the run: {loaded}")
        return 3
    cell = harness.cell_entry(harness.load_spec(), args.workload)
    harness.limit_host_threads(harness.traffic_of(cell))
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        harness.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            torch.device("cuda", 0), PROCESS_START)
    except Exception:  # noqa: BLE001 - a run that fails prints no result
        traceback.print_exc()
        return 1
    harness.log(f"card after the run (name, power limit, SM clock, power, "
                f"temperature): {harness.card_line()}")
    loaded = harness.forbidden_loaded()
    if loaded:
        harness.log(f"loaded by the run: {loaded}")
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
