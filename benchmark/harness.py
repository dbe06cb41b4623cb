"""The harness that runs one cell of the benchmark once.

A cell is an entry of `workloads` in `BENCHMARK.json`: a configuration
(`configs[].file`) and a traffic mix (`benchmark/traffic/<traffic>.json`,
whose `driver` names `benchmark/drivers/<driver>.py`). The driver builds
the system under test from the seed, drives it for the window, checks its
answers against `benchmark/reference/` and returns an `Outcome`. Per-layer
metrics are readers of their own, `benchmark/layer_metrics/<metric>.py`,
or `<kind>.py` for a metric `<kind>.<cell part>` that reads as every other
metric of its kind does, each a `read(view)` over the traced window
(`TraceView`) that returns a number or None. Nothing here names a cell: a new cell is a new entry and
new files.

Spans come from the harness only, in the `--trace 1` run: the driver wraps
calls into the program's layers (`Tracer.wrap`, `Tracer.span`), and the
profiler traces the window's last `trace_seconds`. End-to-end metrics come from the `--trace 0` run.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import heapq
import importlib
import importlib.util
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections.abc import Callable, Iterator
from typing import Any

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "benchmark"
SPEC_FILE = ROOT / "BENCHMARK.json"
# never loaded by anything the benchmark runs: compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "xfmr_rec_tpu")
PORT = "xfmr_rec_torch"
# build and kernel caches of the program, at fixed paths in the checkout
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
    "TRITON_CACHE_DIR": ROOT / "build" / "triton",
}
# the sizes of the CPU thread pools PyTorch and NumPy start with
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
BREAKDOWN_ENTRIES = 10
# the CUDA runtime call a traced span makes on entry (a stream query)
MARK_CALL = "cudaStreamQuery"


class BenchError(RuntimeError):
    """A cell that cannot run as BENCHMARK.json describes it."""


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


# -- BENCHMARK.json and the files it names --------------------------------
def load_spec(path: pathlib.Path = SPEC_FILE) -> dict:
    return json.loads(path.read_text())


def cell_entry(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    msg = f"no workload {name!r} in BENCHMARK.json"
    raise BenchError(msg)


def config_of(spec: dict, cell: dict, root: pathlib.Path = ROOT) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == cell["config"]:
            return json.loads((root / entry["file"]).read_text())
    msg = f"no configuration {cell['config']!r} in BENCHMARK.json"
    raise BenchError(msg)


def traffic_of(cell: dict, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json")
                      .read_text())


def driver_module(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    return _load_file(bench_dir / "drivers" / f"{name}.py", "driver")


def reader_module(metric: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The reader of `metric`: its own file, or else its kind's (the name
    before the first dot)."""
    folder = bench_dir / "layer_metrics"
    own = folder / f"{metric}.py"
    kind = folder / f"{metric.split('.')[0]}.py"
    return _load_file(own if own.is_file() else kind, "reader")


def _load_file(path: pathlib.Path, kind: str):
    if not path.is_file():
        msg = f"no {kind} file {path}"
        raise BenchError(msg)
    name = f"benchmark_{kind}_" + path.stem.replace(".", "_").replace("-", "_")
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    sys.modules[name] = module
    module_spec.loader.exec_module(module)
    return module


def metrics_of_cell(spec: dict, cell_name: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    layers = [m for m in spec["per_layer"]
              if cell_name in m.get("workloads", [cell_name])
              and m["moves"] in names]
    return e2e, layers


# -- imports ---------------------------------------------------------------
def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def reference_imports(bench_dir: pathlib.Path = BENCH_DIR) -> list[str]:
    """Imports of `benchmark/reference/` that reach outside plain PyTorch
    and NumPy: the JAX package, JAX, the port, or harness code."""
    bad = []
    for path in sorted((bench_dir / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    names = ["benchmark.<relative>"]
                else:
                    names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                inside = name == "benchmark.reference" or name.startswith(
                    "benchmark.reference.")
                if top in FORBIDDEN or top == PORT or (
                        top == "benchmark" and not inside):
                    bad.append(f"{path.name}: {name}")
    return bad


# -- the process and the card --------------------------------------------
def process_start_epoch() -> float:
    """When this process started (epoch seconds), from /proc: the
    interpreter's start-up and imports count as set-up."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
        ticks = int(fields.split()[19])
        for line in pathlib.Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime "):
                return int(line.split()[1]) + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return time.time()


def card_line() -> str:
    """name, power limit, SM clock, power draw and temperature of card 0."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0]


def limit_host_threads(traffic: dict) -> None:
    """A mix's `host_threads`: the threads of the CPU pools (PyTorch's
    intra-op pool, OpenMP, MKL, OpenBLAS) of this process. Set before
    PyTorch and NumPy load, so that their pools start at that size."""
    threads = traffic.get("host_threads")
    if threads is None:
        return
    for name in THREAD_VARS:
        os.environ[name] = str(int(threads))


def set_cache_dirs() -> None:
    for name, path in CACHE_DIRS.items():
        os.environ[name] = str(path)
    # a library the port may load must not load JAX or Flax through it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


# -- spans and the traced window ------------------------------------------
@dataclasses.dataclass
class Span:
    name: str
    tid: int  # the system's thread id
    start_us: float
    end_us: float
    attrs: dict

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


class Tracer:
    """Harness spans (perf_counter, any thread) and the profiler over one
    sub-window. Inactive in a `--trace 0` run: `span` and `wrap` then cost
    one attribute test."""

    def __init__(self, enabled: bool, seconds: float, out_dir: pathlib.Path):
        self.enabled = enabled
        self.seconds = seconds
        self.out_dir = out_dir
        self.recording = False
        self._spans: list[tuple] = []
        self._lock = threading.Lock()
        self._prof = None
        self._anchor_ns = 0
        self.counters_at: dict[str, Any] = {}
        self.view: TraceView | None = None
        self.marks: Callable[[], Any] | None = None

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        if not self.recording:
            yield
            return
        start = time.perf_counter_ns()
        if self.marks:
            # a runtime call the trace files under this thread's id inside
            # the span: it ties the span to the launches of its thread
            self.marks()
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            with self._lock:
                self._spans.append(
                    (name, threading.get_native_id(), start, end, attrs))

    def wrap(self, obj: Any, method: str, name: str,
             attrs: Callable[..., dict] | None = None) -> None:
        """Record a span around every call of `obj.method` (an instance
        attribute shadows the bound method; the program is not edited)."""
        if not self.enabled:
            return
        inner = getattr(obj, method)

        def wrapped(*args, **kwargs):
            if not self.recording:
                return inner(*args, **kwargs)
            extra = attrs(*args, **kwargs) if attrs else {}
            with self.span(name, **extra):
                return inner(*args, **kwargs)

        setattr(obj, method, wrapped)

    @staticmethod
    def _profiler():
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def warm(self) -> None:
        """One throwaway trace in set-up: the profiler's first trace spends
        seconds starting up, which must not fall in the traced window."""
        if not self.enabled:
            return
        import torch

        with self._profiler(), torch.profiler.record_function("bench.warm"):
            torch.ones(8).sum()
            if torch.cuda.is_available():
                torch.ones(8, device="cuda").sum().item()

    def start(self, counters: dict | None = None) -> None:
        import torch

        if torch.cuda.is_available():
            self.marks = lambda: torch.cuda.current_stream().query()
        self._prof = self._profiler()
        self._prof.start()
        with torch.profiler.record_function("bench.anchor"):
            self._anchor_ns = time.perf_counter_ns()
        self.counters_at["start"] = dict(counters or {})
        self.recording = True

    def stop(self, counters: dict | None = None) -> None:
        import torch

        self.recording = False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stop_ns = time.perf_counter_ns()
        self.counters_at["stop"] = dict(counters or {})
        self._prof.stop()
        path = self.out_dir / "trace.json"
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        self.view = TraceView.build(events, self._spans, self._anchor_ns,
                                    stop_ns)

    def tick(self, elapsed: float, window_s: float,
             counters: Callable[[], dict] | None = None) -> None:
        """For a driver whose own loop runs the window: start the profiler
        as `elapsed` enters the window's last `seconds`; `finish` stops
        it once the window has closed."""
        if not self.enabled or self.recording or self.view is not None:
            return
        if elapsed >= window_s - min(self.seconds, window_s):
            self.start(counters() if counters else None)

    def finish(self, counters: Callable[[], dict] | None = None) -> None:
        """Stop a profiler the window's end left running."""
        if self.recording:
            self.stop(counters() if counters else None)


@dataclasses.dataclass
class TraceView:
    """What the profiler saw in the traced sub-window, on its clock (us)."""

    start_us: float
    end_us: float
    kernels: list[tuple[str, float, float, int]]  # name, start, dur, corr
    launches: dict[int, tuple[int, float]]  # correlation -> (tid, start)
    host_ops: list[tuple[str, int, float, float]]  # name, tid, start, dur
    marks: list[tuple[float, int]]  # (start, profiler's thread id) of marks
    spans: list[Span]
    counters: dict = dataclasses.field(default_factory=dict)
    facts: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, events, spans, anchor_ns, stop_ns) -> TraceView:
        anchor = next(
            (e for e in events if e.get("name") == "bench.anchor"), None)
        if anchor is None:
            msg = "the trace holds no anchor event"
            raise BenchError(msg)
        offset = float(anchor["ts"]) - anchor_ns / 1e3
        kernels, launches, host, marks = [], {}, [], []
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                kernels.append((e["name"], float(e["ts"]), float(e["dur"]),
                                int(e.get("args", {}).get("correlation", -1))))
            elif cat == "cuda_runtime":
                if e["name"] == MARK_CALL:
                    marks.append((float(e["ts"]), int(e["tid"])))
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[int(corr)] = (int(e["tid"]), float(e["ts"]))
            elif cat in ("cpu_op", "user_annotation"):
                host.append((e["name"], int(e["tid"]), float(e["ts"]),
                             float(e["dur"])))
        view_spans = [
            Span(name, tid, start / 1e3 + offset, end / 1e3 + offset, attrs)
            for name, tid, start, end, attrs in spans
        ]
        return cls(start_us=float(anchor["ts"]), end_us=stop_ns / 1e3 + offset,
                   kernels=kernels, launches=launches, host_ops=host,
                   marks=sorted(marks), spans=view_spans)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """Merged intervals in which some operation ran on the device."""
        merged: list[list[float]] = []
        for _, start, dur, _ in sorted(self.kernels, key=lambda k: k[1]):
            end = start + dur
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(max(s, self.start_us), min(e, self.end_us))
                for s, e in merged if e > self.start_us and s < self.end_us]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def spans_named(self, name: str) -> list[Span]:
        """The spans of `name` that ended inside the traced window."""
        return [s for s in self.spans
                if s.name == name and self.start_us <= s.end_us <= self.end_us]

    def _profiler_tid(self, span: Span) -> int | None:
        """The id under which the profiler filed the launches of the span's
        thread (the system's id for the thread that started the profiler,
        an id of its own for any other): that of the first mark inside the
        span."""
        for at, tid in self.marks:
            if span.start_us <= at <= span.end_us:
                return tid
        return None

    def kernel_seconds_in(self, spans: list[Span]) -> list[float | None]:
        """For each span, the device seconds of the operations its own
        thread launched inside it; None where the trace holds no mark of
        the span."""
        launched: dict[int, list[tuple[float, float]]] = {}
        for _, _, dur, corr in self.kernels:
            launch = self.launches.get(corr)
            if launch is not None:
                launched.setdefault(launch[0], []).append((launch[1], dur))
        out = []
        for span in spans:
            tid = self._profiler_tid(span)
            out.append(None if tid is None else sum(
                dur for at, dur in launched.get(tid, ())
                if span.start_us <= at <= span.end_us) / 1e6)
        return out

    def counter_delta(self, name: str) -> float | None:
        start = self.counters.get("start", {}).get(name)
        stop = self.counters.get("stop", {}).get(name)
        if start is None or stop is None:
            return None
        return stop - start

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing at each gap's middle: the
        innermost host operation or harness span covering it."""
        by_op: dict[str, float] = {}
        for name, _, dur, _ in self.kernels:
            by_op[name] = by_op.get(name, 0.0) + dur / 1e6
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for iv in busy for x in iv] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        names = self._host_at([(a + b) / 2 for a, b in gaps])
        by_gap: dict[str, float] = {}
        for (a, b), name in zip(gaps, names, strict=True):
            by_gap[name] = by_gap.get(name, 0.0) + (b - a) / 1e6

        def top(table):
            return [[k, v] for k, v in sorted(
                table.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]

        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}

    def _host_at(self, points: list[float]) -> list[str]:
        """For each point, in one sweep over the host's intervals: the
        shortest host operation or harness span covering it."""
        intervals = sorted(
            [(s.start_us, s.end_us, s.name) for s in self.spans]
            + [(start, start + dur, name) for name, _, start, dur
               in self.host_ops if name != "bench.anchor"])
        order = sorted(range(len(points)), key=points.__getitem__)
        names = ["no traced host work"] * len(points)
        live: list[tuple[float, float, str]] = []  # (duration, end, name)
        nxt = 0
        for k in order:
            t = points[k]
            while nxt < len(intervals) and intervals[nxt][0] <= t:
                start, end, name = intervals[nxt]
                heapq.heappush(live, (end - start, end, name))
                nxt += 1
            # an interval that ended before t ended before every later point
            while live and live[0][1] < t:
                heapq.heappop(live)
            if live:
                names[k] = live[0][2]
        return names


# -- a run -----------------------------------------------------------------
@dataclasses.dataclass
class Check:
    """A number compared with its limit: correct when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_from(readings: dict[str, float], limits: dict[str, float]
                ) -> list[Check]:
    """A check for each reading that the traffic mix gives a limit; every
    reading is logged, compared or not."""
    log("readings: " + json.dumps(readings))
    missing = sorted(set(limits) - set(readings))
    if missing:
        msg = f"limits for numbers no check reads: {missing}"
        raise BenchError(msg)
    return [Check(name, float(readings[name]), float(limit))
            for name, limit in limits.items()]


@dataclasses.dataclass
class Outcome:
    metrics: dict[str, float]
    attempted: int
    failed: int
    checks: list[Check]


class Run:
    """What a driver gets: the cell's inputs, a scratch directory, the
    tracer, and the marks that time set-up."""

    def __init__(self, *, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, run_dir: pathlib.Path,
                 process_start: float) -> None:
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.run_dir = run_dir
        self.process_start = process_start
        self.tracer = Tracer(trace, float(traffic.get("trace_seconds", 3.0)),
                             run_dir)
        self.tracer.warm()
        self.setup_s: float | None = None
        self.memory_peak_bytes: int | None = None
        self.facts: dict[str, Any] = {}

    def mark(self, what: str) -> None:
        """Log how far set-up has come: seconds since the process began."""
        log(f"set-up: {what} at {time.time() - self.process_start:.3f} s")

    def window_starts(self, at_epoch: float | None = None) -> None:
        """Set-up ends here: the first timed batch or step."""
        at = time.time() if at_epoch is None else at_epoch
        self.setup_s = at - self.process_start

    def read_memory_peak(self) -> None:
        """The device memory peak, read before the reference runs."""
        import torch

        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
                self.device))
        else:
            self.memory_peak_bytes = 0


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             process_start: float, *, root: pathlib.Path = ROOT,
             overrides: dict | None = None) -> dict:
    """Run one cell on `device` and return the result line's object.
    `root` holds BENCHMARK.json and benchmark/; `overrides` replaces
    traffic parameters (the CPU rehearsals' small sizes)."""
    spec = load_spec(root / "BENCHMARK.json")
    bench_dir = root / "benchmark"
    cell = cell_entry(spec, cell_name)
    config = config_of(spec, cell, root)
    traffic = dict(traffic_of(cell, bench_dir), **(overrides or {}))
    e2e, layers = metrics_of_cell(spec, cell_name)
    driver = driver_module(traffic["driver"], bench_dir)
    readers = {m["name"]: reader_module(m["name"], bench_dir) for m in layers}
    base = pathlib.Path(tempfile.gettempdir())
    run_dir = pathlib.Path(tempfile.mkdtemp(prefix="bench-", dir=base))
    try:
        run = Run(cell=cell, config=config, traffic=traffic, seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  run_dir=run_dir, process_start=process_start)
        outcome = driver.run(run)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    values = dict(outcome.metrics)
    values["setup_s"] = run.setup_s
    units = {m["name"]: m["unit"] for m in e2e + layers}
    metrics = {}
    if trace:
        view = run.tracer.view
        if view is None:
            msg = "the traced run recorded no sub-window"
            raise BenchError(msg)
        view.counters = run.tracer.counters_at
        view.facts = dict(run.facts, config=config, traffic=traffic)
        for name, reader in readers.items():
            value = reader.read(view)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        for m in e2e:
            if values.get(m["name"]) is None:
                msg = f"the driver gave no value for {m['name']}"
                raise BenchError(msg)
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": _device_kind(device),
        "count": int(cell["chips"]),
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    result = {
        "correct": all(c.ok for c in outcome.checks) and not outcome.failed,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        device_info["busy_s"] = view.busy_s
        device_info["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in outcome.checks}
    return result


def _device_kind(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
