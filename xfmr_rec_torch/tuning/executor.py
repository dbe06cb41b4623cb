"""Concurrent trial execution across device-pinned worker processes.

Port of `xfmr_rec_tpu/tuning/executor.py`. Each trial runs in a worker
*process* pinned to a disjoint device subset by `CUDA_VISIBLE_DEVICES`,
set by the pool's initializer before the worker's first CUDA call:

- cpu platform: the worker sees no card (`CUDA_VISIBLE_DEVICES=""`) and
  its trainer runs on `device="cpu"`, as a mesh of `devices_per_worker`
  CPU slots when that is more than 1.
- cuda platform: worker `w` sees cards `w*k .. w*k+k-1` (k =
  `devices_per_worker`) as its `cuda:0 .. cuda:k-1`. The worker count
  clamps to the cards present (`torch.cuda.device_count() // k`): a
  worker pinned to a missing card would fail every trial, so a one-card
  host runs one worker and its trials one after another. This is the
  default platform, where the JAX package's default is cpu: the port's
  entry points run on the card unless the caller asks for the CPU.

Nothing here or in `hpo.py` touches CUDA when imported: unpickling the
initializer imports these modules in the worker before the pinning runs,
and a CUDA call (`torch.cuda.is_available()` and `device_count()`
included) fixes the visible cards for the process. Workers are started
with `spawn`, never `fork`, so a parent that has used the card passes
nothing of its CUDA state on.

The executor is rung-synchronous: `hpo.tune` dispatches every trial of
one successive-halving rung concurrently, waits, ranks and promotes, so
results at fixed seeds equal the sequential loop's (configs are proposed
in the parent; an evaluation is a function of its config). On the card
a trial's metric can move in its last bits between processes: the
embedding backward sums with atomics. A trial that raises, or whose
worker dies, is a failed trial with empty metrics, as in the sequential
loop.

One single-process pool per worker (not one shared pool), because each
worker needs its own initializer environment. Jobs go to whichever
worker frees up first.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from concurrent.futures import FIRST_COMPLETED, Future, ProcessPoolExecutor, wait
from typing import Any

logger = logging.getLogger(__name__)

PLATFORMS = ("cpu", "cuda")


def worker_device_env(
    worker_id: int,
    n_workers: int,
    *,
    platform: str = "cuda",
    devices_per_worker: int = 1,
) -> dict[str, str]:
    """Environment pinning worker `worker_id` to a disjoint device subset.

    The pool initializer sets it before the worker's first CUDA call.
    """
    if platform == "cpu":
        return {"CUDA_VISIBLE_DEVICES": ""}
    if platform == "cuda":
        cards = range(
            worker_id * devices_per_worker,
            (worker_id + 1) * devices_per_worker,
        )
        return {"CUDA_VISIBLE_DEVICES": ",".join(str(c) for c in cards)}
    msg = f"unknown platform {platform!r}; expected one of {PLATFORMS}"
    raise ValueError(msg)


def _worker_init(env: dict[str, str]) -> None:
    """Pool initializer: pin the worker's devices before any CUDA call."""
    os.environ.update(env)


def _run_trial(
    spec: dict[str, Any], trial_id: int, config: dict[str, Any], resource: float
) -> tuple[dict[str, float], float, int]:
    """Execute one trial in the worker; returns (metrics, seconds, pid).

    Module-level (picklable) and defensive: an exception inside the
    trial returns empty metrics, which the parent treats exactly as the
    sequential loop treats a raising `evaluate`.
    """
    t0 = time.time()
    try:
        evaluate = _evaluator_from_spec(spec, trial_id)
        metrics = dict(evaluate(config, resource))
    except Exception:  # noqa: BLE001 — a failing trial is a data point
        logger.exception("trial %d failed in worker", trial_id)
        metrics = {}
    return metrics, time.time() - t0, os.getpid()


def _evaluator_from_spec(spec: dict[str, Any], trial_id: int):
    """Rebuild the evaluate callable inside the worker process.

    Closures don't pickle, so the parent ships a declarative spec:
    - {"kind": "trainer", base_model/base_data/base_trainer, "device",
      "devices_per_worker"}: the real Trainer evaluator
      (hpo.make_trainer_evaluator) on `device` (default cuda), a mesh of
      that many CPU slots on the cpu platform. Each trial gets its own
      run_name so concurrent workers never share a log dir.
    - {"kind": "import", "path": "module:function"}: a module-level
      callable, used by tests and custom objectives.
    """
    kind = spec.get("kind")
    if kind == "trainer":
        from xfmr_rec_torch.tuning.hpo import make_trainer_evaluator

        base_trainer = dict(spec.get("base_trainer") or {})
        if not base_trainer.get("run_name"):
            base_trainer["run_name"] = f"trial-{trial_id:04d}"
        device = spec.get("device", "cuda")
        slots = int(spec.get("devices_per_worker", 1))
        return make_trainer_evaluator(
            base_model=spec.get("base_model"),
            base_data=spec.get("base_data"),
            base_trainer=base_trainer,
            device=device,
            devices=[device] * slots if device == "cpu" and slots > 1 else None,
        )
    if kind == "import":
        import importlib

        mod_name, _, fn_name = spec["path"].partition(":")
        return getattr(importlib.import_module(mod_name), fn_name)
    msg = f"unknown evaluator spec kind {kind!r}"
    raise ValueError(msg)


@dataclasses.dataclass
class TrialOutcome:
    metrics: dict[str, float]
    seconds: float
    worker_pid: int


class TrialExecutor:
    """N device-pinned worker processes evaluating trials concurrently.

    Use as a context manager (workers are real OS processes):

        spec = {"kind": "trainer", "base_data": {...}}
        with TrialExecutor(spec, workers=4, platform="cuda") as ex:
            result = tune(None, executor=ex, ...)

    The workers run on the card unless the caller passes
    `platform="cpu"`. A trainer spec runs on the platform's device:
    `platform` sets its "device" (cpu or cuda) and "devices_per_worker".
    """

    def __init__(
        self,
        spec: dict[str, Any],
        *,
        workers: int = 1,
        platform: str = "cuda",
        devices_per_worker: int = 1,
        env_overrides: dict[str, str] | None = None,
    ) -> None:
        if workers < 1:
            msg = f"workers must be >= 1, got {workers}"
            raise ValueError(msg)
        if platform not in PLATFORMS:
            msg = f"unknown platform {platform!r}; expected one of {PLATFORMS}"
            raise ValueError(msg)
        if platform == "cuda":
            import torch

            n_cards = torch.cuda.device_count()
            fit = max(1, n_cards // max(devices_per_worker, 1))
            if workers > fit:
                logger.warning(
                    "clamping workers %d -> %d (%d card(s) present, "
                    "%d per worker)",
                    workers, fit, n_cards, devices_per_worker,
                )
                workers = fit
        if spec.get("kind") == "trainer":
            spec = {
                **spec,
                "device": platform,
                "devices_per_worker": devices_per_worker,
            }
        self.spec = spec
        self.workers = workers
        self._envs = []
        for wid in range(workers):
            env = worker_device_env(
                wid, workers, platform=platform,
                devices_per_worker=devices_per_worker,
            )
            env.update(env_overrides or {})
            self._envs.append(env)
        self._pools = [self._start(env) for env in self._envs]

    @staticmethod
    def _start(env: dict[str, str]) -> ProcessPoolExecutor:
        import multiprocessing

        return ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init,
            initargs=(env,),
        )

    def run(
        self, jobs: list[tuple[int, dict[str, Any], float]]
    ) -> list[TrialOutcome]:
        """Evaluate (trial_id, config, resource) jobs; results in job order.

        Greedy scheduling: each job goes to the first worker that frees
        up, so a rung larger than the pool keeps every device subset
        busy until the rung drains.
        """
        results: list[TrialOutcome | None] = [None] * len(jobs)
        pending: dict[Future, tuple[int, int]] = {}  # future -> (job_idx, pool)
        free = list(range(len(self._pools)))
        next_job = 0
        while next_job < len(jobs) or pending:
            while free and next_job < len(jobs):
                pool_idx = free.pop()
                trial_id, config, resource = jobs[next_job]
                fut = self._pools[pool_idx].submit(
                    _run_trial, self.spec, trial_id, config, resource
                )
                pending[fut] = (next_job, pool_idx)
                next_job += 1
            if not pending:
                break
            done, _ = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                job_idx, pool_idx = pending.pop(fut)
                free.append(pool_idx)
                try:
                    metrics, seconds, pid = fut.result()
                except Exception:  # noqa: BLE001 — dead worker = failed trial
                    logger.exception(
                        "trial %d worker died", jobs[job_idx][0]
                    )
                    metrics, seconds, pid = {}, 0.0, -1
                    # a pool whose process died takes no more jobs
                    self._pools[pool_idx].shutdown(wait=False)
                    self._pools[pool_idx] = self._start(self._envs[pool_idx])
                results[job_idx] = TrialOutcome(metrics, seconds, pid)
        return [r for r in results if r is not None]

    def shutdown(self) -> None:
        for pool in self._pools:
            pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> TrialExecutor:
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
