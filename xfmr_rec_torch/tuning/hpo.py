"""Hyperparameter search: adaptive sampling + successive halving.

Port of `xfmr_rec_tpu/tuning/hpo.py`. The search space, both samplers,
the plateau stopper and the tuning loops are numpy and the standard library,
copied with their arithmetic and their `np.random.Generator` call order,
so one seed and the same observations propose dict-equal configs with
bit-equal floats in either package:
- the space: train_loss in {PairwiseHinge, PairwiseLogistic,
  AlignmentContrastive, MINE}, num_negatives = 2^randint(0..6), sigma
  log-uniform on [1, 1000], margin uniform on [-1, 1] in steps of 0.01,
  learning_rate log-uniform on [1e-4, 1e-2];
- the resource is `limit_train_batches`, 1/16 -> 1.0 with reduction
  factor 2; the objective val/RetrievalNormalizedDCG, max (params.py
  METRIC);
- `AdaptiveSampler` (top-quartile resampling with log-normal
  perturbation), `TPESampler` (a density-ratio surrogate) and
  `PlateauStopper`.

`tune()` runs one synchronous successive-halving bracket over a fixed
config list; `tune_adaptive()` chains brackets, feeding each bracket's
results back into the sampler and stopping on plateau. Trials run one
after another in the process by default, or concurrently across
device-pinned worker processes via `--workers N` /
`executor=TrialExecutor(...)` (tuning/executor.py): each worker owns a
disjoint set of cards, so on a one-card host it clamps to one worker.

Each trial is the port's `Trainer` (`make_trainer_evaluator`), on the
card by default (`--device cuda`): its validations search the eval index,
which from 65,536 items is the packed scan (kernel 1). The trial workers
default to the card as well (`--worker_platform cuda`, where the JAX
package's default is its CPU workers), as every entry point of the port
does.

    python -m xfmr_rec_torch.tuning.hpo --data_dir data --num_samples 16 \\
        --time_budget_s 3600 --model max_length=32
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import pathlib
import time
from collections.abc import Callable
from typing import Any

import numpy as np

from xfmr_rec_torch.params import METRIC

logger = logging.getLogger(__name__)

TRAIN_LOSSES = (
    "PairwiseHingeLoss",
    "PairwiseLogisticLoss",
    "AlignmentContrastiveLoss",
    "MutualInformationNeuralEstimationLoss",
)


@dataclasses.dataclass
class SearchSpace:
    """Samples reference-compatible configs (flaml.py:59-79)."""

    train_losses: tuple[str, ...] = TRAIN_LOSSES
    log_num_negatives: tuple[int, int] = (0, 6)
    sigma: tuple[float, float] = (1.0, 1000.0)
    margin: tuple[float, float, float] = (-1.0, 1.0, 0.01)
    learning_rate: tuple[float, float] = (1e-4, 1e-2)

    def sample(self, rng: np.random.Generator) -> dict[str, Any]:
        lo, hi = self.log_num_negatives
        m_lo, m_hi, m_step = self.margin
        margin = round(
            rng.uniform(m_lo, m_hi) / m_step
        ) * m_step
        return {
            "train_loss": str(rng.choice(self.train_losses)),
            "num_negatives": int(2 ** rng.integers(lo, hi + 1)),
            "sigma": float(
                np.exp(rng.uniform(np.log(self.sigma[0]), np.log(self.sigma[1])))
            ),
            "margin": float(margin),
            "learning_rate": float(
                np.exp(
                    rng.uniform(
                        np.log(self.learning_rate[0]),
                        np.log(self.learning_rate[1]),
                    )
                )
            ),
        }

    def default_point(self) -> dict[str, Any]:
        """The reference's point_to_evaluate (flaml.py:65-72)."""
        return {
            "train_loss": "PairwiseHingeLoss",
            "num_negatives": 1,
            "sigma": 1.0,
            "margin": 1.0,
            "learning_rate": 0.001,
        }


class AdaptiveSampler:
    """Top-quartile resampling: propose near configs that scored well.

    Replaces FLAML BlendSearch (reference flaml.py:87-100) with a
    transparent evolutionary scheme: the first `n_startup` proposals are
    random; afterwards, with probability `explore` a fresh random config
    is drawn (coverage), otherwise a uniformly random *elite* (top
    `elite_frac` of observed trials by metric) is perturbed — categorical
    re-draws with small probability, log-scale params jittered
    log-normally, margin jittered and re-quantized. Observations at
    higher SHA rungs naturally dominate the elite set because their
    metrics are computed with more resource.
    """

    def __init__(
        self,
        space: SearchSpace,
        *,
        seed: int = 0,
        n_startup: int = 8,
        elite_frac: float = 0.25,
        explore: float = 0.2,
        scale: float = 1.0,
    ) -> None:
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.elite_frac = elite_frac
        self.explore = explore
        self.scale = scale
        self.observations: list[tuple[float, dict[str, Any]]] = []

    def observe(self, config: dict[str, Any], metric: float) -> None:
        if math.isfinite(metric):
            self.observations.append((metric, dict(config)))

    def propose(self) -> dict[str, Any]:
        obs = self.observations
        if len(obs) < self.n_startup or self.rng.random() < self.explore:
            return self.space.sample(self.rng)
        ranked = sorted(obs, key=lambda mc: mc[0], reverse=True)
        n_elite = max(1, int(len(ranked) * self.elite_frac))
        parent = ranked[int(self.rng.integers(n_elite))][1]
        return self._perturb(parent)

    def _perturb(self, cfg: dict[str, Any]) -> dict[str, Any]:
        rng, space, s = self.rng, self.space, self.scale
        out = dict(cfg)
        if rng.random() < 0.3:
            out["train_loss"] = str(rng.choice(space.train_losses))
        lo, hi = space.log_num_negatives
        log_nn = int(round(math.log2(max(1, cfg["num_negatives"]))))
        out["num_negatives"] = int(
            2 ** int(np.clip(log_nn + rng.integers(-1, 2), lo, hi))
        )
        out["sigma"] = float(
            np.clip(
                cfg["sigma"] * math.exp(rng.normal(0.0, 0.5 * s)),
                space.sigma[0], space.sigma[1],
            )
        )
        m_lo, m_hi, m_step = space.margin
        margin = cfg["margin"] + rng.normal(0.0, 0.25 * s)
        out["margin"] = float(
            np.clip(round(margin / m_step) * m_step, m_lo, m_hi)
        )
        out["learning_rate"] = float(
            np.clip(
                cfg["learning_rate"] * math.exp(rng.normal(0.0, 0.5 * s)),
                space.learning_rate[0], space.learning_rate[1],
            )
        )
        return out


class TPESampler:
    """Tree-structured Parzen Estimator proposals (Bergstra et al.,
    NeurIPS'11): the global-model half of a BlendSearch-style search
    (FLAML's BlendSearch mixes a global Bayesian searcher with local
    search; AdaptiveSampler covers the local half).

    Observations split into good (top `gamma` fraction by metric) and
    bad; each dimension gets a pair of 1-D density models — categorical
    frequency tables with Laplace smoothing for train_loss /
    num_negatives, Gaussian KDEs (log-space for sigma / learning_rate,
    linear for margin) for the continuous params. A proposal draws
    `n_candidates` samples from the good-density and returns the one
    maximizing the density ratio l(x)/g(x) (the TPE
    expected-improvement surrogate). Same observe/propose interface as
    AdaptiveSampler, so it composes with SHA brackets, the plateau
    stopper, the trial executor, and warm_start_sampler unchanged.
    """

    def __init__(
        self,
        space: SearchSpace,
        *,
        seed: int = 0,
        n_startup: int = 8,
        gamma: float = 0.25,
        n_candidates: int = 24,
    ) -> None:
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.observations: list[tuple[float, dict[str, Any]]] = []

    def observe(self, config: dict[str, Any], metric: float) -> None:
        if math.isfinite(metric):
            self.observations.append((metric, dict(config)))

    # -- density helpers ---------------------------------------------------
    @staticmethod
    def _cat_logp(values: list, choices: tuple, value) -> float:
        counts = {c: 1.0 for c in choices}  # Laplace smoothing
        for v in values:
            counts[v] = counts.get(v, 1.0) + 1.0
        total = sum(counts.values())
        return math.log(counts.get(value, 1.0) / total)

    @staticmethod
    def _kde_logp(points: np.ndarray, span: float, x: float) -> float:
        if len(points) == 0:
            return -math.log(max(span, 1e-12))  # uniform over the span
        # Scott's rule with a floor so sparse data keeps coverage
        bw = max(
            points.std() * len(points) ** -0.2 if len(points) > 1 else span,
            0.1 * span,
            1e-12,
        )
        z = (x - points) / bw
        log_kernels = -0.5 * z * z - math.log(bw * math.sqrt(2 * math.pi))
        peak = float(np.max(log_kernels))
        return peak + math.log(
            float(np.mean(np.exp(log_kernels - peak)))
        )

    def _split(self) -> tuple[list[dict], list[dict]]:
        ranked = sorted(
            self.observations, key=lambda mc: mc[0], reverse=True
        )
        n_good = max(1, int(len(ranked) * self.gamma))
        return (
            [c for _, c in ranked[:n_good]],
            [c for _, c in ranked[n_good:]],
        )

    def _sample_from_good(self, good: list[dict]) -> dict[str, Any]:
        """Draw one candidate from the good-side density (mixture of
        kernels centered on good observations + the prior)."""
        rng, space = self.rng, self.space
        if rng.random() < 1.0 / (len(good) + 1):
            return space.sample(rng)  # prior component
        parent = good[int(rng.integers(len(good)))]
        out = dict(parent)
        if rng.random() < 0.2:
            out["train_loss"] = str(rng.choice(space.train_losses))
        lo, hi = space.log_num_negatives
        log_nn = int(round(math.log2(max(1, parent["num_negatives"]))))
        out["num_negatives"] = int(
            2 ** int(np.clip(log_nn + rng.integers(-1, 2), lo, hi))
        )
        log_span_sigma = math.log(space.sigma[1] / space.sigma[0])
        out["sigma"] = float(
            np.clip(
                parent["sigma"]
                * math.exp(rng.normal(0.0, 0.15 * log_span_sigma)),
                space.sigma[0],
                space.sigma[1],
            )
        )
        m_lo, m_hi, m_step = space.margin
        margin = parent["margin"] + rng.normal(0.0, 0.15 * (m_hi - m_lo))
        out["margin"] = float(
            np.clip(round(margin / m_step) * m_step, m_lo, m_hi)
        )
        log_span_lr = math.log(
            space.learning_rate[1] / space.learning_rate[0]
        )
        out["learning_rate"] = float(
            np.clip(
                parent["learning_rate"]
                * math.exp(rng.normal(0.0, 0.15 * log_span_lr)),
                space.learning_rate[0],
                space.learning_rate[1],
            )
        )
        return out

    def _logratio(
        self, cfg: dict[str, Any], good: list[dict], bad: list[dict]
    ) -> float:
        space = self.space
        score = 0.0
        score += self._cat_logp(
            [c["train_loss"] for c in good], space.train_losses,
            cfg["train_loss"],
        ) - self._cat_logp(
            [c["train_loss"] for c in bad], space.train_losses,
            cfg["train_loss"],
        )
        nn_choices = tuple(
            2**e
            for e in range(
                space.log_num_negatives[0], space.log_num_negatives[1] + 1
            )
        )
        score += self._cat_logp(
            [c["num_negatives"] for c in good], nn_choices,
            cfg["num_negatives"],
        ) - self._cat_logp(
            [c["num_negatives"] for c in bad], nn_choices,
            cfg["num_negatives"],
        )
        for name, transform, span in (
            (
                "sigma",
                math.log,
                math.log(space.sigma[1] / space.sigma[0]),
            ),
            (
                "margin",
                lambda v: v,
                space.margin[1] - space.margin[0],
            ),
            (
                "learning_rate",
                math.log,
                math.log(space.learning_rate[1] / space.learning_rate[0]),
            ),
        ):
            x = transform(cfg[name])
            pts_good = np.asarray([transform(c[name]) for c in good])
            pts_bad = np.asarray([transform(c[name]) for c in bad])
            score += self._kde_logp(pts_good, span, x) - self._kde_logp(
                pts_bad, span, x
            )
        return score

    def propose(self) -> dict[str, Any]:
        if len(self.observations) < self.n_startup:
            return self.space.sample(self.rng)
        good, bad = self._split()
        best_cfg, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cand = self._sample_from_good(good)
            score = self._logratio(cand, good, bad)
            if score > best_score:
                best_cfg, best_score = cand, score
        return dict(best_cfg)


@dataclasses.dataclass
class PlateauStopper:
    """Stop the experiment when the best metric stops improving.

    Equivalent of Ray's ExperimentPlateauStopper (reference
    ray.py:170-177): `update(metric)` returns True once `patience`
    consecutive updates have failed to beat the running best by more
    than `min_delta` (the reference's EarlyStopping min_delta=1e-3,
    lightning.py:247-249).
    """

    patience: int = 8
    min_delta: float = 1e-3
    best: float = -math.inf
    stale: int = 0

    def update(self, metric: float) -> bool:
        if metric > self.best + self.min_delta:
            self.best = metric
            self.stale = 0
        else:
            self.stale += 1
        return self.stale >= self.patience

    @property
    def stopped(self) -> bool:
        return self.stale >= self.patience


@dataclasses.dataclass
class Trial:
    trial_id: int
    config: dict[str, Any]
    resource: float
    metric: float = -math.inf
    metrics: dict[str, float] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0


@dataclasses.dataclass
class TuneResult:
    trials: list[Trial]
    metric_name: str

    @property
    def best_trial(self) -> Trial:
        return max(self.trials, key=lambda t: t.metric)

    @property
    def best_config(self) -> dict[str, Any]:
        return self.best_trial.config


def tune(
    evaluate: Callable[[dict[str, Any], float], dict[str, float]],
    *,
    space: SearchSpace | None = None,
    num_samples: int = 16,
    min_resource: float = 1 / 16,
    max_resource: float = 1.0,
    reduction_factor: int = 2,
    time_budget_s: float | None = None,
    metric_name: str = METRIC["name"],
    seed: int = 0,
    log_path: str | pathlib.Path | None = None,
    include_default_point: bool = True,
    configs: list[dict[str, Any]] | None = None,
    first_trial_id: int = 0,
    executor: Any | None = None,
) -> TuneResult:
    """Successive halving over sampled (or explicitly given) configs.

    `evaluate(config, resource)` runs one training with
    limit_train_batches=resource and returns the val metric dict.
    Passing `configs` skips sampling — used by `tune_adaptive` to run
    one SHA bracket over sampler proposals.

    With `executor` (a tuning.executor.TrialExecutor), every trial of a
    rung is dispatched concurrently to device-pinned worker processes —
    the reference's Ray Tune trial parallelism (ray.py:105-191). The
    rung barrier means results at fixed seeds match the sequential
    loop; `evaluate` is then unused and may be None. The time budget is
    checked at rung boundaries (a dispatched rung runs to completion).
    """
    space = space or SearchSpace()
    rng = np.random.default_rng(seed)
    start = time.time()
    log_file = None
    if log_path is not None:
        log_path = pathlib.Path(log_path)
        log_path.parent.mkdir(parents=True, exist_ok=True)
        log_file = log_path.open("a")

    def out_of_budget() -> bool:
        return (
            time_budget_s is not None and time.time() - start > time_budget_s
        )

    if configs is None:
        configs = []
        if include_default_point:
            configs.append(space.default_point())
        while len(configs) < num_samples:
            configs.append(space.sample(rng))
    else:
        configs = [dict(c) for c in configs]

    trials: list[Trial] = []
    active = [
        Trial(trial_id=first_trial_id + i, config=config,
              resource=min_resource)
        for i, config in enumerate(configs)
    ]
    next_id = first_trial_id + len(active)
    resource = min_resource

    def record(trial: Trial, metrics: dict[str, float], seconds: float) -> None:
        trial.resource = resource
        trial.metrics = metrics
        trial.metric = metrics.get(metric_name, -math.inf)
        trial.seconds = seconds
        trials.append(dataclasses.replace(trial))
        if log_file:
            log_file.write(json.dumps(dataclasses.asdict(trial)) + "\n")
            log_file.flush()
        logger.info(
            "trial %d resource=%.4f metric=%.4f config=%s",
            trial.trial_id, resource, trial.metric, trial.config,
        )

    while active:
        if executor is not None:
            if out_of_budget():
                logger.info("time budget exhausted")
            else:
                outcomes = executor.run(
                    [(t.trial_id, t.config, resource) for t in active]
                )
                for trial, outcome in zip(active, outcomes):
                    record(trial, outcome.metrics, outcome.seconds)
        else:
            for trial in active:
                if out_of_budget():
                    logger.info("time budget exhausted")
                    break
                t0 = time.time()
                try:
                    metrics = evaluate(trial.config, resource)
                except Exception:  # noqa: BLE001 — a failing trial is a data point
                    logger.exception("trial %d failed", trial.trial_id)
                    metrics = {}
                record(trial, metrics, time.time() - t0)
        if out_of_budget() or resource >= max_resource:
            break
        # promote the top 1/reduction_factor to the next rung
        ranked = sorted(active, key=lambda t: t.metric, reverse=True)
        keep = max(1, len(ranked) // reduction_factor)
        active = [
            Trial(trial_id=next_id + i, config=t.config, resource=resource)
            for i, t in enumerate(ranked[:keep])
        ]
        next_id += len(active)
        resource = min(max_resource, resource * reduction_factor)
    if log_file:
        log_file.close()
    return TuneResult(trials=trials, metric_name=metric_name)


def tune_adaptive(
    evaluate: Callable[[dict[str, Any], float], dict[str, float]],
    *,
    space: SearchSpace | None = None,
    total_samples: int = 32,
    bracket_size: int = 8,
    min_resource: float = 1 / 16,
    max_resource: float = 1.0,
    reduction_factor: int = 2,
    time_budget_s: float | None = None,
    metric_name: str = METRIC["name"],
    seed: int = 0,
    log_path: str | pathlib.Path | None = None,
    sampler: AdaptiveSampler | None = None,
    plateau: PlateauStopper | None = None,
    include_default_point: bool = True,
    executor: Any | None = None,
) -> TuneResult:
    """Adaptive SHA: brackets of sampler proposals, stop on plateau.

    Each bracket runs a synchronous SHA over `bracket_size` proposals;
    every completed trial's metric feeds the sampler, and the plateau
    stopper sees each trial in completion order — the experiment ends
    when `plateau.patience` consecutive trials fail to improve the best
    metric by `min_delta`, when `total_samples` fresh configs have been
    proposed, or when the time budget runs out. Bracket 1 includes the
    reference's default point (flaml.py:65-72) unless
    `include_default_point=False` (a warm-started sampler proposes
    elite perturbations from the first trial, so the default point
    would waste a slot).
    """
    space = space or SearchSpace()
    sampler = sampler or AdaptiveSampler(space, seed=seed)
    plateau = plateau or PlateauStopper()
    start = time.time()
    trials: list[Trial] = []
    proposed = 0
    stop = False
    while proposed < total_samples and not stop:
        n = min(bracket_size, total_samples - proposed)
        configs = (
            [space.default_point()]
            if proposed == 0 and include_default_point
            else []
        )
        while len(configs) < n:
            configs.append(sampler.propose())
        proposed += len(configs)
        remaining = (
            None
            if time_budget_s is None
            else max(0.0, time_budget_s - (time.time() - start))
        )
        result = tune(
            evaluate,
            space=space,
            min_resource=min_resource,
            max_resource=max_resource,
            reduction_factor=reduction_factor,
            time_budget_s=remaining,
            metric_name=metric_name,
            seed=seed,
            log_path=log_path,
            configs=configs,
            first_trial_id=len(trials),
            executor=executor,
        )
        for trial in result.trials:
            sampler.observe(trial.config, trial.metric)
            metric = trial.metric if math.isfinite(trial.metric) else -math.inf
            if plateau.update(metric):
                stop = True
        trials.extend(result.trials)
        if time_budget_s is not None and time.time() - start > time_budget_s:
            break
    return TuneResult(trials=trials, metric_name=metric_name)


def warm_start_sampler(
    sampler: AdaptiveSampler, log_path: str | pathlib.Path
) -> int:
    """Feed a previous run's trials.jsonl into the sampler (transfer HPO).

    Equivalent of Ray Tune's `points_to_evaluate`/searcher restore and
    FLAML's warm-start: prior (config, metric) observations seed the
    elite set, so a new experiment proposes perturbations of known-good
    configs from trial 1 instead of re-paying the random startup phase.
    Returns the number of observations loaded.
    """
    loaded = 0
    with pathlib.Path(log_path).open() as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            metric = row.get("metric")
            if isinstance(metric, (int, float)) and math.isfinite(metric):
                sampler.observe(row["config"], float(metric))
                loaded += 1
    return loaded


def make_trainer_evaluator(
    base_model: dict[str, Any] | None = None,
    base_data: dict[str, Any] | None = None,
    base_trainer: dict[str, Any] | None = None,
    *,
    device: str = "cuda",
    devices: list[str] | None = None,
):
    """evaluate(config, resource) backed by the real Trainer on `device`
    (`devices`: a mesh, e.g. `["cpu"] * 2`)."""
    from xfmr_rec_torch.data.module import DataConfig, RecDataModule
    from xfmr_rec_torch.training.module import TrainConfig
    from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig

    def evaluate(config: dict[str, Any], resource: float) -> dict[str, float]:
        trainer = Trainer(
            TrainConfig(**{**(base_model or {}), **config}),
            data=RecDataModule(DataConfig(**(base_data or {}))),
            trainer_config=TrainerConfig(
                **{
                    **(base_trainer or {}),
                    "limit_train_batches": resource,
                }
            ),
            device=device,
            devices=devices,
        )
        return trainer.fit()

    return evaluate


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", default="data")
    parser.add_argument("--num_samples", type=int, default=16)
    parser.add_argument("--time_budget_s", type=float, default=3600.0)
    parser.add_argument("--log_path", default="runs/tune/trials.jsonl")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--random", action="store_true",
        help="use pure random sampling instead of the adaptive sampler",
    )
    parser.add_argument("--bracket_size", type=int, default=8)
    parser.add_argument("--plateau_patience", type=int, default=8)
    parser.add_argument(
        "--warm_start",
        help="trials.jsonl of a previous run to seed the adaptive sampler "
        "(transfer HPO; the default point is then skipped)",
    )
    parser.add_argument(
        "--model",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="fixed TrainConfig overrides applied to every trial (e.g. "
        "--model user_tower=history --model max_history=16); the search "
        "space still owns loss/negatives/sigma/margin/lr",
    )
    parser.add_argument(
        "--losses",
        help="comma-separated train-loss registry names to search instead "
        "of the reference FLAML set (adaptive sampler only)",
    )
    parser.add_argument(
        "--workers", type=int, default=1,
        help="concurrent trial workers, each a process pinned to a "
        "disjoint device subset (Ray Tune parity); 1 = in-process "
        "sequential loop",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the in-process trials (default cuda)",
    )
    parser.add_argument(
        "--worker_platform", default="cuda", choices=("cpu", "cuda"),
        help="device platform the trial workers pin to (default cuda)",
    )
    parser.add_argument(
        "--devices_per_worker", type=int, default=1,
        help="devices in each worker's subset (cpu: mesh slots on the "
        "CPU; cuda: cards per worker)",
    )
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)

    base_model: dict[str, Any] = {}
    for item in args.model:
        key, _, raw = item.partition("=")
        if not _:
            msg = f"--model expects KEY=VALUE, got {item!r}"
            raise SystemExit(msg)
        try:
            base_model[key] = json.loads(raw)
        except json.JSONDecodeError:
            base_model[key] = raw

    evaluate = make_trainer_evaluator(
        base_model=base_model,
        base_data={"data_dir": args.data_dir},
        base_trainer={"log_dir": "runs/tune"},
        device=args.device,
    )
    executor = None
    if args.workers > 1:
        from xfmr_rec_torch.tuning.executor import TrialExecutor

        executor = TrialExecutor(
            {
                "kind": "trainer",
                "base_model": base_model,
                "base_data": {"data_dir": args.data_dir},
                "base_trainer": {"log_dir": "runs/tune"},
            },
            workers=args.workers,
            platform=args.worker_platform,
            devices_per_worker=args.devices_per_worker,
        )
    if args.random:
        result = tune(
            evaluate,
            num_samples=args.num_samples,
            time_budget_s=args.time_budget_s,
            log_path=args.log_path,
            seed=args.seed,
            executor=executor,
        )
    else:
        losses = (
            tuple(args.losses.split(",")) if args.losses else TRAIN_LOSSES
        )
        from xfmr_rec_torch.ops.losses import LOSSES

        unknown = [name for name in losses if name not in LOSSES]
        if unknown:
            msg = f"unknown --losses names {unknown}; known: {sorted(LOSSES)}"
            raise SystemExit(msg)
        sampler = AdaptiveSampler(
            SearchSpace(train_losses=losses), seed=args.seed
        )
        warm = 0
        if args.warm_start:
            warm = warm_start_sampler(sampler, args.warm_start)
            logger.info(
                "warm start: %d observations from %s", warm, args.warm_start
            )
        result = tune_adaptive(
            evaluate,
            total_samples=args.num_samples,
            bracket_size=args.bracket_size,
            time_budget_s=args.time_budget_s,
            log_path=args.log_path,
            seed=args.seed,
            sampler=sampler,
            plateau=PlateauStopper(patience=args.plateau_patience),
            include_default_point=warm == 0,
            executor=executor,
        )
    if executor is not None:
        executor.shutdown()
    best = result.best_trial
    if not math.isfinite(best.metric):
        msg = (
            "every trial failed (no val metric produced) — see "
            f"{args.log_path} and the logs above"
        )
        raise SystemExit(msg)
    print(
        json.dumps(
            {"best_metric": best.metric, "best_config": best.config},
            indent=2,
        )
    )


if __name__ == "__main__":
    main()
