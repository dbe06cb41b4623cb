"""Port parity: hyperparameter search (`xfmr_rec_torch/tuning/hpo.py`).

The port's search space, samplers, plateau stopper and tuning loops against
the JAX package's (`xfmr_rec_tpu/tuning/hpo.py`): from one seed and the
same observations, `SearchSpace.sample`, `AdaptiveSampler.propose` and
`TPESampler.propose` give dict-equal configs with bit-equal floats, and
`tune` / `tune_adaptive` with a deterministic evaluator give the same
trial list (ids, configs, resources, metrics) and winner. Then the
counterparts of `tests/test_hpo.py` run on the port, and one real
trial through `make_trainer_evaluator(device="cpu")` equals
`Trainer(...).fit()` of the same merged config.
"""

import json
import math
import time

import numpy as np
import pytest

from xfmr_rec_torch.tuning import hpo as port
from xfmr_rec_torch.tuning import (
    AdaptiveSampler,
    PlateauStopper,
    SearchSpace,
    TPESampler,
    tune,
    tune_adaptive,
)
from xfmr_rec_torch.tuning.hpo import make_trainer_evaluator, warm_start_sampler
from xfmr_rec_tpu.tuning import hpo as ref

METRIC = "val/RetrievalNormalizedDCG"


def _objective(config, resource):
    """Smooth peak at lr=1e-3, sigma=10, margin=0.5, PairwiseHingeLoss."""
    score = 1.0
    score *= 1.0 / (1.0 + abs(np.log10(config["learning_rate"]) + 3))
    score *= 1.0 / (1.0 + abs(np.log10(config["sigma"]) - 1))
    score *= 1.0 / (1.0 + abs(config["margin"] - 0.5))
    if config["train_loss"] != "PairwiseHingeLoss":
        score *= 0.5
    return {METRIC: score * resource}


def log_rows(path):
    """A JSONL trial log without its wall-clock seconds."""
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for row in rows:
        assert row.pop("seconds") >= 0
    return rows


def trial_rows(result):
    return [(t.trial_id, t.config, t.resource, t.metric, t.metrics)
            for t in result.trials]


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
def test_metric_and_losses_equal_reference():
    assert port.METRIC == ref.METRIC
    assert port.TRAIN_LOSSES == ref.TRAIN_LOSSES
    assert port.SearchSpace() == port.SearchSpace(**vars(ref.SearchSpace()))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_samples_equal_reference(seed):
    def draw(mod):
        space = mod.SearchSpace()
        rng = np.random.default_rng(seed)
        return [space.default_point()] + [space.sample(rng) for _ in range(40)]

    got, want = draw(port), draw(ref)
    assert got == want
    assert [type(v) for c in got for v in c.values()] == [
        type(v) for c in want for v in c.values()]


def proposals(mod, sampler, seed, n_obs, n_prop, **kw):
    """`n_prop` proposals of `sampler` after `n_obs` seeded observations,
    each proposal observed with the smooth objective."""
    space = mod.SearchSpace()
    s = getattr(mod, sampler)(space, seed=seed, **kw)
    rng = np.random.default_rng(seed + 100)
    for _ in range(n_obs):
        s.observe(space.sample(rng), float(rng.random()))
    out = []
    for _ in range(n_prop):
        cfg = s.propose()
        s.observe(cfg, _objective(cfg, 1.0)[METRIC])
        out.append(cfg)
    return out


@pytest.mark.parametrize("sampler,kw", [
    ("AdaptiveSampler", {}),
    ("AdaptiveSampler", {"n_startup": 2, "explore": 0.0, "scale": 2.0}),
    ("TPESampler", {}),
    ("TPESampler", {"n_startup": 2, "gamma": 0.5, "n_candidates": 8}),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_sampler_proposals_equal_reference(sampler, kw, seed):
    for n_obs in (0, 12):
        got = proposals(port, sampler, seed, n_obs, 24, **kw)
        want = proposals(ref, sampler, seed, n_obs, 24, **kw)
        assert got == want


def test_plateau_stopper_equals_reference():
    rng = np.random.default_rng(2)
    metrics = list(rng.random(30) * np.linspace(1, 1.2, 30))
    a, b = port.PlateauStopper(patience=4), ref.PlateauStopper(patience=4)
    assert [a.update(m) for m in metrics] == [b.update(m) for m in metrics]
    assert (a.best, a.stale) == (b.best, b.stale)


@pytest.mark.parametrize("kw", [
    dict(num_samples=8, min_resource=0.25, max_resource=1.0,
         reduction_factor=2, seed=1),
    dict(num_samples=9, min_resource=1 / 16, reduction_factor=3, seed=4,
         include_default_point=False),
])
def test_tune_equals_reference(kw):
    got, want = port.tune(_objective, **kw), ref.tune(_objective, **kw)
    assert trial_rows(got) == trial_rows(want)
    assert got.best_trial.trial_id == want.best_trial.trial_id
    assert got.best_config == want.best_config


@pytest.mark.parametrize("sampler", ["AdaptiveSampler", "TPESampler"])
def test_tune_adaptive_equals_reference(sampler, tmp_path):
    def run(mod, name):
        space = mod.SearchSpace()
        return mod.tune_adaptive(
            _objective, space=space, total_samples=16, bracket_size=4,
            min_resource=0.25, seed=5, log_path=tmp_path / name,
            sampler=getattr(mod, sampler)(space, seed=5, n_startup=4),
            plateau=mod.PlateauStopper(patience=6),
        )

    got, want = run(port, "port.jsonl"), run(ref, "ref.jsonl")
    assert trial_rows(got) == trial_rows(want)
    assert got.best_config == want.best_config
    assert log_rows(tmp_path / "port.jsonl") == log_rows(tmp_path / "ref.jsonl")


def test_failing_trials_equal_reference():
    def evaluate(config, resource):
        if config["learning_rate"] > 1e-3:
            raise RuntimeError("boom")
        return _objective(config, resource)

    kw = dict(num_samples=8, min_resource=0.5, seed=2)
    got, want = port.tune(evaluate, **kw), ref.tune(evaluate, **kw)
    assert trial_rows(got) == trial_rows(want)
    assert any(t.metric == -math.inf for t in got.trials)


def test_warm_start_equals_reference(tmp_path):
    log = tmp_path / "trials.jsonl"
    port.tune(_objective, num_samples=8, min_resource=0.5, seed=3,
              log_path=log)

    def warmed(mod):
        sampler = mod.AdaptiveSampler(mod.SearchSpace(), seed=9)
        loaded = mod.warm_start_sampler(sampler, log)
        return loaded, sampler.observations, [sampler.propose()
                                              for _ in range(8)]

    assert warmed(port) == warmed(ref)


# ---------------------------------------------------------------------------
# the counterparts of tests/test_hpo.py, on the port
# ---------------------------------------------------------------------------
class TestSearchSpace:
    def test_samples_in_bounds(self):
        space = SearchSpace()
        rng = np.random.default_rng(0)
        for _ in range(50):
            cfg = space.sample(rng)
            assert cfg["train_loss"] in space.train_losses
            assert cfg["num_negatives"] in {1, 2, 4, 8, 16, 32, 64}
            assert 1.0 <= cfg["sigma"] <= 1000.0
            assert -1.0 <= cfg["margin"] <= 1.0
            assert 1e-4 <= cfg["learning_rate"] <= 1e-2
            assert abs(cfg["margin"] * 100 - round(cfg["margin"] * 100)) < 1e-6

    def test_default_point_is_reference(self):
        point = SearchSpace().default_point()
        assert point["train_loss"] == "PairwiseHingeLoss"
        assert point["num_negatives"] == 1


class TestSuccessiveHalving:
    def test_promotes_best_config(self):
        calls = []

        def evaluate(config, resource):
            calls.append((config["learning_rate"], resource))
            quality = 1.0 / (1 + abs(np.log10(config["learning_rate"]) + 3))
            return {METRIC: quality * resource}

        result = tune(
            evaluate, num_samples=8, min_resource=0.25, max_resource=1.0,
            reduction_factor=2, seed=1,
        )
        assert sorted({r for _, r in calls}) == [0.25, 0.5, 1.0]
        assert sum(1 for _, r in calls if r == 0.25) == 8
        assert sum(1 for _, r in calls if r == 0.5) == 4
        assert sum(1 for _, r in calls if r == 1.0) == 2
        full = [t for t in result.trials if t.resource == 1.0]
        assert result.best_trial.metric == max(t.metric for t in full)

    def test_failed_trials_dont_crash(self):
        def evaluate(config, resource):
            if config["train_loss"] == "PairwiseLogisticLoss":
                raise RuntimeError("boom")
            return {METRIC: resource}

        result = tune(evaluate, num_samples=6, min_resource=0.5, seed=2)
        assert len(result.trials) > 0
        assert np.isfinite(result.best_trial.metric)

    def test_time_budget_stops(self):
        def evaluate(config, resource):
            time.sleep(0.05)
            return {METRIC: 0.5}

        result = tune(
            evaluate, num_samples=100, min_resource=0.25,
            time_budget_s=0.3, seed=3,
        )
        assert len(result.trials) < 100

    def test_trial_log_written(self, tmp_path):
        def evaluate(config, resource):
            return {METRIC: resource}

        log = tmp_path / "trials.jsonl"
        result = tune(evaluate, num_samples=4, min_resource=1.0, log_path=log)
        rows = [json.loads(line) for line in log.read_text().splitlines()]
        assert len(rows) == 4
        assert [(r["trial_id"], r["config"], r["metric"]) for r in rows] == [
            (t.trial_id, t.config, t.metric) for t in result.trials]

    def test_explicit_configs_bypass_sampling(self):
        seen = []

        def evaluate(config, resource):
            seen.append(config["learning_rate"])
            return {METRIC: 0.1}

        cfgs = [
            {**SearchSpace().default_point(), "learning_rate": lr}
            for lr in (1e-4, 2e-4, 3e-4)
        ]
        result = tune(
            evaluate, configs=cfgs, min_resource=1.0, max_resource=1.0,
        )
        assert sorted(seen) == [1e-4, 2e-4, 3e-4]
        assert len(result.trials) == 3


class TestAdaptiveSampler:
    def test_proposals_stay_in_bounds(self):
        space = SearchSpace()
        sampler = AdaptiveSampler(space, seed=0, n_startup=4)
        rng = np.random.default_rng(1)
        for _ in range(10):
            sampler.observe(space.sample(rng), float(rng.random()))
        for _ in range(100):
            cfg = sampler.propose()
            assert cfg["train_loss"] in space.train_losses
            assert cfg["num_negatives"] in {1, 2, 4, 8, 16, 32, 64}
            assert 1.0 <= cfg["sigma"] <= 1000.0
            assert -1.0 <= cfg["margin"] <= 1.0
            assert abs(cfg["margin"] * 100 - round(cfg["margin"] * 100)) < 1e-6
            assert 1e-4 <= cfg["learning_rate"] <= 1e-2

    def test_nonfinite_observations_ignored(self):
        sampler = AdaptiveSampler(SearchSpace(), seed=0)
        sampler.observe(SearchSpace().default_point(), -np.inf)
        assert sampler.observations == []

    def test_beats_random_on_smooth_objective(self):
        def best_of(kind, seed, n=48):
            space = SearchSpace()
            rng = np.random.default_rng(seed)
            sampler = AdaptiveSampler(space, seed=seed, n_startup=8)
            best = -np.inf
            for _ in range(n):
                cfg = (sampler.propose() if kind == "adaptive"
                       else space.sample(rng))
                metric = _objective(cfg, 1.0)[METRIC]
                sampler.observe(cfg, metric)
                best = max(best, metric)
            return best

        adaptive = np.mean([best_of("adaptive", s) for s in range(5)])
        random = np.mean([best_of("random", s) for s in range(5)])
        assert adaptive > random


class TestPlateauStopper:
    def test_stops_after_patience(self):
        stopper = PlateauStopper(patience=3, min_delta=0.01)
        assert not stopper.update(0.5)
        assert not stopper.update(0.505)
        assert not stopper.update(0.5)
        assert stopper.update(0.49)
        assert stopper.stopped

    def test_improvement_resets(self):
        stopper = PlateauStopper(patience=2, min_delta=0.0)
        stopper.update(0.1)
        stopper.update(0.05)
        assert not stopper.update(0.2)
        assert not stopper.update(0.1)
        assert stopper.update(0.1)


def tiny_corpus(root):
    from xfmr_rec_torch.data.prepare import prepare_movielens
    from xfmr_rec_torch.data.synthetic import generate_movielens

    generate_movielens(root, num_users=25, num_movies=60, num_ratings=500,
                       seed=4)
    prepare_movielens(root, overwrite=True)


TINY_MODEL = dict(
    hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
    intermediate_size=32, vocab_size=300, max_position_embeddings=32,
    max_length=8, compute_dtype="float32",
)


class TestTuneAdaptive:
    def test_plateau_stops_experiment(self):
        def evaluate(config, resource):
            return {METRIC: 0.5}

        result = tune_adaptive(
            evaluate, total_samples=64, bracket_size=4,
            min_resource=1.0, max_resource=1.0,
            plateau=PlateauStopper(patience=5), seed=0,
        )
        assert len(result.trials) < 20

    def test_reaches_optimum_with_fewer_trials_than_random(self):
        random_result = tune(
            _objective, num_samples=24, min_resource=1.0,
            max_resource=1.0, seed=7,
        )
        target = random_result.best_trial.metric
        adaptive_result = tune_adaptive(
            _objective, total_samples=24, bracket_size=6,
            min_resource=1.0, max_resource=1.0, seed=7,
            plateau=PlateauStopper(patience=100),
        )
        metrics = [t.metric for t in adaptive_result.trials]
        reached = next((i for i, m in enumerate(metrics) if m >= target), None)
        assert reached is not None
        assert reached + 1 <= len(random_result.trials)

    def test_bracket_resources_follow_sha(self):
        calls = []

        def evaluate(config, resource):
            calls.append(resource)
            return _objective(config, resource)

        tune_adaptive(
            evaluate, total_samples=8, bracket_size=4,
            min_resource=0.25, max_resource=1.0, reduction_factor=2,
            seed=1, plateau=PlateauStopper(patience=100),
        )
        assert sorted(set(calls)) == [0.25, 0.5, 1.0]

    def test_warm_start_proposes_near_prior_elite(self, tmp_path):
        space = SearchSpace()
        elite = {
            "train_loss": "PairwiseHingeLoss",
            "num_negatives": 8,
            "sigma": 7.9,
            "margin": 0.73,
            "learning_rate": 7e-4,
        }
        log = tmp_path / "trials.jsonl"
        rows = [{"config": elite, "metric": 0.05}]
        rng = np.random.default_rng(0)
        for _ in range(15):
            rows.append({"config": space.sample(rng), "metric": 0.01})
        rows.append({"config": space.sample(rng), "metric": None})
        log.write_text("".join(json.dumps(r) + "\n" for r in rows))
        sampler = AdaptiveSampler(space, seed=3, explore=0.0, elite_frac=0.01)
        assert warm_start_sampler(sampler, log) == 16
        for _ in range(8):
            prop = sampler.propose()
            assert abs(np.log(prop["learning_rate"] / 7e-4)) < 2.5
            assert prop["num_negatives"] in (4, 8, 16)

    def test_real_trainer_smoke(self, tmp_path):
        """One real trial through make_trainer_evaluator on the CPU, equal
        to `Trainer(...).fit()` of the same merged config."""
        from xfmr_rec_torch.data.module import DataConfig, RecDataModule
        from xfmr_rec_torch.training.module import TrainConfig
        from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig

        tiny_corpus(tmp_path)
        base_data = dict(data_dir=str(tmp_path), batch_size=8,
                         vocab_size=300, max_length=8)
        base_trainer = dict(log_dir=str(tmp_path / "runs"),
                            limit_val_batches=1, max_steps=2,
                            checkpointing=False)
        evaluate = make_trainer_evaluator(
            base_model=TINY_MODEL, base_data=base_data,
            base_trainer=base_trainer, device="cpu",
        )
        result = tune(
            evaluate, num_samples=2, min_resource=1.0, max_resource=1.0,
            seed=5,
        )
        assert len(result.trials) == 2
        assert result.best_trial.metric > -np.inf
        config = result.trials[1].config
        want = Trainer(
            TrainConfig(**{**TINY_MODEL, **config}),
            data=RecDataModule(DataConfig(**base_data)),
            trainer_config=TrainerConfig(
                **{**base_trainer, "limit_train_batches": 1.0}),
            device="cpu",
        ).fit()
        assert result.trials[1].metrics == want
        assert 0.0 <= want[METRIC] <= 1.0


class TestTPESampler:
    def test_startup_is_random_then_model_based(self):
        space = SearchSpace()
        sampler = TPESampler(space, seed=0, n_startup=4)
        rng = np.random.default_rng(0)
        for _ in range(4):
            sampler.observe(sampler.propose(), float(rng.random()))
        for _ in range(6):
            cfg = sampler.propose()
            sampler.observe(cfg, float(rng.random()))
            assert cfg["train_loss"] in space.train_losses
            assert 1 <= cfg["num_negatives"] <= 2 ** space.log_num_negatives[1]
            assert space.sigma[0] <= cfg["sigma"] <= space.sigma[1]
            assert space.margin[0] <= cfg["margin"] <= space.margin[1]
            lr_lo, lr_hi = space.learning_rate
            assert lr_lo <= cfg["learning_rate"] <= lr_hi

    def test_seeded_determinism(self):
        def run(seed):
            sampler = TPESampler(SearchSpace(), seed=seed, n_startup=3)
            out = []
            for i in range(8):
                cfg = sampler.propose()
                sampler.observe(cfg, float(i % 3))
                out.append(cfg)
            return out

        assert run(7) == run(7)
        assert run(7) != run(8)

    def test_concentrates_on_good_region(self):
        space = SearchSpace()
        sampler = TPESampler(space, seed=1, n_startup=4, n_candidates=32)
        rng = np.random.default_rng(1)
        for _ in range(40):
            cfg = space.sample(rng)
            good = (cfg["train_loss"] == "AlignmentContrastiveLoss"
                    and cfg["learning_rate"] > 1e-3)
            sampler.observe(cfg, 1.0 if good else 0.0)
        hits = sum(sampler.propose()["train_loss"] == "AlignmentContrastiveLoss"
                   for _ in range(20))
        assert hits >= 12

    def test_composes_with_tune_adaptive(self, tmp_path):
        space = SearchSpace()

        def evaluate(cfg, resource):
            val = 1.0 - abs(np.log10(cfg["learning_rate"]) + 3.0)
            return {METRIC: val * resource}

        result = tune_adaptive(
            evaluate, space=space, total_samples=8, bracket_size=4,
            sampler=TPESampler(space, seed=0, n_startup=2),
            log_path=tmp_path / "trials.jsonl",
        )
        assert len(result.trials) >= 8
        assert np.isfinite(result.best_trial.metric)

    def test_warm_start_feeds_tpe(self, tmp_path):
        space = SearchSpace()
        rows = [
            {"config": space.sample(np.random.default_rng(i)), "metric": i}
            for i in range(5)
        ]
        path = tmp_path / "prev.jsonl"
        path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
        sampler = TPESampler(space, seed=0)
        assert warm_start_sampler(sampler, path) == 5
        assert len(sampler.observations) == 5


def test_main_tunes_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`python -m xfmr_rec_torch.tuning.hpo --device cpu --random`: one
    successive-halving bracket of real trainer trials on a synthetic
    corpus, the best config printed as JSON and the trial log written."""
    tiny_corpus(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    log = tmp_path / "trials.jsonl"
    monkeypatch.setattr("sys.argv", [
        "hpo", "--data_dir", str(tmp_path / "data"), "--num_samples", "2",
        "--random", "--device", "cpu", "--log_path", str(log),
        "--model", "hidden_size=16", "--model", "num_attention_heads=2",
        "--model", "intermediate_size=16",
    ])
    port.main()
    out = json.loads(capsys.readouterr().out)
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert out["best_metric"] == max(r["metric"] for r in rows)
    assert out["best_config"] in [r["config"] for r in rows]
    assert [r["resource"] for r in rows][:2] == [1 / 16, 1 / 16]
    assert (tmp_path / "runs" / "tune").is_dir()
