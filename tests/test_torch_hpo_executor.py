"""Parallel trial execution of the port (`xfmr_rec_torch/tuning/executor.py`).

Counterparts of `tests/test_hpo_executor.py`: worker processes, each
pinned to a disjoint device subset by `CUDA_VISIBLE_DEVICES`, evaluate
one successive-halving rung concurrently. On the `"cpu"` platform the
executor gives the sequential loop's results bit for bit, failing and
dying trials are failed data points, the worker sees no card, and the
trainer spec runs the real `Trainer` on the CPU in two workers. The
`"cuda"` platform's environments are disjoint card sets, and the worker
count clamps to the cards present (`torch.cuda.device_count`
monkeypatched). The evaluators live in `tests/torch_hpo_evals.py`, which
imports no JAX: every worker imports it.
"""

import math

import pytest
import torch

from xfmr_rec_torch.tuning import (
    SearchSpace,
    TrialExecutor,
    tune,
    worker_device_env,
)

EVALS = "tests.torch_hpo_evals"


def spec(name):
    return {"kind": "import", "path": f"{EVALS}:{name}"}


class TestWorkerDeviceEnv:
    def test_cpu_env(self):
        env = worker_device_env(1, 4, platform="cpu", devices_per_worker=2)
        assert env == {"CUDA_VISIBLE_DEVICES": ""}

    def test_cuda_subsets_are_disjoint(self):
        seen = set()
        for wid in range(4):
            env = worker_device_env(
                wid, 4, platform="cuda", devices_per_worker=2
            )
            cards = set(env["CUDA_VISIBLE_DEVICES"].split(","))
            assert len(cards) == 2
            assert not cards & seen
            seen |= cards
        assert seen == {str(c) for c in range(8)}

    @pytest.mark.parametrize("cards,per_worker,want", [
        (1, 1, 1), (4, 1, 4), (4, 2, 2), (4, 3, 1), (0, 1, 1),
    ])
    def test_cuda_workers_clamp_to_present_cards(
            self, monkeypatch, cards, per_worker, want):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        ex = TrialExecutor(spec("eval_deterministic"), workers=5,
                           platform="cuda", devices_per_worker=per_worker)
        try:
            assert ex.workers == want
            assert len(ex._pools) == want
        finally:
            ex.shutdown()

    def test_default_platform_is_the_card(self, monkeypatch):
        """With no platform given, a trainer spec runs on cuda and the
        workers clamp to the cards present, like `platform="cuda"`."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert worker_device_env(0, 1) == {"CUDA_VISIBLE_DEVICES": "0"}
        ex = TrialExecutor({"kind": "trainer"}, workers=2)
        try:
            assert ex.spec["device"] == "cuda"
            assert ex.workers == 1
            assert ex._envs == [{"CUDA_VISIBLE_DEVICES": "0"}]
        finally:
            ex.shutdown()

    def test_unknown_platform_raises(self):
        with pytest.raises(ValueError, match="tpu"):
            worker_device_env(0, 1, platform="tpu")
        with pytest.raises(ValueError, match="tpu"):
            TrialExecutor(spec("eval_deterministic"), platform="tpu")


class TestExecutorMatchesSequential:
    def test_same_trials_same_winner(self):
        """Fixed seed: the executor reproduces the sequential loop."""
        from tests.torch_hpo_evals import eval_deterministic

        kw = dict(num_samples=6, min_resource=0.25, max_resource=1.0,
                  reduction_factor=2, seed=7)
        seq = tune(eval_deterministic, **kw)
        with TrialExecutor(spec("eval_deterministic"), workers=2,
                           platform="cpu") as ex:
            par = tune(None, executor=ex, **kw)
        assert [(t.trial_id, t.resource, t.config, t.metric, t.metrics)
                for t in seq.trials] == [
            (t.trial_id, t.resource, t.config, t.metric, t.metrics)
            for t in par.trials]
        assert seq.best_trial.config == par.best_trial.config

    @pytest.mark.parametrize("name", ["eval_flaky", "eval_dying"])
    def test_failed_trials_are_data_points(self, name):
        """A trial that raises, or kills its worker, comes back with
        empty metrics; the rest of the rung and the next rung run."""
        from tests.torch_hpo_evals import eval_flaky

        kw = dict(num_samples=6, min_resource=0.5, max_resource=1.0, seed=0)
        with TrialExecutor(spec(name), workers=2, platform="cpu") as ex:
            result = tune(None, executor=ex, **kw)
        failed = [t for t in result.trials if not t.metrics]
        ok = [t for t in result.trials if t.metrics]
        assert failed and ok
        assert all(t.metric == -math.inf for t in failed)
        assert math.isfinite(result.best_trial.metric)
        seq = tune(eval_flaky, **kw)
        assert [(t.trial_id, t.config, t.metric) for t in seq.trials] == [
            (t.trial_id, t.config, t.metric) for t in result.trials]


class TestExecutorConcurrency:
    def test_trials_overlap_across_processes(self):
        """One rung of 2 sleepy trials on 2 workers: the windows overlap
        and two distinct worker pids ran them."""
        with TrialExecutor(spec("eval_sleepy"), workers=2,
                           platform="cpu") as ex:
            result = tune(
                None, executor=ex, space=SearchSpace(), num_samples=2,
                min_resource=1.0, max_resource=1.0, seed=1,
            )
        (a, b) = [(t.metrics["t_start"], t.metrics["t_end"])
                  for t in result.trials]
        assert a[0] < b[1] and b[0] < a[1], f"no concurrent trials: {a} {b}"
        pids = {t.metrics["pid"] for t in result.trials}
        assert len(pids) == 2, f"all trials ran in one process: {pids}"


class TestTrainerSpecEndToEnd:
    def test_real_trainer_in_cpu_pinned_workers(self, tmp_path):
        """2 CPU workers run the real Trainer on a synthetic corpus (one
        as a mesh of 2 CPU slots); both trials return a finite val
        metric, and each worker saw no card."""
        from xfmr_rec_torch.data.module import DataConfig, RecDataModule

        data_dir = str(tmp_path / "data")
        trainer_spec = {
            "kind": "trainer",
            "base_model": {
                "hidden_size": 16, "num_hidden_layers": 1,
                "num_attention_heads": 2, "intermediate_size": 16,
                "max_length": 16, "vocab_size": 512,
            },
            "base_data": {
                "data_dir": data_dir, "synthetic_users": 30,
                "synthetic_movies": 40, "synthetic_ratings": 400,
                "max_length": 16, "vocab_size": 512, "batch_size": 8,
            },
            "base_trainer": {
                "log_dir": str(tmp_path / "runs"), "max_epochs": 1,
                "limit_val_batches": 2, "limit_val_loss_batches": 1,
                "checkpointing": False,
            },
        }
        # the corpus is prepared once in the parent, so the workers do
        # not each wait on the data directory's lock
        RecDataModule(DataConfig(**trainer_spec["base_data"])).prepare_data()
        for slots in (1, 2):
            with TrialExecutor(trainer_spec, workers=2, platform="cpu",
                               devices_per_worker=slots) as ex:
                assert ex.spec["device"] == "cpu"
                result = tune(
                    None, executor=ex, num_samples=2,
                    min_resource=0.25, max_resource=0.25, seed=0,
                )
            assert len(result.trials) == 2
            for t in result.trials:
                assert math.isfinite(t.metric) and 0 <= t.metric <= 1, t.metrics
                assert t.seconds > 0
        with TrialExecutor(spec("eval_device_probe"), workers=1,
                           platform="cpu") as ex:
            (probe,) = ex.run([(0, {}, 1.0)])
        assert probe.metrics["cuda_visible_devices"] == ""
        assert probe.metrics["device_count"] == 0
        assert probe.worker_pid == probe.metrics["pid"]
