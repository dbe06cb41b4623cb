"""Port parity: the trainer, its checkpoints, its artifact and its CLI.

- A tiny `fit` on the CPU: a few steps and a validation, finite logged
  losses, metrics in [0, 1], checkpoints written.
- The port's `fit` from the reference's init (f32, dropout off) against
  the reference `Trainer.fit` on the same data: the retrieval metrics
  within 1e-6 (the same top-k lists; seen: 7e-9) and the held-out losses
  within 1e-4 relative (seen: 4e-6).
- The long run: both trainers 252 steps (4 epochs) from one init: the
  retrieval metrics equal, the held-out losses within 1e-4 relative,
  every parameter within 5e-5 but the attention key biases, whose only
  gradient is rounding (held to 1e-2, the walk shown between two port
  runs one ulp apart).
- Save, restore and resume: the step after a restore is the step the
  saved run takes next, dropout masks included, bit for bit.
- The artifact loads in the port's engine (answers equal the trainer's
  own index search) and in the reference's NumPy `PortableEncoder`
  (embeddings within 1e-5).
- One JSON config drives `fit` in both CLIs, and `--print_config`
  agrees.
- Every refused config raises (a mesh that cannot hold the config among them).
"""

import dataclasses
import io
import json
import math

import numpy as np
import pytest
import torch
import yaml

from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.models import convert
from xfmr_rec_torch.serving.engine import RecommenderEngine as PortEngine
from xfmr_rec_torch.serving.schemas import Query
from xfmr_rec_torch.training import cli as port_cli
from xfmr_rec_torch.training.module import TrainConfig as PortTrainConfig
from xfmr_rec_torch.training.trainer import Trainer as PortTrainer
from xfmr_rec_torch.training.trainer import TrainerConfig as PortTrainerConfig
from xfmr_rec_tpu.data import DataConfig, RecDataModule
from xfmr_rec_tpu.data.prepare import prepare_movielens
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.serving.portable import PortableEncoder, _flatten
from xfmr_rec_tpu.training import cli as ref_cli
from xfmr_rec_tpu.training.module import TrainConfig
from xfmr_rec_tpu.training.trainer import Trainer, TrainerConfig

TINY_MODEL = dict(
    hidden_size=32,
    num_hidden_layers=1,
    num_attention_heads=4,
    intermediate_size=32,
    vocab_size=500,
    max_position_embeddings=32,
    max_length=16,
    compute_dtype="float32",
)
TINY_DATA = dict(batch_size=8, eval_batch_size=16, max_length=16,
                 vocab_size=500)
CPU = "cpu"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("trainerdata")
    generate_movielens(
        path, num_users=40, num_movies=120, num_ratings=1200, seed=1
    )
    prepare_movielens(str(path), overwrite=True)
    return str(path)


def port_trainer(data_dir, log_dir, model=None, trainer=None, data=None):
    return PortTrainer(
        PortTrainConfig(**{**TINY_MODEL, **(model or {})}),
        data=PortDataModule(PortDataConfig(data_dir=data_dir,
                                           **{**TINY_DATA, **(data or {})})),
        trainer_config=PortTrainerConfig(
            log_dir=str(log_dir), run_name="r", **(trainer or {})
        ),
        device=CPU,
    )


def test_fit_end_to_end_cpu(data_dir, tmp_path):
    trainer = port_trainer(
        data_dir, tmp_path,
        trainer=dict(max_steps=6, log_every_steps=2, val_check_interval=0.05),
    )
    trainer.setup()
    initial = {
        k: v.clone() for k, v in trainer.state.model.state_dict().items()
    }
    metrics = trainer.fit()
    assert trainer.global_step == 6
    assert trainer.index.method == "dense"
    retrieval = {k: v for k, v in metrics.items() if "/Retrieval" in k}
    assert len(retrieval) == 6
    assert all(0.0 <= v <= 1.0 for v in retrieval.values())
    rows = [json.loads(line) for line in
            (tmp_path / "r" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/grad_norm" in r]
    assert [r["step"] for r in train_rows] == [2, 4, 6]
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert (tmp_path / "r" / "ckpt" / "best").exists()
    assert (tmp_path / "r" / "ckpt" / "last").exists()
    moved = max(
        (v - initial[k]).abs().max().item()
        for k, v in trainer.state.model.state_dict().items()
    )
    assert moved > 0


def test_fit_matches_jax_trainer(data_dir, tmp_path):
    trainer_kw = dict(max_steps=8, checkpointing=False,
                      limit_val_loss_batches=2, run_name="r")
    model_kw = dict(TINY_MODEL, dropout_rate=0.0, learning_rate=1e-3)
    ref = Trainer(
        TrainConfig(**model_kw),
        data=RecDataModule(DataConfig(data_dir=data_dir, **TINY_DATA)),
        trainer_config=TrainerConfig(log_dir=str(tmp_path / "ref"),
                                     mesh=False, **trainer_kw),
    )
    ref.setup()
    port = PortTrainer(
        PortTrainConfig(**model_kw),
        data=PortDataModule(PortDataConfig(data_dir=data_dir, **TINY_DATA)),
        trainer_config=PortTrainerConfig(log_dir=str(tmp_path / "port"),
                                         **trainer_kw),
        device=CPU,
    )
    port.setup()
    flat = {k: np.asarray(v, np.float32)
            for k, v in _flatten(ref.state.params).items()}
    port.state.model.load_state_dict(
        convert.encoder_state_from_flat(flat, port.config)
    )
    want = ref.fit()
    got = port.fit()
    assert got.keys() == want.keys()
    for key in want:
        if "/Retrieval" in key:
            assert abs(got[key] - want[key]) <= 1e-6, key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-5, err_msg=key)


# the long run: both trainers for LONG_EPOCHS epochs of batch 8 (252
# steps) from one init (dropout off, f32, a cosine schedule after 20
# warm-up steps), a validation after each epoch. CPU readings: every
# retrieval metric equal, the held-out losses within 4.1e-6 relative,
# every parameter but the attention key biases within 5.3e-6. A key bias
# has no gradient but rounding (softmax cancels the constant it adds to
# a query's scores), and Adam turns that noise into steps of about the
# learning rate: 1.44e-3 from the reference, and 1.11e-3 between two
# port runs whose initial parameters differ by one ulp. So the biases
# are held to LONG_NOISE_TOL and the rounding walk is shown in the port
# alone; everything else to the repo's 5e-5.
LONG_EPOCHS = 4
LONG_METRIC_TOL = 1e-6
LONG_LOSS_RTOL = 1e-4
LONG_PARAM_TOL = 5e-5
LONG_NOISE_TOL = 1e-2
NOISE_ONLY = ".key.bias"


def long_trainer(data_dir, log_dir, init: dict) -> PortTrainer:
    trainer = PortTrainer(
        PortTrainConfig(**LONG_MODEL),
        data=PortDataModule(PortDataConfig(data_dir=data_dir, **TINY_DATA)),
        trainer_config=PortTrainerConfig(log_dir=str(log_dir), **LONG_TRAINER),
        device=CPU,
    )
    trainer.setup()
    trainer.state.model.load_state_dict(init)
    return trainer


LONG_TRAINER = dict(max_epochs=LONG_EPOCHS, val_check_interval=1.0,
                    checkpointing=False, limit_val_loss_batches=4,
                    log_every_steps=1000, run_name="r")
LONG_MODEL = dict(TINY_MODEL, dropout_rate=0.0, learning_rate=1e-3,
                  lr_schedule="cosine", warmup_steps=20)


def drifts(ours: dict, theirs: dict) -> tuple[float, float]:
    """(the largest difference over the key biases, over the rest)."""
    gaps = {k: (ours[k] - v).abs().max().item() for k, v in theirs.items()}
    noise = [g for k, g in gaps.items() if k.endswith(NOISE_ONLY)]
    return max(noise), max(g for k, g in gaps.items() if not k.endswith(NOISE_ONLY))


def test_long_fit_stays_with_the_jax_trainer(data_dir, tmp_path):
    """Hundreds of steps, so that a drift which 8 steps cannot show (an
    update, a schedule or a data order that differs a little each step)
    accumulates past f32 reordering."""
    ref = Trainer(
        TrainConfig(**LONG_MODEL),
        data=RecDataModule(DataConfig(data_dir=data_dir, **TINY_DATA)),
        trainer_config=TrainerConfig(log_dir=str(tmp_path / "ref"),
                                     mesh=False, **LONG_TRAINER),
    )
    ref.setup()

    def port_state(params) -> dict:
        flat = {k: np.asarray(v, np.float32) for k, v in _flatten(params).items()}
        return convert.encoder_state_from_flat(flat, PortTrainConfig(**LONG_MODEL))

    init = port_state(ref.state.params)
    port = long_trainer(data_dir, tmp_path / "port", init)
    want = ref.fit()
    got = port.fit()
    assert ref.global_step == port.global_step >= 200
    assert got.keys() == want.keys()
    for key in want:
        if "/Retrieval" in key:
            assert abs(got[key] - want[key]) <= LONG_METRIC_TOL, key
        else:
            np.testing.assert_allclose(got[key], want[key],
                                       rtol=LONG_LOSS_RTOL, err_msg=key)
    ours = port.state.model.state_dict()
    noise, rest = drifts(ours, port_state(ref.state.params))
    assert rest <= LONG_PARAM_TOL
    assert noise <= LONG_NOISE_TOL
    # the same walk between two port runs one ulp apart at the start
    nudged = long_trainer(data_dir, tmp_path / "nudged", {
        k: torch.nextafter(v, torch.tensor(np.inf)) for k, v in init.items()
    })
    nudged.fit()
    noise_port, rest_port = drifts(ours, nudged.state.model.state_dict())
    assert LONG_NOISE_TOL >= noise_port > 10 * rest_port

def test_checkpoint_resume_replays_dropout(data_dir, tmp_path):
    model = dict(dropout_rate=0.2)
    first = port_trainer(data_dir, tmp_path / "a", model=model)
    first.setup()
    batches = list(zip(range(4), first.data.train_batches(0)))
    for _, batch in batches[:3]:
        first.train_step(batch)
    first.best_metric = 0.25
    ckpt = tmp_path / "ckpt" / "mid"
    first.save_checkpoint(str(ckpt))
    want = first.train_step(batches[3][1])
    second = port_trainer(data_dir, tmp_path / "b", model=model)
    second.restore_checkpoint(str(ckpt))
    assert second.global_step == 3 and second.best_metric == 0.25
    got = second.train_step(batches[3][1])
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for name, value in first.state.model.state_dict().items():
        assert torch.equal(second.state.model.state_dict()[name], value)
    # without the generator's state the masks (and so the step) differ
    third = port_trainer(data_dir, tmp_path / "c", model=model)
    third.restore_checkpoint(str(ckpt))
    third.state.generator.manual_seed(12345)
    assert not torch.equal(
        third.train_step(batches[3][1])["train/PairwiseHingeLoss"],
        want["train/PairwiseHingeLoss"],
    )


@pytest.mark.parametrize("tokenizer", ["hashing", "vocab"])
def test_artifact_serves_in_both_packages(data_dir, tmp_path, tokenizer):
    trainer = port_trainer(
        data_dir, tmp_path,
        trainer=dict(max_steps=3, checkpointing=False),
        data=dict(tokenizer=tokenizer, oov_buckets=50),
    )
    trainer.fit()
    path = tmp_path / "artifact"
    trainer.save(path)
    assert json.loads((path / "processors.json").read_text()).keys() == {
        "model", "data", "step", "best_metric"
    }
    assert (path / "encoder.msgpack").exists()
    assert (path / "users.npz").exists()
    assert not (path / "users.parquet").exists()
    assert (path / "vocab.json").exists() == (tokenizer == "vocab")
    engine = PortEngine(path, device=CPU, warmup=False)
    texts = trainer.data.item_texts[:5]
    np.testing.assert_allclose(
        engine.embed(texts), trainer.embed_texts(texts).numpy(),
        rtol=0, atol=1e-6,
    )
    for pos in (0, 7, 33):
        item_id = int(trainer.data.item_ids[pos])
        text = trainer.data.item_texts[pos]
        got = engine.search_items(Query(text=text),
                                  exclude_item_ids=[item_id], top_k=10)
        _, want = trainer.index.search(
            trainer.embed_texts([text]), top_k=10, exclude_ids=[[item_id]]
        )
        assert [c.movie_id for c in got] == want[0].tolist()
    portable = PortableEncoder.load(path)
    tokens = trainer.data.tokenizer.encode_batch(texts)
    np.testing.assert_allclose(
        portable.encode(tokens), engine.embed(texts), rtol=0, atol=1e-5
    )


def test_one_json_config_drives_both_clis(data_dir, tmp_path, capsys):
    config = {
        "model": TINY_MODEL,
        "data": dict(TINY_DATA, data_dir=data_dir),
        "trainer": dict(max_steps=3, checkpointing=False, mesh=False,
                        limit_val_loss_batches=1, log_dir=str(tmp_path),
                        run_name="cli"),
    }
    path = tmp_path / "run.json"
    path.write_text(json.dumps(config))
    argv = ["fit", "--config", str(path), "--model.learning_rate", "0.002",
            "--trainer.limit_train_batches", "0.5"]
    ref_cli.main([*argv, "--print_config"])
    want = yaml.safe_load(io.StringIO(capsys.readouterr().out))
    port_cli.main([*argv, "--print_config"])
    got = json.loads(capsys.readouterr().out)
    assert got == want
    assert got["model"]["learning_rate"] == 0.002
    ref_metrics = ref_cli.main(argv)
    port_metrics = port_cli.main([*argv, "--device", CPU])
    assert port_metrics.keys() == ref_metrics.keys()
    assert all(0.0 <= v <= 1.0 for k, v in port_metrics.items()
               if "/Retrieval" in k)


def test_cli_resume_and_test(data_dir, tmp_path):
    config = tmp_path / "run.json"
    config.write_text(json.dumps({
        "model": TINY_MODEL,
        "data": dict(TINY_DATA, data_dir=data_dir),
        "trainer": dict(max_steps=2, log_dir=str(tmp_path), run_name="c"),
    }))
    port_cli.main(["fit", "--config", str(config), "--device", CPU,
                   "--save_artifact", str(tmp_path / "art")])
    assert (tmp_path / "art" / "encoder.npz").exists()
    trainer, metrics = port_cli.run(
        ["test", "--config", str(config), "--device", CPU,
         "--ckpt", str(tmp_path / "c" / "ckpt" / "last")]
    )
    assert trainer.global_step == 2
    assert all(key.startswith("test/") for key in metrics)


@pytest.mark.parametrize(
    "model",
    [
        dict(user_tower="history"),
        dict(item_bias=True),
        dict(item_id_embedding="bloom"),
        dict(cf_rank=4),
    ],
)
def test_two_tower_and_cf_configs_accepted(tmp_path, model):
    trainer = PortTrainer(
        PortTrainConfig(**model),
        data=PortDataConfig(data_dir=str(tmp_path)),
        trainer_config=PortTrainerConfig(log_dir=str(tmp_path)),
        device=CPU,
    )
    assert trainer.config.cf_rank == model.get("cf_rank", 0)


@pytest.mark.parametrize(
    "model,trainer,match",
    [
        pytest.param({}, dict(mesh=True, devices=[CPU] * 3),
                     "divisible by the mesh size",
                     id="model1-trainer1-multi-device"),
        pytest.param({}, dict(model_parallel=2, devices=[CPU] * 3),
                     "not divisible by model_parallel",
                     id="model2-trainer2-multi-device"),
        pytest.param({}, dict(shard_vocab=True, devices=[CPU] * 3),
                     "divisible by the mesh size",
                     id="model3-trainer3-multi-device"),
    ],
)
def test_refused_configs_raise(tmp_path, model, trainer, match):
    """Multi-device training is accepted (tests/test_torch_parallel_train.py
    trains each of these on a CPU mesh); a mesh that cannot hold the
    config raises the reference's error: a batch of 32 over three
    devices, a model axis of 2 over three."""
    trainer = dict(trainer)
    devices = trainer.pop("devices")
    with pytest.raises(ValueError, match=match):
        PortTrainer(
            PortTrainConfig(**model),
            data=PortDataConfig(data_dir=str(tmp_path)),
            trainer_config=PortTrainerConfig(log_dir=str(tmp_path), **trainer),
            device=CPU,
            devices=devices,
        )


@pytest.mark.parametrize(
    "model,trainer",
    [(dict(remat=True), {}), ({}, dict(profile_dir="prof"))],
    ids=["remat", "profile_dir"],
)
def test_remat_and_profile_dir_accepted(tmp_path, model, trainer):
    """Both build; `remat` is held in test_torch_remat.py,
    `profile_dir` in test_torch_profiling.py."""
    built = PortTrainer(
        PortTrainConfig(**model),
        data=PortDataConfig(data_dir=str(tmp_path)),
        trainer_config=PortTrainerConfig(log_dir=str(tmp_path), **trainer),
        device=CPU,
    )
    assert built.config.remat == model.get("remat", False)


def test_refused_data_and_predict(tmp_path):
    """History fields in the data section build; unknown options are
    refused (`predict` is held in test_torch_predict.py)."""
    trainer = port_cli.build_trainer(
        {**port_cli.default_config(),
         "data": dataclasses.asdict(PortDataConfig(max_history=8)),
         "trainer": dataclasses.asdict(
             PortTrainerConfig(log_dir=str(tmp_path)))},
        device=CPU,
    )
    assert trainer.data.config.max_history == 8
    with pytest.raises(SystemExit, match="unknown option"):
        port_cli.run(["fit", "--model.no_such_field", "1"])
