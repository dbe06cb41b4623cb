"""Port parity: `Trainer.predict` and the CLI's `predict`.

The port's trainer, loaded with the reference trainer's initial
parameters (f32, dropout off), predicts the full `is_predict` cohort
with each user's train history excluded. Against the reference's
predictions frame (parquet columns) on the same data: the same user
ids in the same order, the same item ids, scores within 2^-8: the index
holds bf16 rows and searches with the query rounded to bf16, so user
vectors that agree to f32 rounding can round one component to the next
bf16 value (a relative step of 2^-8; seen: 5e-5). For the text tower and
the history tower.
The CLI writes `predictions.npz` (by default under the run's log dir).
"""

import json

import numpy as np
import pytest

from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.models import convert
from xfmr_rec_torch.models.encoder import needs_two_tower
from xfmr_rec_torch.training import cli as port_cli
from xfmr_rec_torch.training.module import TrainConfig as PortTrainConfig
from xfmr_rec_torch.training.trainer import Trainer as PortTrainer
from xfmr_rec_torch.training.trainer import TrainerConfig as PortTrainerConfig
from xfmr_rec_tpu.data import DataConfig, RecDataModule
from xfmr_rec_tpu.data.prepare import prepare_movielens
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.serving.portable import _flatten
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
    dropout_rate=0.0,
)
TINY_DATA = dict(batch_size=8, eval_batch_size=16, max_length=16,
                 vocab_size=500)
CPU = "cpu"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("predictdata")
    generate_movielens(
        path, num_users=40, num_movies=120, num_ratings=1200, seed=3
    )
    prepare_movielens(str(path), overwrite=True)
    return str(path)


@pytest.mark.parametrize("tower", [{}, {"user_tower": "history",
                                        "max_history": 4}])
def test_predict_matches_jax_trainer(data_dir, tmp_path, tower):
    model_kw = dict(TINY_MODEL, **tower)
    trainer_kw = dict(checkpointing=False, run_name="r")
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
    load = (convert.two_tower_state_from_flat
            if needs_two_tower(port.config)
            else convert.encoder_state_from_flat)
    port.state.model.load_state_dict(load(flat, port.config))
    want = ref.predict(tmp_path / "ref.parquet")
    got = port.predict(tmp_path / "port.npz")
    assert len(got["user_id"]) == len(want) > 0
    np.testing.assert_array_equal(got["user_id"], want["user_id"].to_numpy())
    np.testing.assert_array_equal(
        got["rec_item_ids"], np.stack(want["rec_item_ids"].to_numpy()))
    np.testing.assert_allclose(
        got["rec_scores"], np.stack(want["rec_scores"].to_numpy()),
        atol=2.0**-8)
    assert got["user_id"].dtype == np.int64
    assert got["rec_scores"].dtype == np.float32
    assert got["rec_item_ids"].shape == (len(want), port.config.top_k)
    with np.load(tmp_path / "port.npz") as saved:
        assert sorted(saved.files) == ["rec_item_ids", "rec_scores",
                                       "user_id"]
        for key, value in got.items():
            np.testing.assert_array_equal(saved[key], value)
    # every row excludes the user's train history
    pos_of = {int(i): p for p, i in enumerate(port.data.item_ids)}
    upos_of = {int(u): p for p, u in enumerate(port.data.user_ids)}
    for user, rec in zip(got["user_id"], got["rec_item_ids"], strict=True):
        seen = set(port.data._train_items_by_user.get(upos_of[int(user)], []))
        assert not seen & {pos_of[int(i)] for i in rec}


def test_cli_predict_writes_npz(data_dir, tmp_path):
    config = {
        "model": TINY_MODEL,
        "data": dict(TINY_DATA, data_dir=data_dir),
        "trainer": {"log_dir": str(tmp_path / "runs"), "run_name": "r",
                    "checkpointing": False},
    }
    path = tmp_path / "run.json"
    path.write_text(json.dumps(config))
    trainer, metrics = port_cli.run(["predict", "--config", str(path),
                                     "--device", CPU])
    assert metrics is None
    default = tmp_path / "runs" / "r" / "predictions.npz"
    with np.load(default) as saved:
        users = saved["user_id"]
        assert len(users) == int(trainer.data.user_subsets["is_predict"].sum())
    out = tmp_path / "elsewhere" / "p.npz"
    port_cli.run(["predict", "--config", str(path), "--device", CPU,
                  "--output", str(out)])
    with np.load(out) as saved:
        np.testing.assert_array_equal(saved["user_id"], users)
