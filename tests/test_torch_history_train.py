"""Port parity: training and serving the history user tower.

- Three train steps of a two-tower config (history tower, Bloom item
  ids, popularity bias, CF bag) from the reference's init, at f32 and
  bf16, under `test_torch_train_step.py`'s tolerances: losses and
  grad_norm within 1e-4 relative + 1e-5 absolute at f32 and 3e-2 + 1e-2
  at bf16; parameters within 5e-5 (largest) at f32 and 1e-4 (mean) at
  bf16, with some parameter moved by more than 10x that mean. The `_cut`
  case pads the texts to 32, and the port's `batch_to_device` cuts every
  text field, the history's too, to the 16 columns they fill.
- The port's `fit` from the reference's init (f32, dropout off, history
  tower + item bias + CF channel) against the reference `Trainer.fit` on
  the same data: retrieval metrics within 1e-6, held-out losses within
  1e-4 relative.
- A JAX-trained two-tower artifact (f32 compute, with `cf_rank`), its
  `users.parquet` converted to `users.npz`, served by both engines:
  `recommend_with_user_id` and `recommend_with_user` (a request history,
  an unknown movie id in it) answer the same ids, scores within 4e-3
  (one bf16 step of a unit score, 2^-8, is 3.9e-3). At bf16 compute the
  two packages round the user vector differently (scores part by about
  1.5e-3 here), which swaps items closer than that, so ids are held at
  f32.
- A port-trained artifact (bf16 compute) served by the port's engine:
  its user vectors equal the trainer's own eval user vectors. The
  trainer gathers history rows from its f32 corpus and the engine from
  `corpus.npz` (f32 from the stored bf16); the fusion casts both to
  bf16 first, so they agree bit for bit; answers equal the trainer's
  search.
- The JAX artifact after the same `add_items` on both engines: the index
  keeps its width (text, bias, CF factors and popularity, zero for the
  new items), and a user whose request history names an added item gets
  the same answer from both.
"""

import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.models import convert
from xfmr_rec_torch.models.encoder import run_width
from xfmr_rec_torch.serving.engine import RecommenderEngine as PortEngine
from xfmr_rec_torch.serving.schemas import ItemQuery, UserQuery
from xfmr_rec_torch.serving.service import RecService, dispatch
from xfmr_rec_torch.serving.users import UserStore
from xfmr_rec_torch.training import module as port_module
from xfmr_rec_torch.training.trainer import Trainer as PortTrainer
from xfmr_rec_torch.training.trainer import TrainerConfig as PortTrainerConfig
from xfmr_rec_tpu.data import DataConfig, RecDataModule
from xfmr_rec_tpu.data.prepare import prepare_movielens
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.serving.engine import RecommenderEngine as RefEngine
from xfmr_rec_tpu.serving.portable import _flatten
from xfmr_rec_tpu.serving.schemas import ItemQuery as RefItemQuery
from xfmr_rec_tpu.serving.service import RecService as RefService
from xfmr_rec_tpu.training import module as ref_module
from xfmr_rec_tpu.training.trainer import Trainer, TrainerConfig

TINY = dict(
    hidden_size=32,
    num_hidden_layers=1,
    num_attention_heads=4,
    intermediate_size=32,
    vocab_size=500,
    max_position_embeddings=32,
    max_length=16,
    dropout_rate=0.0,
    user_tower="history",
    max_history=4,
    train_loss="InfomationNoiseContrastiveEstimationLoss",
    item_id_buckets=256,
)
CHANNELS = dict(item_id_embedding="bloom", item_bias=True, max_bag=5)
DATA = dict(batch_size=8, eval_batch_size=16, max_length=16, vocab_size=500)
CPU = "cpu"
LR = 1e-3


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("histtrain")
    generate_movielens(path, num_users=40, num_movies=120, num_ratings=1200,
                       seed=1)
    prepare_movielens(str(path), overwrite=True)
    return str(path)


def port_load(state_model, ref_params, config):
    state_model.load_state_dict(convert.two_tower_state_from_flat(
        {k: np.asarray(v, np.float32) for k, v in _flatten(ref_params).items()},
        config,
    ))


TOLERANCES = {
    "float32": ((1e-4, 1e-5), 5e-5, 5e-5),
    "bfloat16": ((3e-2, 1e-2), 6 * LR, 1e-4),
}


def check_three_steps(data_dir, compute_dtype, max_length):
    loss_tol, max_tol, mean_tol = TOLERANCES[compute_dtype]
    kw = dict(TINY, **CHANNELS, compute_dtype=compute_dtype,
              learning_rate=LR, max_length=max_length)
    dm = RecDataModule(DataConfig(data_dir=data_dir, max_history=4,
                                  max_bag=5, **{**DATA,
                                                "max_length": max_length}))
    dm.setup()
    batches = [b for _, b in zip(range(3), dm.train_batches(0))]
    texts = [k for k in batches[0] if k.endswith("_tokens")]
    assert "hist_tokens" in texts
    for batch in batches:
        assert run_width([batch[k] for k in texts], "mean") == 16
    ref_config = ref_module.TrainConfig(**kw)
    _, ref_state = ref_module.create_train_state(ref_config, rng=0)
    step = jax.jit(ref_module.make_train_step(ref_config))
    state = port_module.TrainState(port_module.TrainConfig(**kw), device=CPU)
    port_load(state.model, ref_state.params, state.config)
    initial = convert.flat_from_encoder_state(state.model.state_dict())
    for batch in batches:
        ref_state, want = step(ref_state, batch)
        got = port_module.train_step(
            state,
            port_module.batch_to_device(
                batch, torch.device(CPU), state.config.pooling_mode
            ),
        )
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(
                float(got[key]), float(want[key]), rtol=loss_tol[0],
                atol=loss_tol[1], err_msg=key,
            )
    got = convert.flat_from_encoder_state(state.model.state_dict())
    want = {k: np.asarray(v) for k, v in _flatten(ref_state.params).items()}
    assert got.keys() == want.keys()
    diff = np.concatenate([np.abs(got[n] - want[n]).ravel() for n in want])
    assert diff.max() <= max_tol
    assert diff.mean() <= mean_tol
    moved = np.concatenate([np.abs(got[n] - initial[n]).ravel()
                            for n in got])
    assert moved.max() > 10 * mean_tol


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_three_steps_match_jax(data_dir, compute_dtype):
    check_three_steps(data_dir, compute_dtype, max_length=16)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_three_steps_match_jax_cut(data_dir, compute_dtype):
    check_three_steps(data_dir, compute_dtype, max_length=32)


def test_fit_matches_jax_trainer(data_dir, tmp_path):
    model_kw = dict(TINY, item_bias=True, cf_rank=8, compute_dtype="float32",
                    learning_rate=LR)
    trainer_kw = dict(max_steps=6, checkpointing=False,
                      limit_val_loss_batches=2, run_name="r")
    ref = Trainer(
        ref_module.TrainConfig(**model_kw),
        data=RecDataModule(DataConfig(data_dir=data_dir, **DATA)),
        trainer_config=TrainerConfig(log_dir=str(tmp_path / "ref"),
                                     mesh=False, **trainer_kw),
    )
    ref.setup()
    port = PortTrainer(
        port_module.TrainConfig(**model_kw),
        data=PortDataModule(PortDataConfig(data_dir=data_dir, **DATA)),
        trainer_config=PortTrainerConfig(log_dir=str(tmp_path / "port"),
                                         **trainer_kw),
        device=CPU,
    )
    port.setup()
    assert port.data.config.max_history == 4
    np.testing.assert_array_equal(port.cf.item_factors, ref.cf.item_factors)
    port_load(port.state.model, ref.state.params, port.config)
    want = ref.fit()
    got = port.fit()
    assert got.keys() == want.keys()
    for key in want:
        if "/Retrieval" in key:
            assert abs(got[key] - want[key]) <= 1e-6, key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-5, err_msg=key)
    users = np.arange(6)
    np.testing.assert_allclose(
        port.eval_user_embeddings(users).numpy(),
        np.asarray(ref.eval_user_embeddings(users)), atol=1e-5,
    )


@pytest.fixture(scope="module")
def jax_artifact(data_dir, tmp_path_factory):
    trainer = Trainer(
        ref_module.TrainConfig(**TINY, **CHANNELS, cf_rank=8,
                               compute_dtype="float32"),
        data=RecDataModule(DataConfig(data_dir=data_dir, **DATA)),
        trainer_config=TrainerConfig(
            max_steps=4, checkpointing=False, mesh=False,
            limit_val_batches=1, limit_val_loss_batches=1,
            log_dir=str(tmp_path_factory.mktemp("jaxruns")),
        ),
    )
    trainer.fit()
    path = tmp_path_factory.mktemp("jaxart") / "model"
    trainer.save(path)
    UserStore.from_rows(
        pd.read_parquet(path / "users.parquet").to_dict("records")
    ).save(path / "users.npz")
    return path


def ref_user_answer(ref, user, top_k):
    """What the reference's parts give for a user: its engine's user
    tower, searched with the history and target excluded."""
    seen = [a.movie_id for a in (user.history or []) + (user.target or [])]
    return ref.engine.search_items(ref.engine.embed_user_query(user),
                                   exclude_item_ids=seen, top_k=top_k)


def assert_same_answers(got, want):
    assert [c["movie_id"] for c in got] == [c.movie_id for c in want]
    np.testing.assert_allclose([c["score"] for c in got],
                               [c.score for c in want], atol=4e-3)


def test_jax_artifact_serves_users_in_both_engines(jax_artifact):
    ref = RefService(RefEngine(jax_artifact))
    port = RecService(PortEngine(jax_artifact, device=CPU, warmup=False))
    assert port.engine.cf is not None and port.engine.index.dim == 32 + 1 + 9
    user_ids = [int(u) for u in port.engine.users.arrays["user_id"][:8]]
    for user_id in user_ids:
        want = ref_user_answer(ref, ref.engine.get_user(user_id), 10)
        got = dispatch(port, "recommend_with_user_id",
                       {"user_id": user_id, "top_k": 10})
        assert_same_answers(got, want)
    user_id = user_ids[3]
    assert dispatch(port, "user_id", {"user_id": user_id}) == json.loads(
        ref.user_id(user_id).model_dump_json())
    # a request history: three known items and one unknown movie id
    ref_user = ref.engine.get_user(user_id)
    history = [*ref_user.history[:3], ref_user.history[0].model_copy(
        update={"movie_id": 10**7, "datetime": 10**12})]
    ref_user = ref_user.model_copy(update={
        "user_id": 0, "user_rn": 0, "target": None, "history": history})
    body = {"user": json.loads(ref_user.model_dump_json()), "top_k": 10}
    assert_same_answers(dispatch(port, "recommend_with_user", body),
                        ref_user_answer(ref, ref_user, 10))
    assert dispatch(port, "process_user", body)["text"] == ref_user.user_text


def test_reference_service_drops_the_fused_vector(jax_artifact):
    """The reference fault the port does not copy (ROADMAP.md, Queue 3):
    the reference's `recommend_with_user` hands the fused user vector to
    `recommend_with_query`, which embeds the profile text again, so the
    history never reaches the search. The port searches the fused
    vector."""
    ref = RefService(RefEngine(jax_artifact))
    port = RecService(PortEngine(jax_artifact, device=CPU, warmup=False))
    user_id = int(port.engine.users.arrays["user_id"][1])
    user = ref.engine.get_user(user_id)
    seen = [a.movie_id for a in user.history + user.target]
    text_only = ref.engine.search_items(
        ref.engine.embed_query(ref.engine.process_user(user)),
        exclude_item_ids=seen, top_k=10)
    served = ref.recommend_with_user_id(user_id, top_k=10)
    assert [c.movie_id for c in served] == [c.movie_id for c in text_only]
    fused = ref_user_answer(ref, user, 10)
    assert [c.movie_id for c in fused] != [c.movie_id for c in text_only]
    assert_same_answers(
        dispatch(port, "recommend_with_user_id",
                 {"user_id": user_id, "top_k": 10}), fused)


def test_port_artifact_serves_the_trainers_answers(data_dir, tmp_path):
    trainer = PortTrainer(
        port_module.TrainConfig(**TINY, **CHANNELS, cf_rank=8,
                                compute_dtype="bfloat16"),
        data=PortDataModule(PortDataConfig(data_dir=data_dir, **DATA)),
        trainer_config=PortTrainerConfig(
            max_steps=4, checkpointing=False, limit_val_batches=1,
            limit_val_loss_batches=1, log_dir=str(tmp_path), run_name="r"),
        device=CPU,
    )
    trainer.fit()
    trainer.save(tmp_path / "art")
    engine = PortEngine(tmp_path / "art", device=CPU, warmup=False)
    service = RecService(engine)
    for upos in (0, 5, 17):
        user_id = int(trainer.data.user_ids[upos])
        want_vec = trainer.eval_user_embeddings(np.array([upos]))
        got_vec = engine.embed_user_query(engine.get_user(user_id)).embedding
        torch.testing.assert_close(torch.tensor([got_vec]), want_vec,
                                   rtol=0, atol=0)
        seen = trainer.data.train_history_item_ids(upos)
        user = engine.get_user(user_id)
        seen += [a.movie_id for a in user.target or []]
        _, want = trainer.index.search(want_vec, top_k=10,
                                       exclude_ids=[seen])
        got = service.recommend_with_user_id(user_id, top_k=10)
        assert [c.movie_id for c in got] == want[0].tolist()
    assert isinstance(engine.get_user(user_id), UserQuery)


def test_added_items_serve_users_in_both_engines(jax_artifact):
    ref = RefService(RefEngine(jax_artifact, warmup=False))
    port = RecService(PortEngine(jax_artifact, device=CPU, warmup=False),
                      allow_catalog_mutation=True)
    width = port.engine.index.dim
    items = [dict(movie_rn=9001 + i, movie_id=999001 + i,
                  movie_text=f'{{"title": "New {i} (2030)", '
                             f'"genres": ["Drama"]}}') for i in range(3)]
    assert ref.engine.add_items([RefItemQuery(**i) for i in items]) == 3
    out = dispatch(port, "add_items", {"items": items})
    assert out == {"added": 3, "num_items": len(ref.engine.index)}
    engine = port.engine
    assert engine.index.dim == width == 32 + 1 + 9
    # new items: zero CF factors and zero popularity
    assert not engine.index.corpus[-3:, 33:].float().any()
    assert engine._hist_corpus.shape == (len(engine.index), 32)
    np.testing.assert_allclose(
        engine._hist_corpus[-3:].numpy(),
        np.asarray(ref.engine._hist_corpus)[-3:], atol=1e-5)
    user_id = int(engine.users.arrays["user_id"][2])
    ref_user = ref.engine.get_user(user_id)
    history = [*ref_user.history[:2], ref_user.history[0].model_copy(
        update={"movie_id": 999002, "movie_rn": 9002, "datetime": 10**12})]
    ref_user = ref_user.model_copy(update={
        "user_id": 0, "user_rn": 0, "target": None, "history": history})
    body = {"user": json.loads(ref_user.model_dump_json()), "top_k": 10}
    got = dispatch(port, "recommend_with_user", body)
    assert_same_answers(got, ref_user_answer(ref, ref_user, 10))
    assert not {999002} & {c["movie_id"] for c in got}
    for user_id in [int(u) for u in engine.users.arrays["user_id"][:4]]:
        assert_same_answers(
            dispatch(port, "recommend_with_user_id",
                     {"user_id": user_id, "top_k": 10}),
            ref_user_answer(ref, ref.engine.get_user(user_id), 10))
    assert isinstance(engine.get_item(999001), ItemQuery)
