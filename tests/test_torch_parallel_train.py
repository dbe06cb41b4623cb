"""Port parity: the sharded train step, vocab sharding and the mesh trainer.

The reference's params go through the converter into the port's state;
the reference's sharded step runs on its 8 forced CPU devices, the
port's on a virtual mesh (`["cpu"] * 8`) and on a mesh of four distinct
CPU device slots (`cpu:0` ... `cpu:3`: one replica each, so the
gradient sum and the parameter copies run). Dropout is off (the two
packages' RNGs differ).

- The sharded step's loss equals the port's single-device step and the
  reference's sharded step within rtol 2e-4, for the text and the
  history tower; the parameters after the sharded steps equal the
  single-device ones (within 1e-6 on one replica, 5e-5 on four).
- `shard_vocab`: the loss and every gathered parameter equal the
  replicated step within rtol 1e-5, atol 1e-6 (atol 5e-5 across
  distinct replicas); each piece holds at most ceil(vocab / m) rows; no
  `state` raises.
- A `Trainer` fits on a CPU mesh and validates through `sharded_topk`.
"""

import math

import jax
import numpy as np
import pytest
import torch

from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.models import convert
from xfmr_rec_torch.parallel import create_mesh, make_sharded_train_step, shard_batch
from xfmr_rec_torch.parallel.train import (
    ShardedEmbed,
    gathered_state_dict,
    place_state,
)
from xfmr_rec_torch.training import module as port_module
from xfmr_rec_torch.training.trainer import Trainer as PortTrainer
from xfmr_rec_torch.training.trainer import TrainerConfig as PortTrainerConfig
from xfmr_rec_tpu.data import DataConfig, RecDataModule
from xfmr_rec_tpu.data.prepare import prepare_movielens
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.parallel import create_mesh as ref_create_mesh
from xfmr_rec_tpu.parallel import make_sharded_train_step as ref_sharded_step
from xfmr_rec_tpu.parallel import shard_batch as ref_shard_batch
from xfmr_rec_tpu.parallel.mesh import replicate as ref_replicate
from xfmr_rec_tpu.parallel.train import place_state as ref_place_state
from xfmr_rec_tpu.serving.portable import _flatten
from xfmr_rec_tpu.training import module as ref_module

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

TINY = dict(
    hidden_size=32,
    num_hidden_layers=1,
    num_attention_heads=4,
    intermediate_size=32,
    vocab_size=500,
    max_position_embeddings=32,
    max_length=16,
    dropout_rate=0.0,
    compute_dtype="float32",
    learning_rate=1e-3,
)
HISTORY = dict(
    user_tower="history",
    max_history=4,
    train_loss="InfomationNoiseContrastiveEstimationLoss",
    item_id_buckets=256,
    item_id_embedding="bloom",
    item_bias=True,
    max_bag=5,
)
TOWERS = {"text": {}, "history": HISTORY}
DATA = dict(batch_size=8, eval_batch_size=16, max_length=16, vocab_size=500)
CPU = torch.device("cpu")
VIRTUAL = ["cpu"] * 8
DISTINCT = [f"cpu:{i}" for i in range(4)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("paralleldata")
    generate_movielens(path, num_users=40, num_movies=120, num_ratings=1200,
                       seed=1)
    prepare_movielens(str(path), overwrite=True)
    return str(path)


def batches_of(data_dir, tower, count=2, batch_size=8):
    extra = dict(max_history=4, max_bag=5) if tower == "history" else {}
    data = dict(DATA, batch_size=batch_size)
    dm = RecDataModule(DataConfig(data_dir=data_dir, **data, **extra))
    dm.setup()
    return [b for _, b in zip(range(count), dm.train_batches(0))]


def port_state(ref_params, kw):
    config = port_module.TrainConfig(**kw)
    state = port_module.TrainState(config, device=CPU)
    flat = {k: np.asarray(v, np.float32) for k, v in _flatten(ref_params).items()}
    if config.user_tower == "history" or config.item_id_embedding != "none":
        state.model.load_state_dict(convert.two_tower_state_from_flat(flat, config))
    else:
        state.model.load_state_dict(convert.encoder_state_from_flat(flat, config))
    return state


def max_param_diff(a, b):
    sa, sb = gathered_state_dict(a.model), gathered_state_dict(b.model)
    assert list(sa) == list(sb)
    return max(float((sa[k] - sb[k]).abs().max()) for k in sa)


@pytest.mark.parametrize("tower", ["text", "history"])
@pytest.mark.parametrize("devices", ["virtual", "distinct"])
def test_sharded_step_matches_single_and_reference(data_dir, tower, devices):
    kw = dict(TINY, **TOWERS[tower])
    batches = batches_of(data_dir, tower)
    ref_config = ref_module.TrainConfig(**kw)
    _, ref_state = ref_module.create_train_state(ref_config, rng=0)
    ref_mesh = ref_create_mesh(8, model_parallel=2)
    ref_state = ref_replicate(ref_state, ref_mesh)
    ref_step = ref_sharded_step(ref_config, ref_mesh)

    single = port_state(ref_state.params, kw)
    sharded = port_state(ref_state.params, kw)
    mesh = create_mesh(
        model_parallel=2, devices=VIRTUAL if devices == "virtual" else DISTINCT
    )
    place_state(sharded, mesh, sharded.config)
    step = make_sharded_train_step(sharded.config, mesh)
    name = f"train/{kw.get('train_loss', 'PairwiseHingeLoss')}"
    for batch in batches:
        ref_state, want = ref_step(ref_state, ref_shard_batch(batch, ref_mesh))
        one = port_module.train_step(single, port_module.batch_to_device(batch, CPU))
        got = step(sharded, shard_batch(batch, mesh))
        assert got.keys() == one.keys()
        np.testing.assert_allclose(float(got[name]), float(one[name]), rtol=2e-4)
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=2e-4)
        assert math.isfinite(float(got["train/grad_norm"]))
    # one replica: the same pass, the same parameters; distinct
    # replicas: the gradient sum moves them as one device does, to f32
    # rounding that Adam's normalization can lift to the repo's 5e-5
    # parameter rule
    assert max_param_diff(sharded, single) <= (
        1e-6 if devices == "virtual" else 5e-5
    )
    assert sharded.step == single.step == len(batches)


@pytest.mark.parametrize("devices", ["virtual", "distinct"])
def test_shard_vocab_matches_replicated(data_dir, devices):
    kw = dict(TINY)
    batches = batches_of(data_dir, "text", batch_size=12)
    # 500 rows over 3 model devices: the last piece is zero-padded
    names = VIRTUAL[:6] if devices == "virtual" else [f"cpu:{i}" for i in range(6)]
    mesh = create_mesh(model_parallel=3, devices=names)
    _, ref_state = ref_module.create_train_state(ref_module.TrainConfig(**kw), rng=0)
    replicated = port_state(ref_state.params, kw)
    sharded = port_state(ref_state.params, kw)
    place_state(replicated, mesh, replicated.config)
    step_rep = make_sharded_train_step(replicated.config, mesh)
    step_sh = make_sharded_train_step(
        sharded.config, mesh, shard_vocab=True, state=sharded
    )
    table = sharded.model.word_embed
    assert isinstance(table, ShardedEmbed)
    assert len(table.pieces) == 3
    assert all(p.shape[0] <= -(-500 // 3) for p in table.pieces)
    assert [p.device.type for p in table.pieces] == ["cpu"] * 3
    for batch in batches:
        want = step_rep(replicated, shard_batch(batch, mesh))
        got = step_sh(sharded, shard_batch(batch, mesh))
        np.testing.assert_allclose(
            float(got["train/PairwiseHingeLoss"]),
            float(want["train/PairwiseHingeLoss"]),
            rtol=1e-5,
        )
    rep, sh = gathered_state_dict(replicated.model), gathered_state_dict(sharded.model)
    assert list(rep) == list(sh)
    # distinct replicas add their gradients in another order (the table's
    # pieces accumulate in the backward, the rest in `sum_to`), and Adam
    # lifts that rounding on near-zero gradients: the 5e-5 parameter rule
    atol = 1e-6 if devices == "virtual" else 5e-5
    for key in rep:
        np.testing.assert_allclose(
            sh[key].numpy(), rep[key].numpy(), rtol=1e-5, atol=atol, err_msg=key
        )
    # the table's AdamW moments live beside its pieces
    for piece in table.pieces:
        moments = sharded.optimizer.state[piece]
        assert moments["exp_avg"].shape == piece.shape


def test_shard_vocab_against_the_reference(data_dir):
    """The reference's vocab-sharded step (8 devices, model axis 4) and
    the port's on `["cpu"] * 8` give the same loss."""
    kw = dict(TINY)
    ref_config = ref_module.TrainConfig(**kw)
    batch = batches_of(data_dir, "text", 1)[0]
    ref_mesh = ref_create_mesh(8, model_parallel=4)
    _, ref_state = ref_module.create_train_state(ref_config, rng=0)
    state = port_state(ref_state.params, kw)
    ref_state = ref_place_state(ref_state, ref_mesh, ref_config, shard_vocab=True)
    ref_step = ref_sharded_step(
        ref_config, ref_mesh, shard_vocab=True, state=ref_state
    )
    _, want = ref_step(ref_state, ref_shard_batch(batch, ref_mesh))
    mesh = create_mesh(model_parallel=4, devices=VIRTUAL)
    step = make_sharded_train_step(state.config, mesh, shard_vocab=True, state=state)
    got = step(state, shard_batch(batch, mesh))
    np.testing.assert_allclose(
        float(got["train/PairwiseHingeLoss"]),
        float(want["train/PairwiseHingeLoss"]),
        rtol=2e-4,
    )


def test_shard_vocab_requires_state():
    mesh = create_mesh(model_parallel=2, devices=VIRTUAL)
    with pytest.raises(ValueError, match="state"):
        make_sharded_train_step(port_module.TrainConfig(**TINY), mesh, shard_vocab=True)


def mesh_trainer(data_dir, tmp_path, devices=None, data=None, **trainer):
    return PortTrainer(
        port_module.TrainConfig(**TINY, index_dtype="float32"),
        data=PortDataModule(
            PortDataConfig(data_dir=data_dir, **{**DATA, **(data or {})})
        ),
        trainer_config=PortTrainerConfig(
            log_dir=str(tmp_path), run_name="r", max_steps=3,
            limit_val_batches=2, checkpointing=False, **trainer,
        ),
        device="cpu",
        devices=devices,
    )


def test_trainer_fits_on_a_cpu_mesh(data_dir, tmp_path):
    """`mesh=True, model_parallel=2` on four virtual devices: the steps
    are the single-device steps, and the validation through
    `sharded_topk` over the split f32 corpus (120 items: no shard pad,
    so the single-device dense search finds the same lists) gives the
    same metrics."""
    single = mesh_trainer(data_dir, tmp_path / "one")
    want = single.fit()
    trainer = mesh_trainer(
        data_dir, tmp_path / "mesh", devices=["cpu"] * 4, mesh=True,
        model_parallel=2,
    )
    got = trainer.fit()
    assert trainer.mesh.shape == {"data": 2, "model": 2}
    assert trainer._sharded_corpus is not None
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    assert max_param_diff(trainer.state, single.state) <= 1e-6


def test_trainer_shard_vocab_saves_the_gathered_table(data_dir, tmp_path):
    """shard_vocab on a (1, 3) mesh of distinct device slots; the
    validation searches the corpus split in three (its shard-balancing
    rows excluded); the artifact holds the whole table and serves in the
    engine."""
    from xfmr_rec_torch.serving.engine import RecommenderEngine
    from xfmr_rec_torch.serving.schemas import Query

    trainer = mesh_trainer(
        data_dir, tmp_path, devices=[f"cpu:{i}" for i in range(3)],
        data=dict(batch_size=9), shard_vocab=True, model_parallel=3,
    )
    metrics = trainer.fit()
    assert trainer._sharded_corpus.shape[0] % 3 == 0
    assert all(math.isfinite(v) for v in metrics.values())
    trainer.save(tmp_path / "art")
    engine = RecommenderEngine(tmp_path / "art", warmup=False, device="cpu")
    table = trainer.state.model.word_embed.full()
    torch.testing.assert_close(engine.encoder.word_embed.embedding, table)
    assert len(engine.search_items(Query(text="toy story"), top_k=5)) == 5


@pytest.mark.parametrize(
    "devices,trainer,match",
    [
        (["cpu"] * 3, dict(), "divisible by the mesh size"),
        (["cpu"] * 3, dict(model_parallel=2), "not divisible by model_parallel"),
        (None, dict(mesh=True, model_parallel=2), "not divisible by model_parallel"),
    ],
    ids=["batch", "model-axis", "one-device"],
)
def test_mesh_misconfigurations_raise(data_dir, tmp_path, devices, trainer, match):
    with pytest.raises(ValueError, match=match):
        mesh_trainer(data_dir, tmp_path, devices=devices, **trainer).setup()


def test_sharded_eval_fills_like_the_single_device(data_dir, tmp_path):
    """Exclusions leave fewer than top_k items: the sharded eval's -inf
    slots hold the lowest excluded positions, as the single-device eval
    does; the clip of pad positions (the reference's) changes nothing
    then, since the shard-balancing rows sit last."""
    trainer = mesh_trainer(
        data_dir, tmp_path, devices=["cpu"] * 7, data=dict(batch_size=14),
        model_parallel=7,
    )
    trainer.setup()
    trainer.build_index()
    n = trainer.data.num_items
    assert trainer._sharded_corpus_pad == -n % 7 > 0
    users = torch.from_numpy(
        np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    )
    excl = np.full((4, n), n, np.int32)
    for row in range(4):
        keep = {row, n - 1 - row}
        excl[row, : n - 2] = [p for p in range(n) if p not in keep]
    batch = {"exclude_positions": excl}
    top_k = 6
    _, sharded = trainer._search(users, batch, top_k)
    _, single = trainer.index.search(users, top_k=top_k, exclude_positions=excl)
    np.testing.assert_array_equal(sharded, single)


def test_place_state_splits_a_trained_tables_moments(data_dir):
    """Placing a state that has already stepped: the table's AdamW
    moments split with it, so the next sharded step is the step the
    replicated state takes."""
    kw = dict(TINY)
    first, second = batches_of(data_dir, "text", batch_size=12)
    mesh = create_mesh(model_parallel=3, devices=VIRTUAL[:3])
    states = [port_module.TrainState(port_module.TrainConfig(**kw), device=CPU)
              for _ in range(2)]
    for state in states:
        port_module.train_step(state, port_module.batch_to_device(first, CPU))
    replicated, sharded = states
    table = sharded.model.word_embed.embedding
    moments = dict(sharded.optimizer.state[table])
    place_state(sharded, mesh, sharded.config, shard_vocab=True)
    pieces = list(sharded.model.word_embed.pieces)
    for key in ("exp_avg", "exp_avg_sq"):
        joined = torch.cat([sharded.optimizer.state[p][key] for p in pieces])
        torch.testing.assert_close(joined[:500], moments[key], rtol=0, atol=0)
        assert not joined[500:].any()
    step = make_sharded_train_step(sharded.config, mesh, shard_vocab=True,
                                   state=sharded)
    step(sharded, shard_batch(second, mesh))
    port_module.train_step(replicated, port_module.batch_to_device(second, CPU))
    assert max_param_diff(sharded, replicated) <= 1e-6
