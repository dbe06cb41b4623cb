"""The train step replayed from CUDA graphs (`training/graphs.py`).

On the CPU: the rule that decides graphed against eager, the shape key,
AdamW's state made before a capture, the learning rate filled in place,
a CPU trainer that runs every step eagerly, and a checkpoint of a
capturable AdamW (as a graphed run writes it) restored into an eager
trainer.

On the card (marked `cuda`; this file imports no JAX), run with

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_train_graphs.py

graphed steps against eager steps from a copy of the same state, at the
same batches: losses, `train/grad_norm`, every weight, AdamW's moments
and the dropout generator's state after. The eager side is built as the
trainer builds it where graphs do not engage (AdamW not capturable, its
rate a number, its bias corrections on the host), and is held to
`MODES_RTOL`; an eager step of an AdamW prepared as the graphs prepare
theirs is held to 1e-6 relative. Also: interleaved batch shapes; metrics that outlive the next
step; the trainer's count of each kind of step; checkpoints restored
between graphed and eager trainers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from xfmr_rec_torch.data.module import DataConfig, RecDataModule
from xfmr_rec_torch.training import graphs
from xfmr_rec_torch.training import module as train_mod
from xfmr_rec_torch.training.graphs import StepGraphs, graphs_engage, shape_key
from xfmr_rec_torch.training.module import TrainConfig, TrainState
from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig

MODEL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
             intermediate_size=32, vocab_size=500, max_position_embeddings=32,
             max_length=16, learning_rate=1e-3, warmup_steps=2)
DATA = dict(batch_size=32, max_length=16, vocab_size=500,
            synthetic_users=40, synthetic_movies=120, synthetic_ratings=1200)
CUDA = torch.device("cuda")
CPU = torch.device("cpu")
# graphed against eager steps from one state: the losses agree to 1e-6
# relative, the weights and AdamW's moments to 1e-6 of each tensor's
# largest magnitude (the two AdamWs order their update's arithmetic
# differently; on the H100 over 6 seeds the losses came out equal and
# the weights 1.0e-7 to 1.9e-7 of that magnitude apart)
MODES_RTOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    dm = RecDataModule(DataConfig(
        data_dir=str(tmp_path_factory.mktemp("graphs")), **DATA))
    dm.prepare_data()
    dm.setup()
    return dm


def _partial(batch: dict[str, np.ndarray], rows: int) -> dict:
    """The first `rows` rows of a batch, as an epoch's partial last batch
    would hold them: `item_idx` and `log_q` hold positives then
    negatives."""
    full = len(batch["user_tokens"])
    return {k: (np.concatenate([v[:rows], v[full:full + rows]])
                if len(v) == 2 * full else v[:rows])
            for k, v in batch.items()}


@pytest.mark.parametrize(
    "device,mesh,changes,engaged",
    [
        (CUDA, False, {}, True),
        (CPU, False, {}, False),
        (CUDA, True, {}, False),
        (CUDA, False, {"remat": True}, False),
        (CUDA, False, {"user_tower": "history"}, False),
        (CUDA, False, {"item_id_embedding": "bloom"}, False),
        (CUDA, False, {"item_bias": True}, False),
        (CUDA, False, {"embedding_type": "hash"}, True),
    ],
)
def test_graphs_engage_on_one_card_for_the_text_tower(
    device, mesh, changes, engaged
):
    config = TrainConfig(**{**MODEL, **changes})
    assert graphs_engage(config, device, mesh=mesh) is engaged


def test_shape_key_follows_shapes_dtypes_and_losses_not_values(data):
    batch = next(data.train_batches(0))
    cut = train_mod.cut_to_run_width(batch, "mean")
    same = {k: np.zeros_like(v) + 1 for k, v in cut.items()}
    assert shape_key(cut, None) == shape_key(same, None)
    assert shape_key(cut, None) != shape_key(cut, ("PairwiseHingeLoss",))
    narrow = {**cut, "user_tokens": cut["user_tokens"][:, :8]}
    assert shape_key(narrow, None) != shape_key(cut, None)
    assert shape_key(_partial(cut, 20), None) != shape_key(cut, None)
    retyped = {**cut, "target": cut["target"].astype(np.float64)}
    assert shape_key(retyped, None) != shape_key(cut, None)


def test_prepared_adamw_state_steps_as_the_lazy_one():
    """The state made before a capture, and the learning rate made a
    tensor, give the AdamW step that the lazily made state gives."""
    torch.manual_seed(0)
    params = [torch.randn(3, 4), torch.randn(5)]
    grads = [torch.randn_like(p) for p in params]
    sides = []
    for prepare in (False, True):
        weights = [p.clone().requires_grad_() for p in params]
        opt = torch.optim.AdamW(weights, lr=1e-2, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.01)
        if prepare:
            graphs._prepare_adamw(opt)
            assert torch.is_tensor(opt.param_groups[0]["lr"])
            assert all(float(opt.state[w]["step"]) == 0.0
                       and opt.state[w]["step"].dtype == torch.float64
                       for w in weights)
        for _ in range(3):
            for w, g in zip(weights, grads, strict=True):
                w.grad = g.clone()
            opt.step()
        sides.append((weights, opt))
    (lazy, lazy_opt), (made, made_opt) = sides
    for a, b in zip(lazy, made, strict=True):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(made_opt.state[b][key],
                                       lazy_opt.state[a][key], rtol=0, atol=0)
        assert float(made_opt.state[b]["step"]) == 3.0


def test_learning_rate_fills_a_device_tensor_in_place():
    config = TrainConfig(**MODEL)
    state = TrainState(config, seed=0, device="cpu")
    state.step = 1
    train_mod.set_learning_rate(state)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)
    lr = torch.tensor(0.0)
    state.optimizer.param_groups[0]["lr"] = lr
    state.step = 2
    train_mod.set_learning_rate(state)
    assert state.optimizer.param_groups[0]["lr"] is lr
    assert float(lr) == pytest.approx(1e-3)


def test_a_cpu_trainer_runs_every_step_eagerly(data, tmp_path):
    trainer = Trainer(TrainConfig(**MODEL), data,
                      TrainerConfig(log_dir=str(tmp_path), run_name="r",
                                    checkpointing=False), device="cpu")
    trainer.setup()
    assert trainer.state.graphs is None
    assert trainer.state.optimizer.defaults["capturable"] is False
    for _, batch in zip(range(2), data.train_batches(0)):
        trainer.train_step(batch)
    assert trainer.step_counts == {"captured": 0, "replayed": 0, "eager": 2}


def _cpu_trainer(config, data, tmp_path) -> Trainer:
    return Trainer(config, data,
                   TrainerConfig(log_dir=str(tmp_path), run_name="r",
                                 ckpt_dir=str(tmp_path / "ckpt")),
                   device="cpu")


@pytest.mark.parametrize("saved_capturable", [False, True])
def test_a_checkpoint_restores_into_an_eager_trainer_in_either_mode(
    data, tmp_path, saved_capturable
):
    """A checkpoint whose AdamW groups are capturable with a tensor rate,
    as a graphed run writes them, restores into an eager trainer in the
    eager mode and steps as the eager checkpoint does, bit for bit."""
    config = TrainConfig(**MODEL)
    writer = _cpu_trainer(config, data, tmp_path)
    writer.setup()
    batches = [b for _, b in zip(range(4), data.train_batches(0))]
    for batch in batches[:2]:
        writer.train_step(batch)
    writer.save_checkpoint("mid")
    path = tmp_path / "ckpt" / "mid"
    if saved_capturable:
        saved = torch.load(path, weights_only=True)
        for group in saved["opt_state"]["param_groups"]:
            group["capturable"] = True
            group["lr"] = torch.tensor(group["lr"])
        path = tmp_path / "card" / "mid"
        path.parent.mkdir()
        torch.save(saved, path)
    reader = _cpu_trainer(config, data, tmp_path)
    reader.restore_checkpoint(str(path))
    for group in reader.state.optimizer.param_groups:
        assert group["capturable"] is False
        assert isinstance(group["lr"], float)
    for batch in batches[2:]:
        want = writer.train_step(batch)
        got = reader.train_step(batch)
        for key, value in want.items():
            torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    for a, b in zip(reader.state.model.parameters(),
                    writer.state.model.parameters(), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(reader.state.optimizer.state[a][key],
                                       writer.state.optimizer.state[b][key],
                                       rtol=0, atol=0)


# -- on the card -----------------------------------------------------------
def _states(card, *, capturable_reference=False, **changes):
    """A graphed state, and the eager state it is held to: built as the
    trainer builds one where graphs do not engage, or capturable."""
    config = TrainConfig(**{**MODEL, **changes})
    graphed = TrainState(config, seed=0, device=card, capturable=True)
    graphed.graphs = StepGraphs(card)
    eager = TrainState(config, seed=0, device=card,
                       capturable=capturable_reference)
    return graphed, eager


def _assert_same_state(graphed: TrainState, eager: TrainState,
                       modes: bool = True) -> None:
    """Weights and AdamW's moments within 1e-6 relative, or, between
    the two AdamW modes, `MODES_RTOL` of each tensor's largest
    magnitude; the step counts, the generator and the update count
    equal."""
    def close(got, want, msg):
        atol = MODES_RTOL * float(want.abs().max()) if modes else 0.0
        torch.testing.assert_close(got, want, rtol=1e-6, atol=atol, msg=msg)

    for (name, a), b in zip(graphed.model.named_parameters(),
                            eager.model.parameters(), strict=True):
        close(a, b, name)
        for key in ("exp_avg", "exp_avg_sq"):
            close(graphed.optimizer.state[a][key],
                  eager.optimizer.state[b][key], f"{name} {key}")
        assert (float(graphed.optimizer.state[a]["step"])
                == float(eager.optimizer.state[b]["step"]))
    assert torch.equal(graphed.generator.get_state(),
                       eager.generator.get_state())
    assert graphed.step == eager.step


def _run_both(graphed, eager, batches, log_all_losses=True):
    """Each batch through the graphs and through the eager step, their
    metrics within 1e-6 relative; the captured flags."""
    flags = []
    for batch in batches:
        got, captured = graphed.graphs.step(graphed, batch,
                                            log_all_losses=log_all_losses)
        want = train_mod.train_step(
            eager, train_mod.batch_to_device(batch, eager.device, "mean"),
            log_all_losses=log_all_losses)
        assert got.keys() == want.keys()
        for key, value in want.items():
            torch.testing.assert_close(got[key], value, rtol=1e-6, atol=0,
                                       msg=key)
        flags.append(captured)
    return flags


@pytest.mark.cuda
@pytest.mark.parametrize("log_all_losses", [True, False])
def test_graphed_steps_equal_eager_steps(card, data, log_all_losses):
    graphed, eager = _states(card)
    batches = [b for _, b in zip(range(4), data.train_batches(0))]
    assert eager.optimizer.defaults["capturable"] is False
    flags = _run_both(graphed, eager, batches, log_all_losses)
    assert flags == [True, False, False, False]
    assert len(graphed.graphs) == 1
    _assert_same_state(graphed, eager)
    assert graphed.model.token_slots == eager.model.token_slots


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps_of_a_capturable_adamw(card, data):
    """With the optimizer's arithmetic the same on both sides (AdamW
    prepared as the graphs prepare it: float64 step counts, a device
    rate), what is left is the replay itself: within 1e-6 relative."""
    graphed, eager = _states(card, capturable_reference=True)
    batches = [b for _, b in zip(range(4), data.train_batches(0))]
    graphs._prepare_adamw(eager.optimizer)
    _run_both(graphed, eager, batches)
    _assert_same_state(graphed, eager, modes=False)


@pytest.mark.cuda
def test_interleaved_shapes_give_the_eager_results(card, data):
    """Width 16, 8 (every text cut to 8 columns), 16 again, then an
    epoch's partial last batch: three sets in the shared pool."""
    graphed, eager = _states(card)
    wide = [b for _, b in zip(range(3), data.train_batches(0))]
    narrow = {k: (v * (np.arange(v.shape[-1]) < 8) if k.endswith("_tokens")
                  else v) for k, v in wide[1].items()}
    partial = _partial(wide[2], 20)
    widths = [train_mod.cut_to_run_width(b, "mean")["user_tokens"].shape[1]
              for b in (wide[0], narrow, wide[2])]
    assert widths == [16, 8, 16]
    flags = _run_both(graphed, eager, [wide[0], narrow, wide[2], partial])
    assert flags == [True, True, False, True]
    assert len(graphed.graphs) == 3
    _assert_same_state(graphed, eager)
    assert graphed.model.token_slots == eager.model.token_slots


@pytest.mark.cuda
def test_metrics_keep_their_values_after_the_next_step(card, data):
    state, _ = _states(card)
    batches = [b for _, b in zip(range(3), data.train_batches(0))]
    first, _ = state.graphs.step(state, batches[0])
    kept = {k: float(v) for k, v in first.items()}
    for batch in batches[1:]:
        later, _ = state.graphs.step(state, batch)
    assert {k: float(v) for k, v in first.items()} == kept
    assert {k: float(v) for k, v in later.items()} != kept


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_the_trainer_counts_its_steps_by_kind(card, data, tmp_path, remat):
    trainer = Trainer(
        TrainConfig(**{**MODEL, "remat": remat}), data,
        TrainerConfig(log_dir=str(tmp_path), run_name="r",
                      checkpointing=False), device=card)
    trainer.setup()
    for _, batch in zip(range(3), data.train_batches(0)):
        trainer.train_step(batch)
    if remat:
        assert trainer.state.graphs is None
        assert trainer.state.optimizer.defaults["capturable"] is False
        assert trainer.step_counts == {"captured": 0, "replayed": 0,
                                       "eager": 3}
    else:
        assert trainer.step_counts == {"captured": 1, "replayed": 2,
                                       "eager": 0}


@pytest.mark.cuda
def test_a_restored_checkpoint_recaptures(card, data, tmp_path):
    """A restore replaces AdamW's state, so the next step captures anew
    and steps as a fresh trainer restored from the same checkpoint."""
    config = TrainConfig(**MODEL)
    make = lambda: Trainer(  # noqa: E731
        config, data, TrainerConfig(log_dir=str(tmp_path), run_name="r",
                                    ckpt_dir=str(tmp_path / "ckpt")),
        device=card)
    first, second = make(), make()
    first.setup()
    batches = [b for _, b in zip(range(4), data.train_batches(0))]
    for batch in batches[:2]:
        first.train_step(batch)
    first.save_checkpoint("mid")
    second.restore_checkpoint("mid")
    first.restore_checkpoint("mid")
    assert len(first.state.graphs) == 0
    for batch in batches[2:]:
        a = first.train_step(batch)
        b = second.train_step(batch)
        for key, value in a.items():
            torch.testing.assert_close(value, b[key], rtol=1e-6, atol=0)
    assert first.step_counts["captured"] == 2
    _assert_same_state(first.state, second.state, modes=False)


@pytest.mark.cuda
@pytest.mark.parametrize("writer_remat", [False, True])
def test_a_checkpoint_moves_between_graphed_and_eager_trainers(
    card, data, tmp_path, writer_remat
):
    """A graphed trainer's checkpoint restores into an eager one (remat
    on) and an eager one's into a graphed one; either steps on as the
    writer does."""
    make = lambda remat: Trainer(  # noqa: E731
        TrainConfig(**{**MODEL, "remat": remat}), data,
        TrainerConfig(log_dir=str(tmp_path), run_name="r",
                      ckpt_dir=str(tmp_path / "ckpt")), device=card)
    writer, reader = make(writer_remat), make(not writer_remat)
    writer.setup()
    batches = [b for _, b in zip(range(4), data.train_batches(0))]
    for batch in batches[:2]:
        writer.train_step(batch)
    writer.save_checkpoint("mid")
    reader.restore_checkpoint("mid")
    capturable = reader.state.graphs is not None
    assert capturable is writer_remat
    for group in reader.state.optimizer.param_groups:
        assert group["capturable"] is capturable
    for batch in batches[2:]:
        want = writer.train_step(batch)
        got = reader.train_step(batch)
        for key, value in want.items():
            torch.testing.assert_close(got[key], value, rtol=1e-6,
                                       atol=0, msg=key)
    graphed, eager = ((reader, writer) if capturable else (writer, reader))
    _assert_same_state(graphed.state, eager.state)
