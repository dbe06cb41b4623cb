"""`remat=True`: the text and fusion layers recomputed in the backward.

- With dropout on (rate 0.1), 3 steps with `remat=True` equal 3 steps
  without it from the same seed, for the text tower and the history
  tower: losses, gradients and parameters within 1e-6 (the same
  arithmetic; seen: equal), and the dropout generator's state equal
  after every step (the recompute replays the forward's masks and leaves
  the generator where the forward left it).
- With dropout off, the port's remat steps match the reference's
  `remat=True` steps (`nn.remat`) from one init: losses within 1e-4
  relative, parameters within 5e-5 (f32; the tolerances of
  tests/test_torch_train_step.py).
- Remat keeps fewer tensors for the backward than the plain forward.
"""

import jax
import numpy as np
import pytest
import torch

from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.data.prepare import prepare_movielens
from xfmr_rec_torch.data.synthetic import generate_movielens
from xfmr_rec_torch.models import convert
from xfmr_rec_torch.training import module as port_module
from xfmr_rec_tpu.serving.portable import _flatten
from xfmr_rec_tpu.training import module as ref_module

TINY = dict(
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=32,
    vocab_size=500,
    max_position_embeddings=32,
    max_length=16,
    compute_dtype="float32",
    learning_rate=1e-3,
)
HISTORY = dict(user_tower="history", max_history=4, history_layers=2)
STEPS = 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("rematdata")
    generate_movielens(
        path, num_users=40, num_movies=120, num_ratings=1200, seed=1
    )
    prepare_movielens(str(path), overwrite=True)
    return str(path)


def batches_for(data_dir, model):
    dm = PortDataModule(PortDataConfig(
        data_dir=data_dir, batch_size=8, max_length=16, vocab_size=500,
        max_history=model.get("max_history", 0),
    ))
    dm.setup()
    return [b for _, b in zip(range(STEPS), dm.train_batches(0))]


def run_steps(config, batches):
    """(per-step losses, gradients and generator states, final params)
    of `STEPS` port steps from seed 0."""
    state = port_module.TrainState(config, seed=0, device=CPU)
    trace = []
    for batch in batches:
        metrics = port_module.train_step(
            state, port_module.batch_to_device(batch, CPU)
        )
        grads = {
            name: param.grad.clone()
            for name, param in state.model.named_parameters()
        }
        trace.append((metrics, grads, state.generator.get_state()))
    return trace, state.model.state_dict()


@pytest.mark.parametrize("tower", ["text", "history"])
def test_remat_equals_plain_with_dropout(data_dir, tower):
    model = dict(TINY, dropout_rate=0.1, **(HISTORY if tower == "history"
                                             else {}))
    batches = batches_for(data_dir, model)
    plain, plain_params = run_steps(
        port_module.TrainConfig(**model), batches)
    remat, remat_params = run_steps(
        port_module.TrainConfig(**model, remat=True), batches)
    for (m0, g0, s0), (m1, g1, s1) in zip(plain, remat, strict=True):
        assert torch.equal(s0, s1)
        for name in m0:
            torch.testing.assert_close(m1[name], m0[name], rtol=0,
                                       atol=1e-6)
        for name in g0:
            torch.testing.assert_close(g1[name], g0[name], rtol=0,
                                       atol=1e-6)
    for name in plain_params:
        torch.testing.assert_close(remat_params[name], plain_params[name],
                                   rtol=0, atol=1e-6)
    # dropout was on: the runs would part without the replayed masks
    assert any(m0["train/grad_norm"] != 0 for m0, _, _ in plain)


def test_remat_matches_jax_remat(data_dir):
    kw = dict(TINY, dropout_rate=0.0, remat=True)
    batches = batches_for(data_dir, kw)
    ref_config = ref_module.TrainConfig(**kw)
    _, ref_state = ref_module.create_train_state(ref_config, rng=0)
    step = jax.jit(ref_module.make_train_step(ref_config))
    config = port_module.TrainConfig(**kw)
    state = port_module.TrainState(config, seed=0, device=CPU)
    flat = {k: np.asarray(v, np.float32)
            for k, v in _flatten(ref_state.params).items()}
    state.model.load_state_dict(
        convert.encoder_state_from_flat(flat, config))
    for batch in batches:
        ref_state, want = step(ref_state, batch)
        got = port_module.train_step(
            state, port_module.batch_to_device(batch, CPU))
        for name, value in want.items():
            np.testing.assert_allclose(
                float(got[name]), float(value), rtol=1e-4, atol=1e-5)
    want_params = {k: np.asarray(v, np.float32)
                   for k, v in _flatten(ref_state.params).items()}
    got_params = convert.flat_from_encoder_state(state.model.state_dict())
    for name, value in want_params.items():
        np.testing.assert_allclose(got_params[name], value, atol=5e-5)


@pytest.mark.parametrize("tower", ["text", "history"])
def test_remat_keeps_fewer_tensors(data_dir, tower):
    model = dict(TINY, dropout_rate=0.1, **(HISTORY if tower == "history"
                                             else {}))
    batch = port_module.batch_to_device(batches_for(data_dir, model)[0], CPU)

    def saved_bytes(remat):
        config = port_module.TrainConfig(**model, remat=remat)
        state = port_module.TrainState(config, seed=0, device=CPU)
        total = 0

        def pack(t):
            nonlocal total
            total += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            losses = port_module.compute_batch_losses(
                state.model, batch, config, generator=state.generator)
        losses[config.train_loss].backward()
        return total

    assert saved_bytes(True) < saved_bytes(False)
