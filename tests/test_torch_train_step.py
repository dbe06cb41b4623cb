"""Port parity: the train step, the optimizer, the schedules and dropout.

The reference's `create_train_state` params go through the converter
into the port's `TrainState`; then both take 5 steps on the same batches
with dropout off (lr 1e-3 and a warmup-cosine schedule, so the first
step has lr 0 and the later ones move the parameters).

Tolerances:
- f32: losses and grad_norm within 1e-4 relative (+1e-5 absolute for
  losses near 0; the largest seen is 9e-5 on a loss of order 1e-1);
  parameters within 5e-5 absolute. The gradients agree to f32 rounding;
  Adam divides each gradient by its own running RMS, so a component whose
  gradient is near rounding noise can move by up to lr a step on either
  side; seen: 9e-6 after 5 steps.
- bf16: each Dense output is rounded to bf16 (relative step 2^-8) where
  XLA and PyTorch may round differently, so losses and grad_norm are
  held within 3e-2 relative + 1e-2 absolute (DirectAU is a difference of
  terms near 0: seen 1.5e-2 relative, 1.1e-3 absolute). Rounding flips
  the sign of a few near-zero gradient components, and Adam moves each
  by up to lr a step either way, so single parameters part by up to
  2 * lr * steps (seen 5.1e-3 of 1e-2): that bound alone would pass any
  update. The bf16 case is held by the mean absolute parameter
  difference instead, within 1e-4 (seen 1.7e-5).

`test_parameter_bounds_fail_a_broken_update` runs the port with its
gradients zeroed or negated before each AdamW step and shows that both
cases' parameter bounds fail.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from xfmr_rec_torch.models import convert
from xfmr_rec_torch.models.encoder import dropout, init_encoder
from xfmr_rec_torch.models.history import TwoTowerModel
from xfmr_rec_torch.training import module as port_module
from xfmr_rec_tpu.data import DataConfig, RecDataModule
from xfmr_rec_tpu.data.prepare import prepare_movielens
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.serving.portable import _flatten
from xfmr_rec_tpu.training import module as ref_module

TINY = dict(
    hidden_size=32,
    num_hidden_layers=1,
    num_attention_heads=4,
    intermediate_size=32,
    vocab_size=500,
    max_position_embeddings=32,
    max_length=16,
    dropout_rate=0.0,
)
STEPS = 5
LR = 1e-3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    path = tmp_path_factory.mktemp("stepdata")
    generate_movielens(
        path, num_users=40, num_movies=120, num_ratings=1200, seed=1
    )
    prepare_movielens(str(path), overwrite=True)
    dm = RecDataModule(
        DataConfig(data_dir=str(path), batch_size=8, max_length=16,
                   vocab_size=500)
    )
    dm.setup()
    return [b for _, b in zip(range(STEPS), dm.train_batches(0))]


def port_state_from_ref(ref_state, kw):
    config = port_module.TrainConfig(**kw)
    state = port_module.TrainState(config, seed=0, device=CPU)
    flat = {k: np.asarray(v, np.float32)
            for k, v in _flatten(ref_state.params).items()}
    state.model.load_state_dict(
        convert.encoder_state_from_flat(flat, config)
    )
    return state


# compute_dtype: ((losses rtol, atol), largest parameter difference,
# mean parameter difference)
TOLERANCES = {
    "float32": ((1e-4, 1e-5), 5e-5, 5e-5),
    "bfloat16": ((3e-2, 1e-2), 2 * LR * STEPS, 1e-4),
}


def run_both(batches, compute_dtype, mutate=None):
    """5 reference steps and 5 port steps from one init. `mutate` scales
    the port's gradients before each AdamW step (0 or -1: a broken
    update). Returns the per-step metrics (port, reference) and the
    final flat parameters (port, reference, initial)."""
    kw = dict(TINY, compute_dtype=compute_dtype, learning_rate=LR,
              lr_schedule="cosine", warmup_steps=2, total_steps=10)
    ref_config = ref_module.TrainConfig(**kw)
    _, ref_state = ref_module.create_train_state(ref_config, rng=0)
    step = jax.jit(ref_module.make_train_step(ref_config))
    state = port_state_from_ref(ref_state, kw)
    if mutate is not None:
        def scale_grads(optimizer, args, kwargs):
            for group in optimizer.param_groups:
                for param in group["params"]:
                    param.grad.mul_(mutate)

        state.optimizer.register_step_pre_hook(scale_grads)
    initial = convert.flat_from_encoder_state(state.model.state_dict())
    metrics = []
    for batch in batches:
        ref_state, want = step(ref_state, batch)
        got = port_module.train_step(
            state, port_module.batch_to_device(batch, CPU)
        )
        metrics.append((got, want))
    assert state.step == STEPS
    want = {k: np.asarray(v) for k, v in _flatten(ref_state.params).items()}
    got = convert.flat_from_encoder_state(state.model.state_dict())
    return metrics, got, want, initial


def param_differences(got, want):
    """The largest and the mean absolute difference over all parameters."""
    assert got.keys() == want.keys()
    diff = np.concatenate([np.abs(got[n] - want[n]).ravel() for n in want])
    return float(diff.max()), float(diff.mean())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_five_steps_match_jax(batches, compute_dtype):
    loss_tol, max_tol, mean_tol = TOLERANCES[compute_dtype]
    metrics, got, want, initial = run_both(batches, compute_dtype)
    for step_got, step_want in metrics:
        assert step_got.keys() == step_want.keys()
        for key in step_want:
            np.testing.assert_allclose(
                float(step_got[key]), float(step_want[key]),
                rtol=loss_tol[0], atol=loss_tol[1], err_msg=key,
            )
    largest, mean = param_differences(got, want)
    assert largest <= max_tol
    assert mean <= mean_tol
    moved = max(np.abs(got[n] - initial[n]).max() for n in got)
    assert moved > 10 * mean_tol


@pytest.mark.parametrize("mutate", [0.0, -1.0], ids=["zeroed", "negated"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_parameter_bounds_fail_a_broken_update(batches, compute_dtype, mutate):
    _, max_tol, mean_tol = TOLERANCES[compute_dtype]
    _, got, want, _ = run_both(batches, compute_dtype, mutate=mutate)
    largest, mean = param_differences(got, want)
    assert mean > 3 * mean_tol
    if compute_dtype == "float32":
        assert largest > 10 * max_tol


def test_first_warmup_step_leaves_params(batches):
    state = port_module.TrainState(
        port_module.TrainConfig(**TINY, warmup_steps=3), device=CPU
    )
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    port_module.train_step(state, port_module.batch_to_device(batches[0], CPU))
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, before[name]), name


def optax_schedule(config):
    """The schedule the reference's `create_train_state` builds."""
    if config.lr_schedule == "cosine" or config.warmup_steps:
        total = config.total_steps or max(config.warmup_steps + 1, 1000)
        if config.lr_schedule == "cosine":
            return optax.warmup_cosine_decay_schedule(
                init_value=0.0,
                peak_value=config.learning_rate,
                warmup_steps=config.warmup_steps,
                decay_steps=total,
                end_value=config.learning_rate * 0.01,
            )
        return optax.linear_schedule(
            0.0, config.learning_rate, max(config.warmup_steps, 1)
        )
    return lambda count: config.learning_rate


@pytest.mark.parametrize(
    "schedule",
    [
        dict(),
        dict(warmup_steps=7),
        dict(lr_schedule="cosine", warmup_steps=5, total_steps=40),
        dict(lr_schedule="cosine", warmup_steps=0, total_steps=25),
        dict(lr_schedule="cosine", warmup_steps=3),
    ],
    ids=["constant", "linear-warmup", "warmup-cosine", "cosine",
         "cosine-default-total"],
)
def test_schedules_match_optax(schedule):
    config = port_module.TrainConfig(learning_rate=3e-4, **schedule)
    ref = optax_schedule(ref_module.TrainConfig(learning_rate=3e-4,
                                                **schedule))
    for count in range(0, 1100, 1 if config.total_steps else 7):
        np.testing.assert_allclose(
            port_module.learning_rate_at(config, count), float(ref(count)),
            rtol=1e-6, atol=1e-6 * config.learning_rate,
            err_msg=f"count {count}",
        )


def test_train_config_defaults_match():
    assert dataclasses.asdict(port_module.TrainConfig()) == (
        ref_module.TrainConfig().model_dump()
    )


def test_dropout_masks_follow_the_generator():
    config = port_module.TrainConfig(**{**TINY, "dropout_rate": 0.3},
                                     compute_dtype="float32")
    model = init_encoder(config, seed=0)
    tokens = torch.randint(1, 500, (6, 16))

    def run(seed):
        return model(tokens, torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(5), run(5), rtol=0, atol=0)
    assert not torch.equal(run(5), run(6))
    assert not torch.equal(run(5), model(tokens))


def test_dropout_keep_rate_and_scale():
    """Keep rate 1 - p within 6 standard deviations of a binomial over
    1e6 draws (p = 0.1: sd 3e-4); kept values are x / (1 - p)."""
    rate = 0.1
    x = torch.full((1000, 1000), 2.0)
    out = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = out != 0
    sd = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - (1 - rate)) < 6 * sd
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0 / 0.9))
    assert torch.equal(dropout(x, rate, None), x)


@pytest.mark.parametrize("std", [0.02, None])
def test_fresh_init_scales(std):
    config = port_module.TrainConfig(initializer_range=std, vocab_size=4000,
                                     hidden_size=64, intermediate_size=128)
    model = init_encoder(config, seed=3)
    state = model.state_dict()
    emb = state["word_embed.embedding"]
    want_emb = std if std is not None else 64 ** -0.5
    assert abs(emb.std().item() - want_emb) < 0.05 * want_emb
    kernel = state["layers.0.ffn_in.kernel"]  # fan_in 64
    want_kernel = std if std is not None else 64 ** -0.5
    assert abs(kernel.std().item() - want_kernel) < 0.1 * want_kernel
    assert torch.equal(state["layers.0.attn_norm.scale"], torch.ones(64))
    assert torch.equal(state["layers.0.query.bias"], torch.zeros(4, 16))
    assert torch.equal(
        init_encoder(config, seed=3).state_dict()["word_embed.embedding"], emb
    )


def test_remat_and_two_tower_refused():
    """remat stays refused (for the fusion layers too); two-tower configs
    now build a `TwoTowerModel`."""
    with pytest.raises(NotImplementedError, match="remat"):
        port_module.TrainState(port_module.TrainConfig(remat=True), device=CPU)
    with pytest.raises(NotImplementedError, match="fusion"):
        port_module.TrainState(port_module.TrainConfig(
            remat=True, user_tower="history"), device=CPU)
    state = port_module.TrainState(
        port_module.TrainConfig(item_bias=True), device=CPU
    )
    assert isinstance(state.model, TwoTowerModel)
    with pytest.raises(ValueError, match="train_loss"):
        port_module.TrainConfig(train_loss="NoSuchLoss")
    with pytest.raises(ValueError, match="total_steps"):
        port_module.TrainState(port_module.TrainConfig(
            lr_schedule="cosine", warmup_steps=5, total_steps=5))
