"""Port parity: the history user tower and the item-identity channels.

The reference's `init_two_tower` params, perturbed with numpy noise (so
LayerNorm scales, biases, the zero-initialised popularity bias and the
bag's rating weights are not trivial), go through
`convert.two_tower_state_from_flat` into the port's `TwoTowerModel`;
both then run the same seeded inputs with dropout off.

Tolerances are `test_torch_encoder.py`'s: atol 1e-5 at f32 (the same
graph up to summation order) and 1e-2 at bf16 (a bf16 rounding step is
2^-8 of a unit vector; XLA and PyTorch may round at different points).
Gradients (f32) are held against `jax.grad` of the same scalar within
1e-5 absolute + 1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from xfmr_rec_torch.models import convert
from xfmr_rec_torch.models.history import IdEmbed as PortIdEmbed
from xfmr_rec_torch.models.history import TwoTowerModel as PortTwoTower
from xfmr_rec_torch.models.history import init_two_tower as port_init
from xfmr_rec_torch.training.module import TrainConfig as PortTrainConfig
from xfmr_rec_tpu.models.history import IdEmbed, TwoTowerModel, init_two_tower
from xfmr_rec_tpu.serving.portable import _flatten
from xfmr_rec_tpu.training.module import TrainConfig

TINY = dict(
    hidden_size=32,
    num_hidden_layers=1,
    num_attention_heads=4,
    intermediate_size=32,
    vocab_size=300,
    max_position_embeddings=16,
    max_length=8,
    compute_dtype="float32",
    dropout_rate=0.0,
    user_tower="history",
    max_history=4,
    history_layers=2,
    item_id_buckets=64,
)
B, H, G, L = 5, 4, 3, 8

CONFIGS = {
    "history": {},
    "history-no-ratings": dict(use_history_ratings=False),
    "history-dense-ids-bias": dict(item_id_embedding="dense", item_bias=True),
    "history-bloom-bag": dict(item_id_embedding="bloom", max_bag=G,
                              item_id_hashes=3),
    "history-hash-bag-bias": dict(item_id_embedding="hash", max_bag=G,
                                  item_bias=True),
    "history-bag-unweighted": dict(item_id_embedding="bloom", max_bag=G,
                                   bag_rating_weights=False),
    "text-bias": dict(user_tower="text", item_bias=True),
}


def perturbed_flat(params, seed):
    rng = np.random.default_rng(seed)
    return {
        key: np.asarray(value, np.float32)
        + rng.normal(scale=0.05, size=np.shape(value)).astype(np.float32)
        for key, value in _flatten(params).items()
    }


def unflatten(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}
    )


class Jitted:
    """`model.apply` under `jax.jit` (op-by-op flax is slow on the CPU)."""

    def __init__(self, model):
        self.apply = jax.jit(
            model.apply, static_argnames=("method", "deterministic")
        )


@functools.lru_cache(maxsize=None)
def built(name, compute_dtype="float32"):
    """`build` of a named config at seed 1, shared by the tests."""
    return build({**CONFIGS[name], "compute_dtype": compute_dtype}, seed=1)


def build(overrides, seed=0):
    config = TrainConfig(**{**TINY, **overrides})
    init = jax.jit(lambda key: init_two_tower(config, key)[1])
    flat = perturbed_flat(init(jax.random.PRNGKey(seed)), seed)
    port_config = PortTrainConfig(**{**TINY, **overrides})
    port = PortTwoTower(port_config)
    port.load_state_dict(convert.two_tower_state_from_flat(flat, port_config))
    return Jitted(TwoTowerModel(config)), unflatten(flat), port, config


def inputs(seed=0, empty_rows=(1,)):
    """Seeded batch: token rows with PAD tails, histories with padded
    slots (row 1 has none at all), ratings 0..5, movie_rns with 0 at
    padded slots, a bag with the same layout."""
    rng = np.random.default_rng(seed)

    def tokens(*shape):
        out = rng.integers(1, 300, size=(*shape, L)).astype(np.int32)
        lengths = rng.integers(1, L + 1, size=shape)
        out[np.arange(L) >= lengths[..., None]] = 0
        return out

    hist_mask = rng.random((B, H)) < 0.7
    hist_mask[:, 0] = True
    for row in empty_rows:
        hist_mask[row] = False
    hist_tokens = tokens(B, H) * hist_mask[..., None]
    bag_mask = rng.random((B, G)) < 0.7
    bag_mask[empty_rows[0] if empty_rows else 0] = False
    return {
        "user_tokens": tokens(B),
        "item_tokens": tokens(B),
        "neg_item_tokens": tokens(B),
        "hist_tokens": hist_tokens.astype(np.int32),
        "hist_mask": hist_mask,
        "hist_ratings": rng.integers(0, 6, size=(B, H)).astype(np.int32),
        "item_rns": rng.integers(0, 90, size=2 * B).astype(np.int32),
        "hist_rns": (rng.integers(1, 90, size=(B, H)) * hist_mask).astype(
            np.int32
        ),
        "bag_rns": (rng.integers(1, 90, size=(B, G)) * bag_mask).astype(
            np.int32
        ),
        "bag_ratings": rng.integers(0, 6, size=(B, G)).astype(np.int32),
        "bag_mask": bag_mask,
    }


def kwargs_for(config, batch, names):
    out = {}
    for name in names:
        if name.startswith("hist") and config.user_tower != "history":
            continue
        if name.startswith("bag") and config.max_bag == 0:
            continue
        if name.endswith("rns") and not (
            config.item_id_embedding != "none" or config.item_bias
        ):
            continue
        out[name] = batch[name]
    return out


TRAIN_ARGS = ("hist_tokens", "hist_mask", "hist_ratings", "item_rns",
              "hist_rns", "bag_rns", "bag_ratings", "bag_mask")


def to_torch(kwargs):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in kwargs.items()}


def run_train_embeds(model, params, port, config, batch):
    kw = kwargs_for(config, batch, TRAIN_ARGS)
    towers = [batch[n] for n in ("user_tokens", "item_tokens",
                                 "neg_item_tokens")]
    want = model.apply({"params": params}, *towers, deterministic=True,
                       method="train_embeds", **kw)
    got = port.train_embeds(*[torch.from_numpy(t) for t in towers],
                            **to_torch(kw))
    return got, want


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_embeds_f32(name):
    model, params, port, config = built(name)
    batch = inputs(2)
    got, want = run_train_embeds(model, params, port, config, batch)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["history", "history-bloom-bag"])
def test_train_embeds_bf16(name):
    model, params, port, config = built(name, "bfloat16")
    got, want = run_train_embeds(model, params, port, config, inputs(4))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-2)


@pytest.mark.parametrize("name", ["history", "history-hash-bag-bias",
                                  "text-bias"])
def test_encode_items_and_text_path(name):
    model, params, port, config = built(name)
    batch = inputs(6)
    rns = batch["item_rns"][:B] if config.item_bias or (
        config.item_id_embedding != "none") else None
    want = model.apply({"params": params}, batch["item_tokens"], rns,
                       deterministic=True, method="encode_items")
    got = port.encode_items(torch.from_numpy(batch["item_tokens"]),
                            None if rns is None else torch.from_numpy(rns))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    want = model.apply({"params": params}, batch["user_tokens"],
                       deterministic=True)
    got = port(torch.from_numpy(batch["user_tokens"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


USER_ARGS = ("hist_ratings", "bag_rns", "bag_ratings", "bag_mask")


@pytest.mark.parametrize("name", ["history", "history-no-ratings",
                                  "history-bloom-bag",
                                  "history-hash-bag-bias"])
def test_encode_user_and_fuse_user(name):
    model, params, port, config = built(name)
    batch = inputs(8)
    kw = kwargs_for(config, batch, ("hist_rns", *USER_ARGS))
    want = model.apply({"params": params}, batch["user_tokens"],
                       batch["hist_tokens"], batch["hist_mask"],
                       deterministic=True, method="encode_user", **kw)
    got = port.encode_user(torch.from_numpy(batch["user_tokens"]),
                           torch.from_numpy(batch["hist_tokens"]),
                           torch.from_numpy(batch["hist_mask"]),
                           **to_torch(kw))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    # fuse_user on the same inputs: random history embeddings, padded
    # slots filled with noise (masked, so they must not matter)
    rng = np.random.default_rng(9)
    text = rng.normal(size=(B, 32)).astype(np.float32)
    hist = rng.normal(size=(B, H, 32)).astype(np.float32)
    kw = kwargs_for(config, batch, USER_ARGS)
    want = model.apply({"params": params}, text, hist, batch["hist_mask"],
                       deterministic=True, method="fuse_user", **kw)
    got = port.fuse_user(torch.from_numpy(text), torch.from_numpy(hist),
                         torch.from_numpy(batch["hist_mask"]),
                         **to_torch(kw))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    refill = np.where(batch["hist_mask"][..., None], hist,
                      rng.normal(size=hist.shape).astype(np.float32))
    again = port.fuse_user(torch.from_numpy(text), torch.from_numpy(refill),
                           torch.from_numpy(batch["hist_mask"]),
                           **to_torch(kw))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["dense", "bloom", "hash"])
def test_id_embed_modes(mode):
    ref = IdEmbed(mode=mode, num_buckets=32, num_hashes=3, features=6)
    rns = np.array([[0, 1, 2, 31], [40, 2**20 + 7, 2**31 - 1, 0]], np.int32)
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(rns))["params"]
    flat = perturbed_flat(params, 3)
    want = np.asarray(ref.apply({"params": unflatten(flat)}, rns))
    port = PortIdEmbed(mode, 32, 3, 6)
    port.load_state_dict({convert.torch_name(k): torch.from_numpy(v)
                          for k, v in flat.items()})
    got = port(torch.from_numpy(rns)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert not got[rns == 0].any()  # rn 0 is exactly zero
    assert got[rns != 0].any(axis=-1).all()


def test_gradients_match_jax_with_empty_histories():
    """jax.grad vs autograd of one scalar of both towers, on a batch whose
    row 1 has no history at all (its history token rows are all PAD and
    pool to zero): every gradient finite and equal, and zero on the
    padded history slots' inputs."""
    overrides = dict(item_id_embedding="bloom", max_bag=G, item_bias=True)
    model, params, port, config = build(overrides, seed=11)
    batch = inputs(12, empty_rows=(1, 3))
    kw = kwargs_for(config, batch, TRAIN_ARGS)
    towers = [batch[n] for n in ("user_tokens", "item_tokens",
                                 "neg_item_tokens")]
    rng = np.random.default_rng(13)
    w_user = rng.normal(size=(B, 33)).astype(np.float32)
    w_item = rng.normal(size=(2 * B, 33)).astype(np.float32)

    def loss(p):
        user, item = model.apply({"params": p}, *towers, deterministic=True,
                                 method="train_embeds", **kw)
        return jnp.sum(user * w_user) + jnp.sum(item * w_item)

    want = {k: np.asarray(v) for k, v in
            _flatten(jax.jit(jax.grad(loss))(params)).items()}
    user, item = port.train_embeds(*[torch.from_numpy(t) for t in towers],
                                   **to_torch(kw))
    ((user * torch.from_numpy(w_user)).sum()
     + (item * torch.from_numpy(w_item)).sum()).backward()
    got = {convert.flax_name(n): p.grad.numpy()
           for n, p in port.named_parameters()}
    assert got.keys() == want.keys()
    for name in want:
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    # the padded slots' history embeddings get exactly zero gradient
    hist = torch.from_numpy(
        np.random.default_rng(14).normal(size=(B, H, 32)).astype(np.float32)
    ).requires_grad_(True)
    text = torch.from_numpy(np.asarray(user.detach()[:, :32]))
    fused = port.fuse_user(text, hist, torch.from_numpy(batch["hist_mask"]),
                           **to_torch(kwargs_for(config, batch, USER_ARGS)))
    (fused * torch.from_numpy(w_user)).sum().backward()
    pad = ~batch["hist_mask"]
    assert pad.any() and not hist.grad.numpy()[pad].any()
    assert hist.grad.numpy()[~pad].any(axis=-1).all()


def test_fresh_init_channels():
    config = PortTrainConfig(**{**TINY, **CONFIGS["history-hash-bag-bias"]})
    model = port_init(config, seed=2)
    state = model.state_dict()
    assert not state["bias_table.buckets.embedding"].any()
    assert torch.equal(state["bias_table.importance.embedding"],
                       torch.ones(64, 2))
    assert torch.equal(state["item_id.importance.embedding"],
                       torch.ones(64, 2))
    assert torch.equal(state["bag_rating_weight"], torch.ones(8))
    table = state["item_id.buckets.embedding"]
    assert abs(table.std().item() - 0.02) < 0.004
    assert state["fusion.slot_embed.embedding"].shape == (6, 32)
    assert torch.equal(
        port_init(config, seed=2).state_dict()["fusion.layers.1.query.kernel"],
        state["fusion.layers.1.query.kernel"],
    )
    params = jax.eval_shape(lambda: init_two_tower(TrainConfig(**{
        **TINY, **CONFIGS["history-hash-bag-bias"]}))[1])
    assert set(_flatten(params)) == {convert.flax_name(n) for n in state}
