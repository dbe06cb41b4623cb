"""Port parity: the flax TextEncoder vs the port's, on the same weights.

The flax params are initialised, perturbed with numpy noise (so LayerNorm
scales and biases are not trivially 1 and 0), flattened with the same
`/`-joined names `Trainer.save` writes to encoder.npz, and loaded into
the port through `models/convert.py`.

Tolerances: at compute_dtype="float32" both sides run the same f32 graph
up to summation order, so atol 1e-5 on unit-norm embeddings. At
"bfloat16" every Dense output and activation is rounded to bf16 (8 bits
of mantissa, relative step 2^-8 = 0.0039) at points where XLA and
PyTorch may round differently; a difference of one rounding step in a
hidden unit moves the unit-norm output by about that step's share, so the
bf16 check uses atol 1e-2 (2.5 bf16 steps; the seeds here differ by
under 2e-3).

The `_cut` cases pad the texts to 32 and give the port only the columns
`run_width` keeps (16: the texts run to at most 9 tokens), as
`batch_to_device` does; the flax encoder runs all 32, under the same
tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from xfmr_rec_torch.models import convert
from xfmr_rec_torch.models.encoder import ModelConfig as PortConfig
from xfmr_rec_torch.models.encoder import TextEncoder as PortEncoder
from xfmr_rec_torch.models.encoder import run_width
from xfmr_rec_torch.models.tokenizer import HashingTokenizer as PortHashing
from xfmr_rec_torch.models.tokenizer import TokenizerConfig as PortTokConfig
from xfmr_rec_torch.models.tokenizer import VocabTokenizer as PortVocab
from xfmr_rec_tpu.models import ModelConfig, init_encoder
from xfmr_rec_tpu.models.tokenizer import (
    HashingTokenizer,
    TokenizerConfig,
    VocabTokenizer,
    build_vocab,
)
from xfmr_rec_tpu.serving.portable import _flatten

TINY = dict(
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=64,
    max_position_embeddings=64,
    max_length=16,
    vocab_size=1000,
    compute_dtype="float32",
)

TEXTS = [
    '{"title":"Toy Story (1995)","genres":["Animation","Comedy"]}',
    '{"gender":"F","age":1,"occupation":10,"zipcode":"48067"}',
    "Heat (1995) crime thriller, the long version",
    "",
]


def _run_both(overrides, seed, max_length=16):
    """(port, flax) embeddings of TEXTS padded to `max_length`; the port
    is given the columns `run_width` keeps, which is every column at 16."""
    config = ModelConfig(**{**TINY, **overrides, "max_length": max_length})
    model, params = init_encoder(config, rng=seed)
    rng = np.random.default_rng(seed)
    flat = {
        key: np.asarray(value, np.float32)
        + rng.normal(scale=0.05, size=np.shape(value)).astype(np.float32)
        for key, value in _flatten(params).items()
    }
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}
    )
    tokens = HashingTokenizer(
        TokenizerConfig(vocab_size=config.vocab_size, max_length=max_length)
    ).encode_batch(TEXTS)
    width = run_width([tokens], config.pooling_mode)
    assert width == 16
    want = np.asarray(
        model.apply({"params": params}, jnp.asarray(tokens), deterministic=True)
    )
    port_config = PortConfig.from_dict(config.model_dump())
    encoder = convert.build_encoder(
        port_config, convert.encoder_state_from_flat(flat, port_config), "cpu"
    )
    got = encoder(torch.from_numpy(tokens[:, :width].copy())).numpy()
    return got, want


F32_CASES = pytest.mark.parametrize(
    "overrides",
    [
        {},
        {"pooling_mode": "cls"},
        {"pooling_mode": "max"},
        {"pooling_mode": "pooler"},
        {"hidden_act": "gelu_new"},
        {"hidden_act": "relu"},
        {"hidden_act": "silu"},
        {"embedding_type": "hash", "num_buckets": 128},
        {"embedding_type": "bloom", "num_buckets": 128, "num_hashes": 3},
        {"normalize": False},
    ],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "dense-mean",
)
BF16_CASES = pytest.mark.parametrize(
    "overrides",
    [{}, {"embedding_type": "bloom", "num_buckets": 128}],
    ids=["dense", "bloom"],
)


def _check_f32(overrides, max_length):
    got, want = _run_both(overrides, len(overrides) + 3, max_length)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _check_bf16(overrides, max_length):
    got, want = _run_both(
        {"compute_dtype": "bfloat16", **overrides}, 7, max_length
    )
    np.testing.assert_allclose(got, want, atol=1e-2)
    # unit norm after the f32 normalize
    np.testing.assert_allclose(
        np.linalg.norm(got[:-1], axis=1), 1.0, rtol=1e-5
    )


@F32_CASES
def test_encoder_f32_parity(overrides):
    _check_f32(overrides, max_length=16)


@F32_CASES
def test_encoder_f32_parity_cut(overrides):
    _check_f32(overrides, max_length=32)


@BF16_CASES
def test_encoder_bf16_parity(overrides):
    _check_bf16(overrides, max_length=16)


@BF16_CASES
def test_encoder_bf16_parity_cut(overrides):
    _check_bf16(overrides, max_length=32)


def test_rehash_buckets_match_uint32_arithmetic():
    """The bucket hash runs in int64 with a 32-bit mask; it must equal
    the reference's uint32 wrap-around for ids whose products overflow."""
    config = PortConfig(
        **{**TINY, "embedding_type": "bloom", "num_buckets": 4096,
           "num_hashes": 8}
    )
    encoder = PortEncoder(config)
    ids = np.array([0, 1, 2, 999, 65537, 29999], dtype=np.int32)
    mults = jnp.asarray(
        [2654435761, 2246822519, 3266489917, 668265263, 374761393,
         3812015801, 2176924009, 2957588489], dtype=jnp.uint32,
    )
    prod = jnp.asarray(ids).astype(jnp.uint32)[..., None] * mults
    want = (prod ^ (prod >> jnp.uint32(16))) % jnp.uint32(4096)
    ids_t = torch.from_numpy(ids).long()
    prod_t = ((ids_t & 0xFFFFFFFF)[..., None] * encoder.word_embed.mults) & (
        0xFFFFFFFF
    )
    got = (prod_t ^ (prod_t >> 16)) % 4096
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_rejects_mismatched_params():
    config = ModelConfig(**TINY)
    _, params = init_encoder(config, rng=0)
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    port_config = PortConfig.from_dict(config.model_dump())
    flat.pop("layer_1/ffn_in/bias")
    with pytest.raises(ValueError, match="missing"):
        convert.encoder_state_from_flat(flat, port_config)


@pytest.mark.parametrize("num_hashes", [1, 3])
def test_hashing_tokenizer_ids_identical(num_hashes):
    cfg = dict(vocab_size=5000, max_length=12, num_hashes=num_hashes)
    want = HashingTokenizer(TokenizerConfig(**cfg))._encode_batch_python(
        TEXTS, 12
    )
    got = PortHashing(PortTokConfig(**cfg)).encode_batch(TEXTS)
    if num_hashes == 1:
        want = want[..., 0]
    np.testing.assert_array_equal(got, want)


def test_vocab_tokenizer_ids_identical(tmp_path):
    vocab = build_vocab(TEXTS[:2], vocab_size=64, oov_buckets=16)
    ref = VocabTokenizer(vocab, TokenizerConfig(vocab_size=64, max_length=12))
    ref.save(tmp_path / "vocab.json")
    port = PortVocab.load(tmp_path / "vocab.json")
    want = np.stack([ref.encode(t) for t in TEXTS])
    np.testing.assert_array_equal(port.encode_batch(TEXTS), want)


def test_port_config_accepts_manifest_keys():
    """The JAX manifest's model entry carries training fields too; the
    port keeps its own and ignores the rest."""
    from xfmr_rec_tpu.training.module import TrainConfig

    dump = TrainConfig(hidden_size=32).model_dump()
    cfg = PortConfig.from_dict(dump)
    assert cfg.hidden_size == 32 and cfg.compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="pooling_mode"):
        PortConfig(pooling_mode="sum")
