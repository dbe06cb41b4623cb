"""Port parity: `serving/portable.py`, the numpy-only text encoder.

- The port's `PortableEncoder` equals the reference's on the same flat
  parameters (the same numpy arithmetic: equal to 1e-7), for every
  pooling, activation and embedding table, and the port's `TextEncoder`
  at f32 within 1e-5 (another framework's f32 rounding).
- It reads an `encoder.npz` written by either package, and
  `export_portable` turns a flax `encoder.msgpack` (text or two-tower)
  into the files both readers take.
- It imports and embeds with torch, JAX and flax blocked.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax import serialization

from xfmr_rec_torch.models import convert
from xfmr_rec_torch.models.encoder import ModelConfig as PortModelConfig
from xfmr_rec_torch.models.encoder import TextEncoder
from xfmr_rec_torch.serving import portable as port
from xfmr_rec_tpu.models import HashingTokenizer, ModelConfig, init_encoder
from xfmr_rec_tpu.models.history import init_two_tower
from xfmr_rec_tpu.serving import portable as ref

REPO = pathlib.Path(__file__).resolve().parent.parent
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
    "",
]
OVERRIDES = [
    {},
    {"pooling_mode": "cls"},
    {"pooling_mode": "max"},
    {"pooling_mode": "pooler"},
    {"hidden_act": "gelu_new"},
    {"hidden_act": "relu"},
    {"embedding_type": "bloom", "num_buckets": 128, "num_hashes": 2},
    {"embedding_type": "hash", "num_buckets": 128, "num_hashes": 3},
    {"normalize": False},
]


def flat_params(config):
    _, params = init_encoder(config, rng=0)
    return params, {k: np.asarray(v, np.float32)
                    for k, v in ref._flatten(params).items()}


def portable_config(config):
    cfg = config.model_dump()
    cfg["tokenizer"] = {"kind": "hashing", "vocab_size": config.vocab_size,
                        "max_length": config.max_length}
    return cfg


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_numpy_forward_matches_reference_and_torch(overrides):
    config = ModelConfig(**{**TINY, **overrides})
    _, flat = flat_params(config)
    ids = np.asarray(HashingTokenizer(vocab_size=1000, max_length=16)
                     .encode_batch(TEXTS))
    want = ref.PortableEncoder(portable_config(config), flat).encode(ids)
    got = port.PortableEncoder(portable_config(config), flat).encode(ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    port_config = PortModelConfig.from_dict(config.model_dump())
    encoder = TextEncoder(port_config)
    encoder.load_state_dict(convert.encoder_state_from_flat(flat,
                                                            port_config))
    with torch.no_grad():
        torch_out = encoder(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, torch_out, rtol=1e-5, atol=1e-5)


def write_artifact(path, config, params):
    path.mkdir(parents=True, exist_ok=True)
    (path / "encoder.msgpack").write_bytes(serialization.to_bytes(params))
    (path / "processors.json").write_text(json.dumps({
        "model": config.model_dump(),
        "data": {"tokenizer": "hashing", "vocab_size": config.vocab_size,
                 "max_length": config.max_length},
    }))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reads_either_packages_npz(tmp_path, writer):
    config = ModelConfig(**TINY)
    params, flat = flat_params(config)
    model_dump = config.model_dump()
    data_dump = {"tokenizer": "hashing", "vocab_size": 1000,
                 "max_length": 16}
    if writer == "jax":
        ref.write_portable(params, model_dump, data_dump, tmp_path)
    else:
        port_config = PortModelConfig.from_dict(model_dump)
        convert.write_portable(
            convert.encoder_state_from_flat(flat, port_config),
            model_dump, data_dump, tmp_path)
    got = port.PortableEncoder.load(tmp_path).embed(TEXTS)
    want = ref.PortableEncoder.load(tmp_path).embed(TEXTS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("two_tower", [False, True])
def test_export_round_trip(tmp_path, two_tower):
    if two_tower:
        config = ModelConfig(**TINY, user_tower="history", max_history=4,
                             item_id_embedding="bloom", item_id_buckets=64)
        _, params = init_two_tower(config, rng=0)
    else:
        config = ModelConfig(**TINY)
        _, params = init_encoder(config, rng=3)
    write_artifact(tmp_path / "a", config, params)
    write_artifact(tmp_path / "b", config, params)
    port.export_portable(tmp_path / "a")
    ref.export_portable(tmp_path / "b")
    with np.load(tmp_path / "a" / "encoder.npz") as got, \
            np.load(tmp_path / "b" / "encoder.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(
        port.PortableEncoder.load(tmp_path / "a").embed(TEXTS),
        port.PortableEncoder.load(tmp_path / "b").embed(TEXTS))
    out = port.export_portable(tmp_path / "a", tmp_path / "out")
    assert out == tmp_path / "out" / "encoder.npz" and out.is_file()


BLOCKED = ("torch", "jax", "jaxlib", "flax", "triton")
CODE = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ModuleNotFoundError(f"blocked: {{name}}")
        return None
sys.meta_path.insert(0, Block())
from xfmr_rec_torch.serving.portable import PortableEncoder
out = PortableEncoder.load({path!r}).embed(["Toy Story", ""])
assert out.shape == (2, 32), out.shape
assert not [m for m in sys.modules if m.split(".")[0] in {blocked!r}]
"""


def test_runs_without_torch(tmp_path):
    config = ModelConfig(**TINY)
    params, _ = flat_params(config)
    ref.write_portable(params, config.model_dump(),
                       {"tokenizer": "hashing", "vocab_size": 1000,
                        "max_length": 16}, tmp_path)
    code = CODE.format(blocked=BLOCKED, path=str(tmp_path))
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            capture_output=True, text=True, timeout=300,
                            check=False)
    assert result.returncode == 0, result.stdout + result.stderr
