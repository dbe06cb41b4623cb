"""Port parity: flax's msgpack state format without msgpack or flax.

`utils/flax_msgpack.py` must read what `flax.serialization.to_bytes`
writes and write what `from_bytes` / `msgpack_restore` read: the port's
bytes for a tree are `msgpack_serialize`'s (keys sorted). A JAX two-tower tree
round-trips through the port's `TwoTowerModel` state_dict, and forms the
codec does not know are refused, not guessed.
"""

import jax
import msgpack
import numpy as np
import pytest
from flax import serialization

from xfmr_rec_torch.models import convert
from xfmr_rec_torch.models.history import TwoTowerModel as PortTwoTower
from xfmr_rec_torch.training.module import TrainConfig as PortTrainConfig
from xfmr_rec_torch.utils import flax_msgpack
from xfmr_rec_tpu.models.history import init_two_tower
from xfmr_rec_tpu.serving.portable import _flatten
from xfmr_rec_tpu.training.module import TrainConfig

MODEL = dict(
    hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
    intermediate_size=32, vocab_size=300, max_position_embeddings=16,
    max_length=8, user_tower="history", max_history=4,
    item_id_embedding="hash", item_bias=True, max_bag=3, item_id_buckets=64,
)


def sample_tree():
    rng = np.random.default_rng(0)
    return {
        "text": {"layer_0": {"query": {
            "kernel": rng.normal(size=(32, 4, 8)).astype(np.float32),
            "bias": np.zeros((4, 8), np.float32),
        }}},
        "k" * 40: {"ids": np.arange(70000, dtype=np.int32),
                   "flags": np.array([True, False])},
        "bag_rating_weight": np.ones(8, np.float32),
        "empty": np.zeros((0, 3), np.float64),
        "scalar": np.float32(3.5),
        "wide": rng.normal(size=(3, 300)).astype(np.float16),
    }


def test_bytes_equal_flax():
    tree = sample_tree()
    assert flax_msgpack.dumps(tree) == serialization.msgpack_serialize(tree)


def test_reads_flax_and_flax_reads_port():
    tree = sample_tree()
    flat = flax_msgpack.flatten(tree)
    back = flax_msgpack.flatten(
        flax_msgpack.loads(serialization.msgpack_serialize(tree))
    )
    assert back.keys() == flat.keys()
    restored = flax_msgpack.flatten(
        serialization.msgpack_restore(flax_msgpack.dumps(tree))
    )
    for name, value in flat.items():
        for other in (back[name], restored[name]):
            assert np.asarray(other).dtype == np.asarray(value).dtype, name
            np.testing.assert_array_equal(other, value, err_msg=name)


def test_plain_values_match_msgpack():
    value = [0, 127, 128, -1, -32, -33, -129, 70000, 2**40, -(2**40),
             "x" * 31, "y" * 300, b"z" * 70000,
             {k: int(k) for k in sorted(str(i) for i in range(20))},
             list(range(17))]
    out = bytearray()
    flax_msgpack._pack(out, value)
    assert bytes(out) == msgpack.packb(value, use_bin_type=True)
    assert flax_msgpack._Reader(bytes(out)).value() == value
    other = [1.5, None, True, False]
    assert flax_msgpack._Reader(msgpack.packb(other)).value() == other


def test_two_tower_tree_round_trip(tmp_path):
    """A JAX two-tower `encoder.msgpack` loads into the port's model, and
    the port's file of that model restores into the JAX template."""
    config = TrainConfig(**MODEL)
    _, params = init_two_tower(config, jax.random.PRNGKey(0))
    path = tmp_path / "encoder.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    port_config = PortTrainConfig(**MODEL)
    model = PortTwoTower(port_config)
    model.load_state_dict(convert.two_tower_state_from_flat(
        convert.read_msgpack(path), port_config
    ))
    out = convert.write_msgpack(model.state_dict(), tmp_path / "port")
    restored = serialization.from_bytes(params, out.read_bytes())
    for name, value in _flatten(params).items():
        np.testing.assert_array_equal(_flatten(restored)[name], value)


def test_refuses_unknown_forms():
    arr = np.zeros(3, np.float32)
    payload = msgpack.packb(((3,), "complex64", arr.tobytes()),
                            use_bin_type=True)
    with pytest.raises(ValueError, match="dtype"):
        flax_msgpack.loads(msgpack.packb(
            {"a": msgpack.ExtType(1, payload)}, use_bin_type=True))
    with pytest.raises(ValueError, match="ext type"):
        flax_msgpack.loads(msgpack.packb(
            {"a": msgpack.ExtType(2, b"xx")}, use_bin_type=True))
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
                     "chunks": {"0": arr}}}
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.loads(serialization.msgpack_serialize(chunked))
    good = serialization.msgpack_serialize({"a": arr})
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.loads(good + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(good[:-3])
    with pytest.raises(ValueError, match="not written"):
        flax_msgpack.dumps({"a": np.zeros(2, np.complex64)})
    with pytest.raises(ValueError, match="do not match"):
        convert.two_tower_state_from_flat(
            {"text/word_embed/embedding": np.zeros((2, 2), np.float32)},
            PortTrainConfig(**MODEL),
        )
