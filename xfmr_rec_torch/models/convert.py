"""Carry model weights to and from the files both packages write.

`Trainer.save` (either package's) writes `encoder.npz` (the text
encoder's flax param tree flattened with `/`-joined names, f32) and
`portable.json` (model config + tokenizer settings); for a two-tower
model it also writes the whole tree (`text/...`, `fusion/...`,
`item_id/...`, `bias_table/...`, `bag_rating_weight`) to
`encoder.msgpack` in flax's msgpack format (`utils/flax_msgpack.py`).
The port's modules keep the flax names and layouts, so conversion is a
rename both ways: `layer_0/query/kernel` <-> `layers.0.query.kernel`,
`fusion/fusion_layer_0/...` <-> `fusion.layers.0....`.
"""

from __future__ import annotations

import json
import pathlib
import re

import numpy as np
import torch

from xfmr_rec_torch.models.encoder import ModelConfig, TextEncoder
from xfmr_rec_torch.models.history import TwoTowerModel
from xfmr_rec_torch.params import ENCODER_MSGPACK, PORTABLE_JSON, PORTABLE_NPZ
from xfmr_rec_torch.utils import flax_msgpack

_LAYER = re.compile(r"(^|/)(?:fusion_)?layer_(\d+)/")
_TORCH_LAYER = re.compile(r"(^|\.)layers\.(\d+)\.")


def torch_name(name: str) -> str:
    """Flat flax name -> the port's state_dict name."""
    return _LAYER.sub(r"\1layers.\2.", name).replace("/", ".")


def flax_name(name: str) -> str:
    """The port's state_dict name -> flat flax name."""
    layer = "fusion_layer_" if name.startswith("fusion.") else "layer_"
    return _TORCH_LAYER.sub(
        lambda m: f"{m.group(1)}{layer}{m.group(2)}/", name
    ).replace(".", "/")


def flat_from_encoder_state(
    state: dict[str, torch.Tensor],
) -> dict[str, np.ndarray]:
    """The port's `TextEncoder` or `TwoTowerModel` state_dict -> flat
    flax params (f32 numpy copies), the layout of `encoder.npz`."""
    return {
        flax_name(name): np.array(tensor.detach().float().cpu())
        for name, tensor in state.items()
    }


def write_portable(
    state: dict[str, torch.Tensor],
    model_dump: dict,
    data_dump: dict,
    out_dir: str | pathlib.Path,
) -> pathlib.Path:
    """Write `encoder.npz` + `portable.json` in the layout of the
    reference's `serving/portable.py` `write_portable`."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / PORTABLE_NPZ, **flat_from_encoder_state(state))
    tokenizer = {
        "kind": data_dump.get("tokenizer", "hashing"),
        "vocab_size": data_dump.get("vocab_size", model_dump["vocab_size"]),
        "max_length": data_dump.get("max_length", model_dump["max_length"]),
    }
    (out / PORTABLE_JSON).write_text(
        json.dumps({"model": model_dump, "tokenizer": tokenizer}, indent=2)
    )
    return out / PORTABLE_NPZ


def encoder_state_from_flat(
    flat: dict[str, np.ndarray], config: ModelConfig
) -> dict[str, torch.Tensor]:
    """Flat flax params -> the port's `TextEncoder` state_dict.

    Fails loudly on a missing or unexpected name, or a shape mismatch,
    rather than serving a half-loaded encoder.
    """
    return _state_from_flat(flat, TextEncoder(config).state_dict())


def two_tower_state_from_flat(
    flat: dict[str, np.ndarray], config: ModelConfig
) -> dict[str, torch.Tensor]:
    """Flat flax params of the whole two-tower tree -> the port's
    `TwoTowerModel` state_dict (checked like `encoder_state_from_flat`)."""
    return _state_from_flat(flat, TwoTowerModel(config).state_dict())


def write_msgpack(
    state: dict[str, torch.Tensor], out_dir: str | pathlib.Path
) -> pathlib.Path:
    """Write a state_dict as `encoder.msgpack`, the flax parameter tree
    that the reference's `flax.serialization.from_bytes` restores."""
    path = pathlib.Path(out_dir) / ENCODER_MSGPACK
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(
        flax_msgpack.dumps(
            flax_msgpack.unflatten(flat_from_encoder_state(state))
        )
    )
    return path


def read_msgpack(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    """Flat flax params from an `encoder.msgpack` (either package's)."""
    tree = flax_msgpack.loads(pathlib.Path(path).read_bytes())
    return {
        name: np.asarray(value, np.float32)
        for name, value in flax_msgpack.flatten(tree).items()
    }


def _state_from_flat(
    flat: dict[str, np.ndarray], expected: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    state = {
        torch_name(name): torch.from_numpy(np.array(value, np.float32))
        for name, value in flat.items()
    }
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        msg = f"encoder params do not match the config: {missing=} {extra=}"
        raise ValueError(msg)
    for name, tensor in state.items():
        if tuple(tensor.shape) != tuple(expected[name].shape):
            msg = (
                f"{name}: shape {tuple(tensor.shape)} != "
                f"{tuple(expected[name].shape)}"
            )
            raise ValueError(msg)
    return state


def load_portable(
    artifact_dir: str | pathlib.Path,
) -> tuple[ModelConfig, dict, dict[str, torch.Tensor]]:
    """Read `encoder.npz` + `portable.json`: (config, tokenizer settings,
    state_dict for `TextEncoder`)."""
    path = pathlib.Path(artifact_dir)
    meta = json.loads((path / PORTABLE_JSON).read_text())
    config = ModelConfig.from_dict(meta["model"])
    with np.load(path / PORTABLE_NPZ, allow_pickle=False) as npz:
        flat = {name: npz[name] for name in npz.files}
    return config, meta.get("tokenizer", {}), encoder_state_from_flat(
        flat, config
    )


def build_encoder(
    config: ModelConfig,
    state: dict[str, torch.Tensor],
    device: torch.device | str,
    cls: type = TextEncoder,
) -> TextEncoder | TwoTowerModel:
    """A serving model (`cls`): loaded, on `device`, with no gradients."""
    encoder = cls(config)
    encoder.load_state_dict(state)
    return encoder.requires_grad_(False).to(device).eval()
