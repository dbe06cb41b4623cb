"""Carry encoder weights from the JAX package's flat export.

`Trainer.save` writes `encoder.npz` (the flax param tree flattened with
`/`-joined names, f32) and `portable.json` (model config + tokenizer
settings). The port's `TextEncoder` keeps the flax names and layouts, so
conversion is a rename: `layer_0/query/kernel` -> `layers.0.query.kernel`.
"""

from __future__ import annotations

import json
import pathlib
import re

import numpy as np
import torch

from xfmr_rec_torch.models.encoder import ModelConfig, TextEncoder
from xfmr_rec_torch.params import PORTABLE_JSON, PORTABLE_NPZ

_LAYER = re.compile(r"^layer_(\d+)/")


def torch_name(flax_name: str) -> str:
    return _LAYER.sub(r"layers.\1.", flax_name).replace("/", ".")


def encoder_state_from_flat(
    flat: dict[str, np.ndarray], config: ModelConfig
) -> dict[str, torch.Tensor]:
    """Flat flax params -> the port's `TextEncoder` state_dict.

    Fails loudly on a missing or unexpected name, or a shape mismatch,
    rather than serving a half-loaded encoder.
    """
    expected = TextEncoder(config).state_dict()
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
) -> TextEncoder:
    encoder = TextEncoder(config)
    encoder.load_state_dict(state)
    return encoder.to(device).eval()
