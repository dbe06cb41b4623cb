"""The benchmark's seeded weights in the port's parameter names.

`reference.bert.make_weights` draws one set of weights; the port's
`TextEncoder` holds the same numbers under its own names and layouts (the
attention projections as (hidden, heads, head_dim) and (heads, head_dim,
hidden)). `port_state` hands the port those numbers; `REFERENCE_NAME`
maps each port name back, so the port's gradients and updates can be
compared weight by weight.
"""

from __future__ import annotations

import torch

_PROJ = {"query": "q", "key": "k", "value": "v", "attn_out": "o",
         "ffn_in": "ffn1", "ffn_out": "ffn2"}
_NORM = {"attn_norm": "ln1", "ffn_norm": "ln2"}


def reference_name(port_name: str) -> str:
    if port_name == "word_embed.embedding":
        return "word"
    if port_name == "position_embed.embedding":
        return "pos"
    if port_name.startswith("embed_norm."):
        return "emb_ln." + ("w" if port_name.endswith("scale") else "b")
    _, layer, module, leaf = port_name.split(".")
    if module in _PROJ:
        return f"l{layer}.{_PROJ[module]}." + ("w" if leaf == "kernel" else "b")
    return f"l{layer}.{_NORM[module]}." + ("w" if leaf == "scale" else "b")


def port_state(
    weights: dict[str, torch.Tensor], template: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """The port's state_dict (names and shapes of `template`) holding
    `weights`."""
    return {
        name: weights[reference_name(name)].reshape(tensor.shape).clone()
        for name, tensor in template.items()
    }
