"""Device mesh, batch placement and the collective helpers.

Port of `xfmr_rec_tpu/parallel/mesh.py`. The reference drives a
`jax.sharding.Mesh` from one program (single-controller SPMD) and lets
XLA insert the collectives. The port keeps that model: a `Mesh` is a
(data, model) grid of torch devices driven by one process, and the few
collectives the sharded paths need are plain device copies written here
(`gather_rows`, `gather_columns`, `pmax`, `sum_to`), so a multi-process
version only has to replace these helpers.

Mesh convention (the reference's):
- axis "data": data parallelism (batch rows split, gradients summed);
- axis "model": corpus parallelism for retrieval (the item matrix split
  along items, candidates merged on the lead device of each data row);
  training folds it into data parallelism, and `shard_vocab` splits the
  token-embedding table over it.

The device list may repeat a device: `create_mesh(devices=["cpu"] * 8)`
is the port's counterpart of the reference's forced 8-device CPU
platform, and `[cuda:0] * 4` runs four shards on one card. The shards are
still separate tensors swept by separate launches; the copies between
equal devices are no-ops.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A (data, model) grid of torch devices.

    `devices` is the numpy object grid, `shape` the axis sizes as a dict
    (read as JAX's `mesh.shape` is read), `size` the device count.
    """

    def __init__(self, devices: np.ndarray) -> None:
        if devices.ndim != 2 or devices.size == 0:
            msg = f"mesh devices must be a non-empty 2-D grid, got {devices.shape}"
            raise ValueError(msg)
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return {
            DATA_AXIS: int(self.devices.shape[0]),
            MODEL_AXIS: int(self.devices.shape[1]),
        }

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device that holds merged results and the optimizer."""
        return self.devices[0, 0]

    def flat(self) -> list[torch.device]:
        """Devices in batch order: data-major, then model."""
        return list(self.devices.reshape(-1))

    def distinct(self) -> list[torch.device]:
        """Each device once, in batch order (a virtual mesh has one)."""
        out: list[torch.device] = []
        for device in self.flat():
            if device not in out:
                out.append(device)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat()]})"


def _visible_cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(
    n_devices: int | None = None,
    model_parallel: int = 1,
    *,
    devices: Sequence[str | torch.device] | None = None,
) -> Mesh:
    """Mesh of shape (data = n / model_parallel, model = model_parallel).

    By default over every visible card; an explicit `devices` list may
    repeat a device (a virtual mesh).
    """
    if devices is None:
        visible = _visible_cards()
    else:
        visible = [torch.device(d) for d in devices]
    n_devices = n_devices or len(visible)
    if n_devices % model_parallel != 0:
        msg = f"{n_devices=} not divisible by {model_parallel=}"
        raise ValueError(msg)
    if n_devices > len(visible) or not visible:
        where = "given in devices=" if devices is not None else "visible cards"
        msg = (
            f"create_mesh asked for {n_devices} devices but only "
            f"{len(visible)} are {where}. For a virtual multi-device mesh "
            "pass devices= with a device repeated (for example "
            f"devices=['cpu'] * {n_devices or 8} or ['cuda:0'] * "
            f"{n_devices or 4})."
        )
        raise ValueError(msg)
    grid = np.empty(n_devices, dtype=object)
    grid[:] = visible[:n_devices]
    return Mesh(grid.reshape(n_devices // model_parallel, model_parallel))


def split_rows(value: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """`parts` equal chunks of the leading axis (it must divide)."""
    if value.shape[0] % parts:
        msg = f"leading axis {value.shape[0]} not divisible by {parts} devices"
        raise ValueError(msg)
    return list(torch.split(value, value.shape[0] // parts))


def shard_batch(
    batch: dict[str, np.ndarray | torch.Tensor], mesh: Mesh
) -> list[dict[str, torch.Tensor]]:
    """A host batch as per-device row chunks: entry i holds every field's
    i-th chunk of its leading axis, on `mesh.flat()[i]` (the leading axis
    split over every mesh axis, data-major, as the reference's
    `P((DATA_AXIS, MODEL_AXIS))`)."""
    devices = mesh.flat()
    shards: list[dict[str, torch.Tensor]] = [{} for _ in devices]
    for key, value in batch.items():
        tensor = torch.as_tensor(np.ascontiguousarray(value)) if isinstance(
            value, np.ndarray
        ) else value
        for shard, chunk, device in zip(
            shards, split_rows(tensor, len(devices)), devices, strict=True
        ):
            shard[key] = chunk.to(device)
    return shards


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """The parameters on the lead device (the replicated layout; other
    devices get copies at each step, `parallel/train.py`)."""
    return module.to(mesh.lead)


# -- collectives: the only cross-device traffic of the sharded paths ------
def gather_rows(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """All-gather along the leading axis onto `device`, in part order."""
    return torch.cat([p.to(device) for p in parts], dim=0)


def gather_columns(
    parts: Sequence[torch.Tensor], device: torch.device
) -> torch.Tensor:
    """All-gather over the model axis onto `device`: (B, w) parts ->
    (B, m * w), shard-major (the reference's `all_gather` +
    `transpose(1, 0, 2).reshape(B, -1)`)."""
    return torch.cat([p.to(device) for p in parts], dim=1)


def pmax(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Elementwise max over the parts, on `device`."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = torch.maximum(out, part.to(device))
    return out


def sum_to(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Sum of the parts on `device`, in part order (the gradient
    all-reduce)."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = out + part.to(device)
    return out
