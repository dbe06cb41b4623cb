"""Device mesh, batch placement and the collective helpers.

Port of `xfmr_rec_tpu/parallel/mesh.py`. The reference drives a
`jax.sharding.Mesh` from one program per host and lets XLA insert the
collectives. The port's `Mesh` is a (data, model) grid of slots, each a
(process, torch device) pair, and the few collectives the sharded paths
need are written here (`gather_rows`, `gather_columns`, `pmax`,
`sum_to`).

One controller: without a process group every slot belongs to this
process, and the helpers are plain device copies. The device list may
repeat a device: `create_mesh(devices=["cpu"] * 8)` is the port's
counterpart of the reference's forced 8-device CPU platform, and
`[cuda:0] * 4` runs four shards on one card. The shards are still
separate tensors swept by separate launches; the copies between equal
devices are no-ops.

Many processes: after `initialize_distributed`, `create_mesh` spans
every process of the group. Each process passes its own devices and the
grid holds every process's slots in process-major order, as
`jax.devices()` orders them after `jax.distributed.initialize` (so
`model_parallel=2` over two processes of four slots keeps each model
pair inside one process, and only the data axis crosses processes, as in
the reference). A process places and sweeps only its own slots
(`Mesh.local_slots`); the helpers, given a process group, take this
process's parts, combine them with every other member's (the gathers
in process order; `sum_to` and `pmax` by one all-reduce), and every
member receives the same result.

Transport (`transport_backend`): NCCL on the card where no two processes
share a card (each process's host and card UUID, exchanged at the
store, tell); gloo where processes share a card (NCCL takes one rank a
card) or run on the CPU. Gloo's collectives on CUDA
tensors are partial, so under gloo every collective is staged through
host memory. `initialize_distributed(backend=...)` overrides the rule;
an NCCL that cannot start raises and never becomes gloo.

Mesh convention (the reference's):
- axis "data": data parallelism (batch rows split, gradients summed);
- axis "model": corpus parallelism for retrieval (the item matrix split
  along items, candidates merged per data row); training folds it into
  data parallelism, and `shard_vocab` splits the token-embedding table
  over it.
"""

from __future__ import annotations

import datetime
import os
import socket
from collections.abc import Sequence

import numpy as np
import torch
import torch.distributed as dist

from xfmr_rec_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# a collective that waits longer than this raises (a peer that died must
# not leave the others blocked for good)
COLLECTIVE_TIMEOUT_S = 60.0


# -- the process group -----------------------------------------------------
def is_distributed() -> bool:
    """A process group is up (`initialize_distributed` ran)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the group (1 without one), as `jax.process_count()`."""
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    """This process's rank (0 without a group), as `jax.process_index()`."""
    return dist.get_rank() if is_distributed() else 0


def device_identity(device: torch.device) -> str | None:
    """What tells this process's card from every other process's: the
    host and the card's UUID (None for the CPU). Ranks on one host that
    name one card by different indices (`CUDA_VISIBLE_DEVICES`) get the
    same identity; two hosts' `cuda:0` get different ones."""
    if device.type != "cuda":
        return None
    uuid = torch.cuda.get_device_properties(device).uuid
    return f"{socket.gethostname()}/{uuid}"


def transport_backend(identities: Sequence[str | None]) -> str:
    """The rule, from every rank's `device_identity`: "nccl" where each
    rank has a card and no two ranks share one, else "gloo" (CPU slots,
    or ranks sharing a card, whose collectives are staged through host
    memory)."""
    if any(i is None for i in identities) or len(set(identities)) < len(
        identities
    ):
        return "gloo"
    return "nccl"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> torch.device:
    """Join the process group: call once per process before `create_mesh`.

    Counterpart of `jax.distributed.initialize`. With no arguments it
    reads what `torchrun` sets (`MASTER_ADDR`, `MASTER_PORT`,
    `WORLD_SIZE`, `RANK`, `LOCAL_RANK`). `coordinator_address` is
    "host:port" (a `tcp://` store) or a full init URL such as
    `file:///tmp/store`. The process is pinned to `device`, by default
    `cuda:{LOCAL_RANK % device_count()}`; the tests pass "cpu". Unless
    `backend` is given, the ranks meet at the store, exchange their
    `device_identity` and take `transport_backend`'s answer. Every
    collective of the group gives up after `COLLECTIVE_TIMEOUT_S`.

    Returns the pinned device.
    """
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    rank, world = int(process_id), int(num_processes)
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            local_rank = int(env.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend == "nccl":
        _check_nccl(device)
    address = str(coordinator_address)
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    store, _, _ = next(dist.rendezvous(
        address if "://" in address else f"tcp://{address}",
        rank, world, timeout=timeout,
    ))
    store.set_timeout(timeout)
    if backend is None:
        seen = dist.PrefixStore("xfmr_rec/device", store)
        seen.set(str(rank), device_identity(device) or "")
        backend = transport_backend(
            [seen.get(str(r)).decode() or None for r in range(world)]
        )
        if backend == "nccl":
            _check_nccl(device)
    dist.init_process_group(
        backend, store=store, world_size=world, rank=rank, timeout=timeout
    )
    return device


def _check_nccl(device: torch.device) -> None:
    """NCCL that cannot start raises (it never becomes gloo)."""
    if device.type != "cuda":
        msg = f"backend='nccl' needs a CUDA device, got {device}"
        raise ValueError(msg)
    if not dist.is_nccl_available():
        msg = "backend='nccl' asked for, but this torch has no NCCL"
        raise RuntimeError(msg)


def shutdown_distributed() -> None:
    """Leave the process group (a later `initialize_distributed` starts a
    fresh one)."""
    if is_distributed():
        dist.destroy_process_group()


def describe_transport() -> str:
    """The group's backend and how CUDA tensors travel over it."""
    if not is_distributed():
        return "no process group (one controller: device copies)"
    backend = dist.get_backend()
    if backend == "gloo":
        return "gloo, CUDA tensors staged through host memory"
    return f"{backend}, on the card"


# -- the mesh ----------------------------------------------------------------
class Mesh:
    """A (data, model) grid of slots.

    `devices` is the numpy object grid of torch devices, `owners` the
    grid of the processes that hold them (all 0 for one controller),
    `shape` the axis sizes as a dict (read as JAX's `mesh.shape` is
    read), `size` the slot count. `group` is the process group the mesh
    spans (None for one controller).
    """

    def __init__(
        self,
        devices: np.ndarray,
        owners: np.ndarray | None = None,
        *,
        group=None,
        row_groups: dict | None = None,
    ) -> None:
        if devices.ndim != 2 or devices.size == 0:
            msg = f"mesh devices must be a non-empty 2-D grid, got {devices.shape}"
            raise ValueError(msg)
        self.devices = devices
        self.owners = (
            np.zeros(devices.shape, dtype=np.int64) if owners is None else owners
        )
        self.group = group
        self.rank = dist.get_rank() if group is not None else 0
        self._row_groups = row_groups or {}

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
    def process_count(self) -> int:
        """Processes whose slots the mesh holds."""
        return int(self.owners.max()) + 1

    def is_local(self, i: int, j: int) -> bool:
        """Slot (i, j) belongs to this process."""
        return int(self.owners[i, j]) == self.rank

    def local_slots(self) -> list[tuple[int, int]]:
        """(data, model) coordinates of this process's slots, in batch
        order."""
        model = self.shape[MODEL_AXIS]
        return [divmod(f, model) for f in self.local_indices()]

    def local_indices(self) -> list[int]:
        """Batch-order (flat) indices of this process's slots."""
        return [
            f for f, owner in enumerate(self.owners.reshape(-1))
            if int(owner) == self.rank
        ]

    @property
    def lead(self) -> torch.device:
        """This process's first device: it holds merged results and the
        optimizer."""
        return self.devices.reshape(-1)[self.local_indices()[0]]

    def row_lead(self, i: int) -> torch.device:
        """Where this process merges data row i: its first slot of the
        row (the row's first device for one controller)."""
        for j in range(self.shape[MODEL_AXIS]):
            if self.is_local(i, j):
                return self.devices[i, j]
        return self.lead

    def holds_row(self, i: int) -> bool:
        """This process has a slot in data row i."""
        return bool((self.owners[i] == self.rank).any())

    def owns_row(self, i: int) -> bool:
        """This process holds slot (i, 0): it hands row i's result on."""
        return self.is_local(i, 0)

    def row_group(self, i: int):
        """The process group of data row i's processes; None where the
        row lies inside one process (its merge is local)."""
        return self._row_groups.get(i)

    def flat(self) -> list[torch.device]:
        """Every slot's device in batch order: data-major, then model."""
        return list(self.devices.reshape(-1))

    def distinct(self) -> list[torch.device]:
        """Each of this process's devices once, in batch order (a virtual
        mesh has one)."""
        flat = self.flat()
        out: list[torch.device] = []
        for f in self.local_indices():
            if flat[f] not in out:
                out.append(flat[f])
        return out

    def __repr__(self) -> str:
        slots = [
            f"p{int(o)}:{d}" if self.group is not None else str(d)
            for o, d in zip(self.owners.reshape(-1), self.flat(), strict=True)
        ]
        return f"Mesh({self.shape}, devices={slots})"


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
    repeat a device (a virtual mesh). Under a process group `devices`
    lists this process's slots (default: its pinned card) and the mesh
    spans every process's, process-major.
    """
    if is_distributed():
        return _process_mesh(n_devices, model_parallel, devices)
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


def _indexed(device: torch.device) -> torch.device:
    """A bare "cuda" as the card this process is pinned to."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _process_mesh(
    n_devices: int | None,
    model_parallel: int,
    devices: Sequence[str | torch.device] | None,
) -> Mesh:
    """The mesh over every process of the group: one all-gather of each
    process's slots, laid out process-major, and a process group for each
    data row that spans processes (every process creates every group, in
    row order, as `new_group` requires)."""
    if devices is None:
        if not torch.cuda.is_available():
            msg = "create_mesh under a process group: pass devices= (no card)"
            raise ValueError(msg)
        devices = ["cuda"]
    local = [str(_indexed(torch.device(d))) for d in devices]
    if not local:
        msg = "create_mesh: this process has no slots"
        raise ValueError(msg)
    every: list[list[str] | None] = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    slots = [(p, name) for p, names in enumerate(every) for name in names]
    total = len(slots)
    if n_devices not in (None, total):
        msg = (
            f"create_mesh under a process group spans every process's slots "
            f"({total}); got {n_devices=}"
        )
        raise ValueError(msg)
    if total % model_parallel:
        msg = f"{total} slots not divisible by {model_parallel=}"
        raise ValueError(msg)
    shape = (total // model_parallel, model_parallel)
    grid = np.empty(total, dtype=object)
    grid[:] = [torch.device(name) for _, name in slots]
    owners = np.array([p for p, _ in slots], dtype=np.int64).reshape(shape)
    made: dict[tuple[int, ...], object] = {}
    row_groups = {}
    world = tuple(range(dist.get_world_size()))
    for i in range(shape[0]):
        members = tuple(sorted({int(o) for o in owners[i]}))
        if len(members) == 1:
            continue
        if members not in made:
            made[members] = (
                dist.group.WORLD if members == world
                else dist.new_group(list(members))
            )
        row_groups[i] = made[members]
    return Mesh(
        grid.reshape(shape), owners, group=dist.group.WORLD, row_groups=row_groups
    )


def split_rows(value: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """`parts` equal chunks of the leading axis (it must divide)."""
    if value.shape[0] % parts:
        msg = f"leading axis {value.shape[0]} not divisible by {parts} devices"
        raise ValueError(msg)
    return list(torch.split(value, value.shape[0] // parts))


def shard_batch(
    batch: dict[str, np.ndarray | torch.Tensor], mesh: Mesh
) -> list[dict[str, torch.Tensor]]:
    """A host batch as per-slot row chunks: entry i holds every field's
    i-th chunk of its leading axis, on `mesh.flat()[i]` (the leading axis
    split over every mesh axis, data-major, as the reference's
    `P((DATA_AXIS, MODEL_AXIS))`). Every process passes the global batch
    and places only its own slots' chunks; other processes' chunks stay
    where the batch is (views), so each process still holds the whole
    batch."""
    devices = mesh.flat()
    mine = set(mesh.local_indices())
    shards: list[dict[str, torch.Tensor]] = [{} for _ in devices]
    for key, value in batch.items():
        tensor = torch.as_tensor(np.ascontiguousarray(value)) if isinstance(
            value, np.ndarray
        ) else value
        for i, (shard, chunk) in enumerate(
            zip(shards, split_rows(tensor, len(devices)), strict=True)
        ):
            shard[key] = chunk.to(devices[i]) if i in mine else chunk
    return shards


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """The parameters on the lead device (the replicated layout; other
    devices get copies at each step, `parallel/train.py`)."""
    return module.to(mesh.lead)


# -- collectives: the only cross-device traffic of the sharded paths ------
# element types a collective carries (their index travels in the header)
_DTYPES = (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8,
    torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool,
)
_MAX_DIMS = 6


def _comm_device(group) -> torch.device:
    """Where `group`'s collectives take their tensors: host memory under
    gloo, else (NCCL) the card this process is pinned to."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _all_gather(
    local: torch.Tensor | None, group, device: torch.device
) -> list[torch.Tensor | None]:
    """Every member's `local` (None: it gives nothing), in rank order, on
    `device`. Two collectives: a fixed header (byte count, type, shape),
    then the bytes padded to the longest, so members may give tensors of
    other shapes or none."""
    comm = _comm_device(group)
    header = torch.full((3 + _MAX_DIMS,), -1, dtype=torch.int64)
    if local is not None:
        if local.dim() > _MAX_DIMS:
            msg = f"collectives carry at most {_MAX_DIMS} dims, got {local.dim()}"
            raise ValueError(msg)
        header[0] = local.numel() * local.element_size()
        header[1] = _DTYPES.index(local.dtype)
        header[2] = local.dim()
        header[3 : 3 + local.dim()] = torch.tensor(local.shape, dtype=torch.int64)
    members = dist.get_world_size(group)
    headers = [torch.empty_like(header, device=comm) for _ in range(members)]
    dist.all_gather(headers, header.to(comm), group=group)
    table = torch.stack(headers).cpu().tolist()
    width = max(max(row[0] for row in table), 1)
    payload = torch.zeros(width, dtype=torch.uint8, device=comm)
    if local is not None and local.numel():
        payload[: table[dist.get_rank(group)][0]] = (
            local.detach().contiguous().reshape(-1).view(torch.uint8).to(comm)
        )
    received = [torch.empty_like(payload) for _ in range(members)]
    dist.all_gather(received, payload, group=group)
    out: list[torch.Tensor | None] = []
    for row, data in zip(table, received, strict=True):
        if row[0] < 0:
            out.append(None)
            continue
        shape = row[3 : 3 + row[2]]
        out.append(data[: row[0]].view(_DTYPES[row[1]]).reshape(shape).to(device))
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather along the leading axis with autograd. The backward
    hands each part its own rows of the gradient and adds nothing from
    other members: every member computes the same loss on the gathered
    rows, so its gradient for its own rows is already the whole one (a
    summing backward would count the members twice over once the
    parameter gradients are summed)."""

    @staticmethod
    def forward(ctx, device, group, *parts):
        local = torch.cat([p.to(device) for p in parts]) if parts else None
        gathered = _all_gather(local, group, device)
        rank = dist.get_rank(group)
        ctx.offset = sum(g.shape[0] for g in gathered[:rank] if g is not None)
        ctx.sizes = [p.shape[0] for p in parts]
        ctx.devices = [p.device for p in parts]
        return torch.cat([g for g in gathered if g is not None])

    @staticmethod
    def backward(ctx, grad):
        mine = grad[ctx.offset : ctx.offset + sum(ctx.sizes)]
        pieces = torch.split(mine, ctx.sizes) if ctx.sizes else ()
        return (
            None,
            None,
            *(g.to(d) for g, d in zip(pieces, ctx.devices, strict=True)),
        )


def gather_rows(
    parts: Sequence[torch.Tensor], device: torch.device, group=None
) -> torch.Tensor:
    """All-gather along the leading axis onto `device`, in part order
    (then member order under `group`; autograd flows back to the parts)."""
    if group is None:
        return torch.cat([p.to(device) for p in parts], dim=0)
    return _GatherRows.apply(device, group, *parts)


def gather_columns(
    parts: Sequence[torch.Tensor], device: torch.device, group=None
) -> torch.Tensor:
    """All-gather over the model axis onto `device`: (B, w) parts ->
    (B, m * w), shard-major (the reference's `all_gather` +
    `transpose(1, 0, 2).reshape(B, -1)`)."""
    if group is None:
        return torch.cat([p.to(device) for p in parts], dim=1)
    local = torch.cat([p.to(device) for p in parts], dim=1) if parts else None
    return torch.cat(
        [g for g in _all_gather(local, group, device) if g is not None], dim=1
    )


def _fold(parts: Sequence[torch.Tensor], device: torch.device, op):
    out = parts[0].to(device) if parts else None
    for part in parts[1:]:
        out = op(out, part.to(device))
    return out


def _all_reduce(
    value: torch.Tensor, group, device: torch.device, op
) -> torch.Tensor:
    """One all-reduce of every member's `value` (all of one shape); every
    member receives the same reduced bits, on `device`."""
    out = value.to(_comm_device(group), copy=True)
    dist.all_reduce(out, op=op, group=group)
    return out.to(device)


def pmax(
    parts: Sequence[torch.Tensor], device: torch.device, group=None
) -> torch.Tensor:
    """Elementwise max over the parts, on `device` (then over `group`)."""
    out = _fold(parts, device, torch.maximum)
    if group is None:
        return out
    return _all_reduce(out, group, device, dist.ReduceOp.MAX)


def sum_to(
    parts: Sequence[torch.Tensor], device: torch.device, group=None
) -> torch.Tensor:
    """Sum of the parts on `device`, in part order, then over `group`, so
    every member holds the same bits (the gradient all-reduce)."""
    out = _fold(parts, device, torch.add)
    if group is None:
        return out
    return _all_reduce(out, group, device, dist.ReduceOp.SUM)


def process_allgather(value, *, tiled: bool = False):
    """Every process's `value`, stacked on a new leading axis in rank
    order (`tiled`: concatenated along axis 0), as
    `jax.experimental.multihost_utils.process_allgather` gathers
    host-local values. A numpy value comes back as numpy; without a
    process group the value is this process's alone."""
    as_numpy = isinstance(value, np.ndarray)
    tensor = torch.from_numpy(np.ascontiguousarray(value)) if as_numpy else value
    if is_distributed():
        parts = _all_gather(tensor, dist.group.WORLD, tensor.device)
    else:
        parts = [tensor]
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.numpy() if as_numpy else out


def any_process(flag: bool, mesh: Mesh) -> bool:
    """True in every process of `mesh` when `flag` holds in any (a
    decision every member must take alike, such as stopping)."""
    value = torch.tensor([flag], dtype=torch.bool)
    return bool(pmax([value], torch.device("cpu"), mesh.group)[0])


def barrier(mesh: Mesh | None = None) -> None:
    """Wait for every process of `mesh` (nothing for one controller), or
    with no mesh for every process of the group (nothing without one)."""
    if mesh is None:
        if is_distributed():
            dist.barrier()
    elif mesh.group is not None:
        dist.barrier(group=mesh.group)
