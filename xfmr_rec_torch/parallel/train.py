"""Sharded training step: data parallelism + optional vocab sharding.

Port of `xfmr_rec_tpu/parallel/train.py`. The reference's sharded step
is the single-device step over the global batch, with the batch split
over every mesh axis and XLA inserting the gradient all-reduce. The port
keeps that contract with one controller:

1. one model replica per distinct device of the mesh (the lead holds the
   optimizer; a virtual mesh on one device has no other replica);
2. the towers' rows split as `shard_batch` splits them, each device
   encoding its chunks in one pass (its own dropout generator);
3. the embeddings gathered to the lead device in global row order
   (`mesh.gather_rows`; the copies keep autograd);
4. the loss family once on the global batch, one backward;
5. the replicas' gradients summed onto the lead (`mesh.sum_to`), one
   AdamW step, and the parameters copied back to the replicas before the
   next step.

On one distinct device this is the single-device step exactly: the
chunks of every tower form the same (3B, L) pass.

On a mesh that spans processes every process runs this step on its own
slots: one replica per local distinct device, the rows all-gathered over
the group with autograd (every process computes the same loss on the
global batch, and its backward reaches only its own rows), and the
gradients all-reduced over the processes (one `sum_to`), so that every process
holds the single-device gradient, runs the same AdamW step and keeps the
same parameters bit for bit. Dropout on a replica other than the mesh's
first draws from a generator seeded by (seed, step, replica), so a run
resumed from a checkpoint draws what the uninterrupted run drew.

`shard_vocab=True` splits the one tensor that dominates the parameter
count, the (vocab, hidden) token-embedding table, row-wise into m pieces
of ceil(vocab / m) rows (the last zero-padded), one per model column.
Each piece is its own parameter, so AdamW keeps its moments beside it. A
process holds the pieces of the columns it has slots in (on its first
slot of each). Where every process holds every column (one controller,
or each model row inside one process) the lookup is a masked local
gather a piece, summed, and the replicas' gradients land on the pieces
directly. Where a model row crosses processes, a pass first fetches the
rows of the global batch's distinct token ids: the process holding a
column's slot in data row 0 gives its rows, every other process adds
exact zeros, and one f32 all-reduce over the group gives every process
every row bit for bit; the replicas' lookups index those rows. The
backward sums the rows' gradient over the group (one all-reduce: each
process's replicas give their own positions' share) and writes it into
every piece a process holds, so a piece's gradient is the single-device
table's rows, counted once. The pieces stay out of the step's gradient
all-reduce, and the gradient norm counts the summed rows once.
"""

from __future__ import annotations

import contextlib
import copy
from collections.abc import Callable, Sequence

import torch
import torch.distributed as dist
from torch import nn

from xfmr_rec_torch.models.encoder import Embed, needs_two_tower
from xfmr_rec_torch.ops.losses import compute_losses
from xfmr_rec_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    gather_rows,
    replicate,
    split_rows,
    sum_to,
)
from xfmr_rec_torch.training import module as train_mod
from xfmr_rec_torch.training.module import TrainConfig, TrainState

# batch fields that hold token ids (what a sharded table looks up)
_TOKEN_INPUTS = ("user_tokens", "item_tokens", "neg_item_tokens", "hist_tokens")
# batch fields a replica encodes, besides the three towers (all lead
# with the batch axis)
_ROW_INPUTS = (
    "hist_tokens",
    "hist_mask",
    "hist_ratings",
    "hist_rns",
    "bag_rns",
    "bag_ratings",
    "bag_mask",
)


def _split_table(
    value: torch.Tensor, parts: int, devices: dict[int, torch.device]
) -> list[torch.Tensor]:
    """Row pieces of ceil(rows / parts) rows, the last zero-padded: piece
    j on `devices[j]` for each column j of `devices`, in its order."""
    per = -(-value.shape[0] // parts)
    padded = nn.functional.pad(
        value.detach(), (0, 0, 0, per * parts - value.shape[0])
    )
    return [
        padded[j * per : (j + 1) * per].to(dev).clone()
        for j, dev in devices.items()
    ]


class _RowLookup(torch.autograd.Function):
    """A table's f32 rows of the sorted distinct `ids`, summed over its
    group: each column's rows come from the process holding its slot in
    data row 0 and the others add exact zeros, so every process receives
    every row bit for bit. Backward: one all-reduce of the rows' gradient
    (each process's replicas give their own positions' share), written
    into every piece this process holds (the ids are distinct, so each
    piece row receives its summed gradient as it is)."""

    @staticmethod
    def forward(ctx, table, ids, *pieces):
        ctx.table = table
        ctx.save_for_backward(ids)
        out = torch.zeros(len(ids), table.features, device=table.lead)
        for j, piece in zip(table.columns, pieces, strict=True):
            if table.givers[j] == table.rank:
                out += table.take(j, piece, ids).to(table.lead)
        return sum_to([out], table.lead, table.group)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        table = ctx.table
        rows = sum_to([grad.contiguous()], table.lead, table.group)
        # the step's gradient norm counts these rows once
        table.reduced_grad = rows
        grads = []
        for j, piece in zip(table.columns, table.pieces, strict=True):
            local, inside = table.local_ids(j, ids.to(piece.device))
            g = torch.zeros_like(piece)
            g[local[inside]] = rows.to(piece.device)[inside]
            grads.append(g)
        return None, None, *grads


class ShardedEmbed(nn.Module):
    """A (vocab, hidden) table split row-wise over the model columns.

    Column j's piece holds rows [j * per, (j + 1) * per), per =
    ceil(vocab / parts), the last zero-padded; `pieces` holds the pieces
    of `columns`, the columns this process has slots in, each on
    `devices[j]`. The lookup is `Embed`'s: rows gathered in f32, then
    cast. With `group` None (every process holds every column) it is each
    piece's masked local gather, summed (one term is the row, the others
    exact zeros). Under a group a lookup indexes the rows `_fetch_rows`
    fetched for the pass (one collective for every replica), or fetches
    its own ids (a call every process makes alike); `givers[j]` is the
    process that gives column j's rows to the sum.
    """

    def __init__(
        self,
        table: torch.Tensor,
        parts: int,
        devices: dict[int, torch.device],
        *,
        group=None,
        givers: Sequence[int] = (),
        lead: torch.device | None = None,
    ) -> None:
        super().__init__()
        self.num, self.features = table.shape
        self.parts = parts
        self.per = -(-self.num // parts)
        self.columns = list(devices)
        self.pieces = nn.ParameterList(
            nn.Parameter(piece) for piece in _split_table(table, parts, devices)
        )
        self.group = group
        self.givers = list(givers)
        self.rank = dist.get_rank() if group is not None else 0
        self.lead = lead or self.pieces[0].device
        # under a group: (distinct ids, their rows) of the pass, and the
        # rows' gradient summed over the group by the last backward
        self.fetched: tuple[torch.Tensor, torch.Tensor] | None = None
        self.reduced_grad: torch.Tensor | None = None

    def local_ids(self, j: int, ids: torch.Tensor):
        """(ids as rows of column j's piece, clipped to 0 outside it; the
        mask of those inside)."""
        local = ids - j * self.per
        inside = (local >= 0) & (local < self.per)
        return torch.where(inside, local, 0), inside

    def take(self, j: int, piece: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Column j's masked gather: its rows of `ids`, zeros elsewhere."""
        local, inside = self.local_ids(j, ids.to(piece.device))
        return nn.functional.embedding(local, piece) * inside[..., None]

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.group is None:
            out = None
            for j, piece in zip(self.columns, self.pieces, strict=True):
                rows = self.take(j, piece, ids).to(ids.device)
                out = rows if out is None else out + rows
            return out.to(dtype)
        distinct, rows = self.fetched or _fetch_rows(self, ids)
        flat = ids.reshape(-1).to(distinct.device)
        pos = torch.searchsorted(distinct, flat).clamp_(max=len(distinct) - 1)
        if not torch.equal(distinct[pos], flat):
            msg = "a sharded table was asked for ids its pass did not fetch"
            raise RuntimeError(msg)
        out = nn.functional.embedding(pos.reshape(ids.shape), rows)
        return out.to(ids.device).to(dtype)

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole (vocab, ...) tensor on the lead from `parts`, one for
        each of `pieces` (the pieces or their AdamW moments). Under a group
        every process calls it: each gives the columns it gives to the
        lookup, gathered over the group."""
        if self.group is None:
            return torch.cat([p.detach().to(self.lead) for p in parts])[: self.num]
        mine = [
            part.detach()
            for j, part in zip(self.columns, parts, strict=True)
            if self.givers[j] == self.rank
        ]
        with torch.no_grad():
            gathered = gather_rows(mine, self.lead, self.group)
        # member order, then column order within a member
        order = sorted(range(self.parts), key=lambda j: (self.givers[j], j))
        by_column = dict(zip(order, torch.split(gathered, self.per), strict=True))
        return torch.cat([by_column[j] for j in range(self.parts)])[: self.num]

    def full(self) -> torch.Tensor:
        """The whole table on the lead device (under a group every process
        calls it)."""
        return self.gather(list(self.pieces))


def _fetch_rows(
    table: ShardedEmbed, ids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(the sorted distinct `ids`, their f32 rows), from one collective
    over the table's group (every process passes the same ids)."""
    distinct = torch.unique(ids.reshape(-1).to(table.lead).long())
    return distinct, _RowLookup.apply(table, distinct, *table.pieces)


@contextlib.contextmanager
def _fetched(model: nn.Module, ids: torch.Tensor):
    """Within the block every cross-process table of `model` looks up
    the rows of `ids`, fetched once (one collective for every replica,
    so the processes stay in step whatever devices each holds)."""
    tables = _collective_tables(model)
    for table in tables:
        table.fetched = _fetch_rows(table, ids)
    try:
        yield
    finally:
        for table in tables:
            table.fetched = None


def _collective_tables(model: nn.Module) -> list[ShardedEmbed]:
    """The tables whose lookup sums over a process group."""
    return [
        m for m in model.modules()
        if isinstance(m, ShardedEmbed) and m.group is not None
    ]


class _SharedEmbed(nn.Module):
    """A replica's view of the lead's `ShardedEmbed`, kept out of the
    replica's parameters (the pieces stay where they are)."""

    def __init__(self, shared: ShardedEmbed) -> None:
        super().__init__()
        self._shared = (shared,)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self._shared[0](ids, dtype)


def _children(model: nn.Module, keep) -> list[tuple[nn.Module, str]]:
    """(parent, attribute) of every submodule for which
    `keep(qualified name, module)` holds."""
    return [
        (parent, attr)
        for name, parent in model.named_modules()
        for attr, child in parent.named_children()
        if keep(f"{name}.{attr}" if name else attr, child)
    ]


def _vocab_tables(model: nn.Module, config: TrainConfig) -> list[tuple[nn.Module, str]]:
    """Every vocab-row table under a `word_embed` (the reference shards
    each (vocab, ...) leaf there: the dense table, or the hash mode's
    importances)."""
    return _children(model, lambda name, child: (
        isinstance(child, Embed)
        and "word_embed" in name
        and child.embedding.shape[0] == config.vocab_size
    ))


def _sharded_children(model: nn.Module) -> list[tuple[nn.Module, str]]:
    return _children(model, lambda _, child: isinstance(child, ShardedEmbed))


def _vocab_layout(mesh: Mesh):
    """(this process's device for each model column it has slots in, its
    first slot's; the group a lookup sums over, None where every process
    holds every column; the process giving each column's rows: its slot
    in data row 0)."""
    devices: dict[int, torch.device] = {}
    for i, j in sorted(mesh.local_slots(), key=lambda slot: (slot[1], slot[0])):
        devices.setdefault(j, mesh.devices[i, j])
    everywhere = all(
        len(set(column.tolist())) == mesh.process_count for column in mesh.owners.T
    )
    group = None if everywhere else mesh.group
    return devices, group, [int(o) for o in mesh.owners[0]]


def place_state(
    state: TrainState, mesh: Mesh, config: TrainConfig, *, shard_vocab: bool = False
) -> TrainState:
    """Put a TrainState on the mesh: the model on the lead device, and
    with `shard_vocab` every vocab table split over the model axis (its
    AdamW moments split alongside), this process keeping the pieces of
    the columns it has slots in. The optimizer is rebuilt over the new
    parameters."""
    replicate(state.model, mesh)
    state.device = mesh.lead
    for opt_state in state.optimizer.state.values():
        for key, value in opt_state.items():
            if torch.is_tensor(value) and value.dim():
                opt_state[key] = value.to(mesh.lead)
    if not shard_vocab:
        return state
    devices, lookup_group, givers = _vocab_layout(mesh)
    old = state.optimizer
    moved: dict[nn.Parameter, list[nn.Parameter]] = {}
    for parent, attr in _vocab_tables(state.model, config):
        table = getattr(parent, attr).embedding
        sharded = ShardedEmbed(
            table, mesh.shape[MODEL_AXIS], devices,
            group=lookup_group, givers=givers, lead=mesh.lead,
        )
        setattr(parent, attr, sharded)
        moved[table] = list(sharded.pieces)
    group = old.param_groups[0]
    new = torch.optim.AdamW(
        state.model.parameters(),
        lr=group["lr"],
        betas=group["betas"],
        eps=group["eps"],
        weight_decay=group["weight_decay"],
    )
    for param, saved in old.state.items():
        if param not in moved:
            new.state[param] = saved
            continue
        pieces = moved[param]
        split = {
            key: _split_table(value, mesh.shape[MODEL_AXIS], devices)
            for key, value in saved.items()
            if torch.is_tensor(value) and value.dim()
        }
        for j, piece in enumerate(pieces):
            # each piece its own step count: AdamW bumps it in place
            new.state[piece] = {
                key: split[key][j] if key in split else (
                    value.clone() if torch.is_tensor(value) else value
                )
                for key, value in saved.items()
            }
    state.optimizer = new
    return state


def gathered_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """`model.state_dict()` with every `ShardedEmbed` gathered back into
    its `<name>.embedding` (the replicated layout the artifact holds).
    Under a group every process calls it and receives the whole tables."""
    sharded = {
        name: mod for name, mod in model.named_modules()
        if isinstance(mod, ShardedEmbed)
    }
    out: dict[str, torch.Tensor] = {}
    for key, value in model.state_dict().items():
        owner = next(
            (n for n in sharded if key.startswith(f"{n}.pieces.")), None
        )
        if owner is None:
            out[key] = value
        elif f"{owner}.embedding" not in out:
            out[f"{owner}.embedding"] = sharded[owner].full()
    return out


def unsharded_state(state: TrainState) -> tuple[dict, dict]:
    """(the model's, the optimizer's state dict) in the layout of an
    unsharded run: every sharded table and its AdamW moments whole (the
    step count of its first piece; every piece keeps the same count).
    Under a group every process calls it. A fresh `TrainState` loads
    both, and `place_state` splits them again."""
    tables = {
        id(p): table for table in state.model.modules()
        if isinstance(table, ShardedEmbed) for p in table.pieces
    }
    optimizer = state.optimizer
    if not tables:
        return state.model.state_dict(), optimizer.state_dict()
    entries: list[dict] = []
    done: set[int] = set()
    for param in optimizer.param_groups[0]["params"]:
        table = tables.get(id(param))
        if table is None:
            entries.append(optimizer.state.get(param, {}))
        elif id(table) not in done:
            done.add(id(table))
            saved = [optimizer.state.get(p, {}) for p in table.pieces]
            entries.append({
                key: table.gather([s[key] for s in saved])
                if torch.is_tensor(value) and value.dim() else value
                for key, value in saved[0].items()
            })
    group = {
        key: value for key, value in optimizer.param_groups[0].items()
        if key != "params"
    }
    return gathered_state_dict(state.model), {
        "state": {i: entry for i, entry in enumerate(entries) if entry},
        "param_groups": [{**group, "params": list(range(len(entries)))}],
    }


class ShardedTrainStep:
    """The sharded train step: `step(state, shards)` -> metrics, with
    `shards` from `parallel.mesh.shard_batch`. `encode` runs a
    deterministic tower over rows split the same way (the eval pass)."""

    def __init__(
        self,
        config: TrainConfig,
        mesh: Mesh,
        *,
        log_all_losses: bool = True,
    ) -> None:
        self.config = config
        self.mesh = mesh
        self.log_all_losses = log_all_losses
        self._lead_model: nn.Module | None = None
        self._replicas: list[tuple[torch.device, nn.Module, torch.Generator]] = []
        self._lead_generator: torch.Generator | None = None

    # -- replicas ------------------------------------------------------
    def _replicas_of(self, state: TrainState):
        """(device, model, generator) a distinct device of this process,
        its lead first; the other replicas get the lead's parameters."""
        if self._lead_model is not state.model:
            shared = {
                id(m): m for m in state.model.modules() if isinstance(m, ShardedEmbed)
            }
            self._replicas = []
            seed = state.generator.initial_seed()
            for k, device in enumerate(self.mesh.distinct()[1:], start=1):
                replica = copy.deepcopy(state.model, memo=dict(shared))
                for parent, attr in _sharded_children(replica):
                    setattr(parent, attr, _SharedEmbed(getattr(parent, attr)))
                replica.to(device)
                generator = torch.Generator(device=device).manual_seed(seed + k)
                self._replicas.append((device, replica, generator))
            self._lead_generator = state.generator
            if self.mesh.rank:
                self._lead_generator = torch.Generator(device=self.mesh.lead)
            self._lead_model = state.model
        lead = {name: p for name, p in state.model.named_parameters()}
        with torch.no_grad():
            for _, replica, _ in self._replicas:
                for name, param in replica.named_parameters():
                    param.copy_(lead[name])
        return [(self.mesh.lead, state.model, self._lead_generator),
                *self._replicas]

    def _reseed(self, state: TrainState, replicas) -> None:
        """Under a process group: every replica but the mesh's first
        draws dropout from (seed, step, its index over the processes),
        which a resumed run reproduces."""
        seed = state.generator.initial_seed()
        first = self._first_replica_index()
        for k, (_, _, generator) in enumerate(replicas):
            index = first + k
            if index:
                generator.manual_seed(
                    (seed * 1_000_003 + state.step * 7_919 + index) % (1 << 63)
                )

    def _first_replica_index(self) -> int:
        """How many distinct (process, device) replicas precede this
        process's."""
        owners = self.mesh.owners.reshape(-1).tolist()
        seen = {
            (owner, str(device))
            for owner, device in zip(owners, self.mesh.flat(), strict=True)
            if owner < self.mesh.rank
        }
        return len(seen)

    def _chunks_of(self, device: torch.device) -> list[int]:
        flat = self.mesh.flat()
        return [i for i in self.mesh.local_indices() if flat[i] == device]

    # -- the step --------------------------------------------------------
    def __call__(
        self, state: TrainState, shards: Sequence[dict[str, torch.Tensor]]
    ) -> dict[str, torch.Tensor]:
        config = self.config
        lead, group = self.mesh.lead, self.mesh.group
        local = self.mesh.local_indices()
        names = None if self.log_all_losses else (config.train_loss,)
        # every process holds the global batch (`shard_batch`)
        batch = {
            key: gather_rows([shard[key] for shard in shards], lead)
            for key in shards[0]
        }
        rows = batch["user_tokens"].shape[0]
        chunk = rows // len(shards)
        replicas = self._replicas_of(state)
        if group is not None:
            self._reseed(state, replicas)
        lr = train_mod.learning_rate_at(config, state.step)
        for param_group in state.optimizer.param_groups:
            param_group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        for _, replica, _ in replicas[1:]:
            replica.zero_grad(set_to_none=True)
        users: list[torch.Tensor | None] = [None] * len(shards)
        pos: list[torch.Tensor | None] = [None] * len(shards)
        neg: list[torch.Tensor | None] = [None] * len(shards)
        tables = _collective_tables(state.model)
        for table in tables:
            table.reduced_grad = None
        token_ids = torch.cat(
            [batch[key].reshape(-1) for key in _TOKEN_INPUTS if key in batch]
        )
        with _fetched(state.model, token_ids):
            for device, replica, generator in replicas:
                mine = self._chunks_of(device)
                part = {
                    key: torch.cat([shards[i][key] for i in mine])
                    for key in ("user_tokens", "item_tokens", "neg_item_tokens",
                                *_ROW_INPUTS)
                    if key in shards[local[0]]
                }
                index = torch.cat([
                    torch.arange(i * chunk, (i + 1) * chunk, device=lead)
                    for i in mine
                ])
                n = index.numel()
                u, it = self._encode_part(
                    replica, part, batch["item_idx"], index, rows, generator,
                    device,
                )
                for slot, i in enumerate(mine):
                    piece = slice(slot * chunk, (slot + 1) * chunk)
                    users[i] = u[piece]
                    pos[i] = it[:n][piece]
                    neg[i] = it[n:][piece]
        user_embed = gather_rows([users[i] for i in local], lead, group)
        item_embed = torch.cat([
            gather_rows([pos[i] for i in local], lead, group),
            gather_rows([neg[i] for i in local], lead, group),
        ])
        losses = compute_losses(
            user_embed,
            item_embed,
            batch["target"],
            item_idx=batch["item_idx"],
            pos_idx=batch["pos_idx"],
            config=train_mod.loss_config(config),
            log_q=batch.get("log_q"),
            names=names,
        )
        losses[config.train_loss].backward()
        lead_params = dict(state.model.named_parameters())
        for _, replica, _ in replicas[1:]:
            for name, param in replica.named_parameters():
                if param.grad is None:
                    continue
                mine = lead_params[name]
                parts = [param.grad] if mine.grad is None else [mine.grad, param.grad]
                mine.grad = sum_to(parts, lead)
        params = list(state.model.parameters())
        for param in params:
            if param.grad is None:
                param.grad = torch.zeros_like(param)
        # a cross-process table's pieces already hold the summed gradient
        whole = {id(p): table for table in tables for p in table.pieces}
        summed = [p for p in params if id(p) not in whole]
        if group is not None:
            # one all-reduce of every other gradient, flattened
            total = sum_to(
                [torch.cat([p.grad.reshape(-1).to(lead) for p in summed])],
                lead,
                group,
            )
            for param, grad in zip(
                summed, torch.split(total, [p.numel() for p in summed]), strict=True
            ):
                param.grad = grad.view_as(param).to(param.device)
        # each table counted once, in its place: its rows' summed gradient
        terms, counted = [], set()
        for param in params:
            table = whole.get(id(param))
            if table is None:
                terms.append(param.grad)
            elif id(table) not in counted and table.reduced_grad is not None:
                counted.add(id(table))
                terms.append(table.reduced_grad)
        grad_norm = train_mod.global_norm(terms)
        state.optimizer.step()
        state.step += 1
        metrics = {f"train/{name}": loss.detach() for name, loss in losses.items()}
        metrics["train/grad_norm"] = grad_norm
        return metrics

    def _encode_part(self, model, part, item_idx, index, rows, generator, device):
        """One replica's pass over its rows: (user (n, d), items (2n, d),
        positives then negatives), on the lead device."""
        towers = (part["user_tokens"], part["item_tokens"], part["neg_item_tokens"])
        n = towers[0].shape[0]
        if needs_two_tower(self.config):
            inputs = {key: part[key] for key in _ROW_INPUTS if key in part}
            inputs = train_mod._two_tower_inputs(
                {**inputs, "item_idx": torch.cat([
                    item_idx[index], item_idx[rows + index]
                ]).to(device)},
                self.config,
            )
            user, items = model.train_embeds(*towers, generator=generator, **inputs)
        else:
            embeds = model(torch.cat(towers), generator)
            user, items = embeds[:n], embeds[n:]
        return user.to(self.mesh.lead), items.to(self.mesh.lead)

    # -- eval encoding -----------------------------------------------------
    @torch.no_grad()
    def encode(
        self,
        state: TrainState,
        fn: Callable[..., torch.Tensor],
        *rows: torch.Tensor,
    ) -> torch.Tensor:
        """`fn(model, *row_chunks)` over rows split like a batch (zero
        rows pad the batch to the mesh size), each device's chunks in one
        call, gathered to the lead in row order. The first of `rows` holds
        the token ids a sharded table looks up (fetched once under a
        group)."""
        size = self.mesh.size
        local = self.mesh.local_indices()
        count = rows[0].shape[0]
        pad = -count % size
        if pad:
            rows = tuple(
                torch.cat([r, r.new_zeros((pad, *r.shape[1:]))]) for r in rows
            )
        split = [split_rows(r, size) for r in rows]
        chunk = (count + pad) // size
        outs: list[torch.Tensor | None] = [None] * size
        with _fetched(state.model, rows[0]):
            for device, replica, _ in self._replicas_of(state):
                mine = self._chunks_of(device)
                part = [torch.cat([s[i] for i in mine]).to(device) for s in split]
                out = fn(replica, *part).to(self.mesh.lead)
                for slot, i in enumerate(mine):
                    outs[i] = out[slot * chunk : (slot + 1) * chunk]
        out = gather_rows([outs[i] for i in local], self.mesh.lead, self.mesh.group)
        return out[:count]


def make_sharded_train_step(
    config: TrainConfig,
    mesh: Mesh,
    *,
    shard_vocab: bool = False,
    state: TrainState | None = None,
    log_all_losses: bool = True,
) -> ShardedTrainStep:
    """The sharded step over `mesh`. Inputs: the state placed by
    `place_state` and the batch split by `parallel.mesh.shard_batch`.
    `state` is required with shard_vocab=True (as in the reference): it
    is placed here when its tables are not split yet."""
    if shard_vocab:
        if state is None:
            msg = "shard_vocab=True needs `state` to derive output shardings"
            raise ValueError(msg)
        if not _sharded_children(state.model) and _vocab_tables(state.model, config):
            place_state(state, mesh, config, shard_vocab=True)
    return ShardedTrainStep(config, mesh, log_all_losses=log_all_losses)
