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
of ceil(vocab / m) rows (the last zero-padded), one per model-axis
device. Each piece is its own parameter, so AdamW keeps its moments
beside it, and the lookup is a masked local gather a piece, summed. The
replicas share the pieces, so their gradients land there directly. Over
processes this needs each model row inside one process (the reference's
layout at `model_parallel=2`): every process then holds all the pieces.
"""

from __future__ import annotations

import copy
from collections.abc import Callable, Sequence

import torch
from torch import nn

from xfmr_rec_torch.models.encoder import Embed, needs_two_tower
from xfmr_rec_torch.ops.losses import compute_losses
from xfmr_rec_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    replicate,
    split_rows,
    sum_to,
)
from xfmr_rec_torch.training import module as train_mod
from xfmr_rec_torch.training.module import TrainConfig, TrainState

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
    value: torch.Tensor, devices: Sequence[torch.device]
) -> list[torch.Tensor]:
    """Row pieces of ceil(rows / m) rows, one on each device, the last
    zero-padded."""
    per = -(-value.shape[0] // len(devices))
    padded = nn.functional.pad(
        value.detach(), (0, 0, 0, per * len(devices) - value.shape[0])
    )
    return [
        padded[j * per : (j + 1) * per].to(dev).clone()
        for j, dev in enumerate(devices)
    ]


class ShardedEmbed(nn.Module):
    """A (vocab, hidden) table split row-wise over devices.

    `pieces[j]` holds rows [j * per, (j + 1) * per) on `devices[j]`,
    per = ceil(vocab / m), the last piece zero-padded. The lookup is
    `Embed`'s: rows gathered in f32 (each piece's masked local gather,
    summed: one term is the row, the others exact zeros), then cast.
    """

    def __init__(self, table: torch.Tensor, devices: Sequence[torch.device]) -> None:
        super().__init__()
        self.num = table.shape[0]
        self.per = -(-self.num // len(devices))
        self.pieces = nn.ParameterList(
            nn.Parameter(piece) for piece in _split_table(table, devices)
        )

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = None
        for j, piece in enumerate(self.pieces):
            local = ids.to(piece.device) - j * self.per
            inside = (local >= 0) & (local < self.per)
            rows = nn.functional.embedding(torch.where(inside, local, 0), piece)
            rows = (rows * inside[..., None]).to(ids.device)
            out = rows if out is None else out + rows
        return out.to(dtype)

    def full(self) -> torch.Tensor:
        """The whole table, gathered on the first piece's device."""
        lead = self.pieces[0].device
        return torch.cat([p.detach().to(lead) for p in self.pieces])[: self.num]


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


def place_state(
    state: TrainState, mesh: Mesh, config: TrainConfig, *, shard_vocab: bool = False
) -> TrainState:
    """Put a TrainState on the mesh: the model on the lead device, and
    with `shard_vocab` every vocab table split over the model axis (its
    AdamW moments split alongside). The optimizer is rebuilt over the new
    parameters."""
    replicate(state.model, mesh)
    state.device = mesh.lead
    for opt_state in state.optimizer.state.values():
        for key, value in opt_state.items():
            if torch.is_tensor(value) and value.dim():
                opt_state[key] = value.to(mesh.lead)
    if not shard_vocab:
        return state
    if any(len(set(row)) > 1 for row in mesh.owners.tolist()):
        msg = (
            "shard_vocab with the model axis across processes is not "
            f"supported (mesh {mesh}); pick model_parallel so that each "
            "model row lies inside one process"
        )
        raise NotImplementedError(msg)
    devices = list(mesh.devices[mesh.local_slots()[0][0]])
    old = state.optimizer
    moved: dict[nn.Parameter, list[nn.Parameter]] = {}
    for parent, attr in _vocab_tables(state.model, config):
        table = getattr(parent, attr).embedding
        sharded = ShardedEmbed(table, devices)
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
            key: _split_table(value, [p.device for p in pieces])
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
    its `<name>.embedding` (the replicated layout the artifact holds)."""
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
        for device, replica, generator in replicas:
            mine = self._chunks_of(device)
            part = {
                key: torch.cat([shards[i][key] for i in mine])
                for key in ("user_tokens", "item_tokens", "neg_item_tokens",
                            *_ROW_INPUTS)
                if key in shards[local[0]]
            }
            index = torch.cat([
                torch.arange(i * chunk, (i + 1) * chunk, device=lead) for i in mine
            ])
            n = index.numel()
            u, it = self._encode_part(
                replica, part, batch["item_idx"], index, rows, generator, device
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
        if group is not None:
            # one all-reduce of every gradient, flattened
            total = sum_to(
                [torch.cat([p.grad.reshape(-1).to(lead) for p in params])],
                lead,
                group,
            )
            for param, grad in zip(
                params, torch.split(total, [p.numel() for p in params]), strict=True
            ):
                param.grad = grad.view_as(param).to(param.device)
        grad_norm = train_mod.global_norm([param.grad for param in params])
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
        call, gathered to the lead in row order."""
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
