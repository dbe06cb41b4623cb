"""The single-card train step replayed from CUDA graphs, a set per shape.

A MiniLM step launches hundreds of small operations, and the host's
launches, not the card, set its pace. `StepGraphs` records the step once
for each batch shape and replays it, so that each phase is one graph launch:

- forward: `compute_batch_losses` over the three towers (the loss
  family, or the train loss alone);
- backward: of `train_loss` only, as the eager step differentiates it;
- optimizer: `optimizer_update` (each missing gradient filled with
  zeros, `global_norm`, AdamW).

Each replay runs inside the span of its phase (`train.forward`,
`train.backward`, `train.optimizer`), a graphed step inside
`train.graphed` and a capture inside `train.capture`.

The same work and the same draws. The dropout masks stay draws from the
state's generator at the full `max_length` shape: the forward graph
registers the generator, so each replay advances it as an eager step
does, and a capture advances it not at all. The warm-up before a capture
(one eager forward and backward on the capture stream, which starts the
libraries' lazy state) draws from a generator of its own and leaves the
gradients unset. AdamW is capturable (`TrainState(capturable=True)`),
its moments are made before the first capture as its first step would
make them, with a float64 step count so that its bias corrections keep
the eager step's float64 precision, and its learning rate is made a
device tensor there, which `set_learning_rate` fills before each
replay.

The inputs. A graph reads fixed addresses, so a shape's set holds static
device inputs. Each step copies the host batch, cut by `run_width`, into
pinned staging and from there to the static inputs, in stream order. The
host writes the staging only once the card has run its last copy (an
event): that wait, at the end of a step, is where the host meets the
card, at most a step ahead.

The outputs. The metrics of a step are copied out of the graphs' static
outputs, so those of step n keep their values after step n+1.

Memory. Every set shares one memory pool. That is safe because a step
replays its set's three graphs in their capture order, with no other
set's replay between them, and whatever a step reads that a graph did
not write in that step (parameters, AdamW's state, the learning rate, the
inputs) lives outside the pool. At most `MAX_SHAPES` sets are kept; the
least recently used is released first.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from xfmr_rec_torch.models.encoder import needs_two_tower
from xfmr_rec_torch.training.module import (
    CAPTURABLE_STEP_DTYPE,
    TrainConfig,
    TrainState,
    compute_batch_losses,
    cut_to_run_width,
    optimizer_update,
    set_learning_rate,
)
from xfmr_rec_torch.utils.profiling import span

# batch shapes whose graphs a state keeps: run widths are multiples of 8
# up to `max_length` (64), so one batch size meets at most 8
MAX_SHAPES = 8


def graphs_engage(
    config: TrainConfig, device: torch.device, *, mesh: bool = False
) -> bool:
    """Whether the train step replays from CUDA graphs: on a card, off a
    mesh, with remat off (`run_layer` sets the generator's state on the
    host) and for the text tower (`needs_two_tower` configs stay eager:
    the history fusion uploads a constant from the host each forward)."""
    return (
        device.type == "cuda"
        and not mesh
        and not config.remat
        and not needs_two_tower(config)
    )


def shape_key(
    batch: dict[str, np.ndarray], names: tuple[str, ...] | None
) -> tuple:
    """The key of a set of graphs: every field's name, shape and dtype,
    and the losses computed."""
    fields = tuple((key, value.shape, value.dtype.str)
                   for key, value in batch.items())
    return fields, names


def _prepare_adamw(optimizer: torch.optim.AdamW) -> None:
    """Before a capture, outside any graph's pool: AdamW's per-parameter
    state as its first step makes it, but for the step count, a float64
    device tensor (`CAPTURABLE_STEP_DTYPE`), and each group's learning
    rate a device tensor, which the graph reads and `set_learning_rate`
    fills."""
    for group in optimizer.param_groups:
        if not torch.is_tensor(group["lr"]):
            group["lr"] = torch.tensor(
                float(group["lr"]), device=group["params"][0].device
            )
        for param in group["params"]:
            state = optimizer.state[param]
            if not state:
                state["step"] = torch.zeros(
                    (), dtype=CAPTURABLE_STEP_DTYPE, device=param.device
                )
                state["exp_avg"] = torch.zeros_like(
                    param, memory_format=torch.preserve_format
                )
                state["exp_avg_sq"] = torch.zeros_like(
                    param, memory_format=torch.preserve_format
                )


class _GraphSet:
    """One batch shape's inputs, graphs and static outputs."""

    def __init__(self, batch: dict[str, np.ndarray], device: torch.device):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        self.staging = {k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True)
                        for k, v in host.items()}
        self.inputs = {k: torch.empty_like(v, device=device)
                       for k, v in host.items()}
        self.staged = torch.cuda.Event()
        self.graphs: tuple[torch.cuda.CUDAGraph, ...] = ()
        self.grads: list[torch.Tensor] = []
        self.names: list[str] = []
        self.out: torch.Tensor | None = None
        self.slots: dict[str, int] = {}

    def upload(self, batch: dict[str, np.ndarray]) -> None:
        for key, value in batch.items():
            self.staging[key].copy_(torch.from_numpy(value))
            self.inputs[key].copy_(self.staging[key], non_blocking=True)
        self.staged.record()

    def capture(
        self,
        state: TrainState,
        names: tuple[str, ...] | None,
        stream: torch.cuda.Stream,
        pool,
    ) -> None:
        config, model = state.config, state.model
        params = list(model.parameters())
        _prepare_adamw(state.optimizer)
        slots = dict(model.token_slots)
        for param in params:
            param.grad = None
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            warm = compute_batch_losses(
                model, self.inputs, config,
                generator=torch.Generator(device=state.device), names=names,
            )
            warm[config.train_loss].backward()
        del warm
        for param in params:
            param.grad = None
        forward, backward, optimizer = (torch.cuda.CUDAGraph()
                                        for _ in range(3))
        forward.register_generator_state(state.generator)
        before = dict(model.token_slots)
        with torch.cuda.graph(forward, pool=pool, stream=stream):
            losses = compute_batch_losses(
                model, self.inputs, config, generator=state.generator,
                names=names,
            )
        self.slots = {k: v - before[k] for k, v in model.token_slots.items()}
        model.token_slots.update(slots)
        train_loss = losses[config.train_loss]
        losses = {name: loss.detach() for name, loss in losses.items()}
        with torch.cuda.graph(backward, pool=pool, stream=stream):
            train_loss.backward()
        del train_loss
        with torch.cuda.graph(optimizer, pool=pool, stream=stream):
            grad_norm = optimizer_update(state)
            self.out = torch.stack([*losses.values(), grad_norm])
        self.graphs = (forward, backward, optimizer)
        # the gradients the graphs write and read, kept alive here once
        # another capture rebinds `param.grad`
        self.grads = [param.grad for param in params]
        self.names = [f"train/{name}" for name in losses] + ["train/grad_norm"]

    def replay(self, state: TrainState) -> dict[str, torch.Tensor]:
        forward, backward, optimizer = self.graphs
        with span("train.forward"):
            forward.replay()
        with span("train.backward"):
            backward.replay()
        with span("train.optimizer"):
            set_learning_rate(state)
            optimizer.replay()
        for key, count in self.slots.items():
            state.model.token_slots[key] += count
        return dict(zip(self.names, self.out.clone(), strict=True))


class StepGraphs:
    """A `TrainState`'s graphs of its train step, by batch shape."""

    def __init__(self, device: torch.device) -> None:
        self._sets: collections.OrderedDict[tuple, _GraphSet] = (
            collections.OrderedDict()
        )
        # every capture runs on this stream, into this pool
        self._stream = torch.cuda.Stream(device)
        self._pool = torch.cuda.graph_pool_handle()

    def __len__(self) -> int:
        return len(self._sets)

    def clear(self) -> None:
        """Release every set (the optimizer's state was replaced)."""
        self._sets.clear()

    def step(
        self,
        state: TrainState,
        batch: dict[str, np.ndarray],
        *,
        log_all_losses: bool = True,
    ) -> tuple[dict[str, torch.Tensor], bool]:
        """One update on a host batch: (the step's metrics, whether this
        shape was captured first)."""
        names = None if log_all_losses else (state.config.train_loss,)
        with span("train.to_device"):
            batch = cut_to_run_width(batch, state.config.pooling_mode)
            key = shape_key(batch, names)
            graphs = self._sets.get(key)
            captured = graphs is None
            if captured:
                graphs = _GraphSet(batch, state.device)
            graphs.upload(batch)
        if captured:
            with span("train.capture"):
                graphs.capture(state, names, self._stream, self._pool)
            self._sets[key] = graphs
            while len(self._sets) > MAX_SHAPES:
                self._sets.popitem(last=False)
        else:
            self._sets.move_to_end(key)
        with span("train.graphed"):
            metrics = graphs.replay(state)
        state.step += 1
        # the host writes this staging again only once the card has run
        # the copy out of it: here the card, a step behind, sets the pace
        graphs.staged.synchronize()
        return metrics, captured
