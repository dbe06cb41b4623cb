"""Training the text tower, step after step, as `Trainer.fit` drives it.

Set-up writes a seeded MovieLens-1M-like corpus (`users`, `movies`,
`ratings` asked) under the run's temporary directory, builds the port's
`Trainer` on it (the configuration's model and loss, `batch` users a
step, dropout on) and runs `Trainer.setup()`: the port's ETL,
tokenization and train state. The encoder's weights are then replaced by
the benchmark's seeded weights, drawn on the card. Set-up drives the
first `warmup_steps` steps through the window's own calls: the next batch
of `trainer.data.train_batches(epoch)`, `trainer.train_step(batch)`, the
metrics logged every `log_every_steps`. The window goes on with the same
trainer, the same iterator and the same calls until `--seconds` have
passed, and ends on a synchronise. The mix's `metric` (the throughput's
name in BENCHMARK.json) is the rows (user, positive, sampled negative)
trained over the window's wall time.

The check follows the first `check_steps` steps with the plain
reference, in float32 from the same weights, on the same rows (each
batch's tensors rebuilt by the reference from the corpus files; a row the
files do not bear out counts in `train_rows_off`) with the same dropout
masks (drawn from the trainer's seed, as the reference's encoder draws
them). It reads: the widest relative gap of a step's loss
(`train_loss_gap`); the relative gap of the first step's alignment term,
which the port logs beside its loss (`train_align_gap`); each weight's
first gradient (the port's from its AdamW state after step 1), as the
widest gap of norms (`train_grad_gap`); and each weight's change over the
steps (the port's snapshot before step `check_steps + 1`,
`train_change_gap`).
Gaps of norms are measured against the larger of the reference's norm of
that weight and of the median weight. The traffic mix's `limits` say
which of these the cell compares.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from benchmark.harness import Outcome, Run, checks_from, log
from benchmark.reference import bert, movielens, tokenizer
from benchmark.reference.precision import set_exact_float32
from benchmark.reference.train import BETAS, run_steps
from benchmark.weights import port_state, reference_name

# a weight whose first gradient in the reference is below this share of
# the median weight's moves under Adam by rounding alone: its change is
# left out of the comparison
ROUNDING_GRAD_SHARE = 1e-3


def trainer_for(run: Run, data_dir):
    from xfmr_rec_torch.data.module import DataConfig
    from xfmr_rec_torch.training.module import TrainConfig
    from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig

    p, cfg = run.traffic, run.config
    data = DataConfig(data_dir=str(data_dir), batch_size=p["batch"],
                      max_length=cfg["max_length"],
                      vocab_size=cfg["vocab_size"], seed=run.seed,
                      synthetic_if_missing=False)
    trainer_config = TrainerConfig(
        max_epochs=1_000_000, max_time_s=None, log_every_steps=p["log_every_steps"],
        log_dir=str(run.run_dir / "logs"), run_name="bench",
        checkpointing=False, seed=run.seed,
    )
    return Trainer(TrainConfig.from_dict(cfg), data, trainer_config,
                   device=run.device)


class Feed:
    """The trainer's batches, epoch after epoch, as `Trainer.fit` takes
    them."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.epoch = 0
        self._it = trainer.data.train_batches(0)

    def next(self) -> dict[str, np.ndarray]:
        try:
            return next(self._it)
        except StopIteration:
            self.epoch += 1
            self._it = self.trainer.data.train_batches(self.epoch)
            return next(self._it)


def step(trainer, feed: Feed, tracer, log_every: int) -> tuple[dict, dict]:
    with tracer.span("bench.batch_wait"):
        batch = feed.next()
    rows = np.concatenate([batch["user_tokens"], batch["item_tokens"],
                           batch["neg_item_tokens"]])
    counts = (rows != 0).sum(axis=1).astype(np.int64)
    with tracer.span("bench.train_step", rows=len(rows),
                     tokens=int(counts.sum()),
                     tokens_sq=int((counts * counts).sum())):
        metrics = trainer.train_step(batch)
    if trainer.global_step % log_every == 0:
        trainer.logger.log_metrics(metrics, trainer.global_step)
    return batch, metrics


@dataclasses.dataclass
class FirstSteps:
    """The trainer after set-up's steps, and what the check needs of
    them."""

    trainer: object
    feed: Feed
    weights0: dict
    batches: list
    losses: list
    alignment: list
    first_grad: dict
    change: dict


def first_steps(run: Run) -> FirstSteps:
    """Set-up: the corpus, the trainer with the seeded weights, and its
    first steps through the window's own calls."""
    p, cfg = run.traffic, run.config
    run.mark("imports done")
    movielens.write_ml1m(run.run_dir / "ml1m", run.seed, p["movies"],
                         p["users"], p["ratings"])
    run.mark("corpus written")
    trainer = trainer_for(run, run.run_dir / "ml1m")
    trainer.setup()
    run.mark("Trainer.setup done")
    weights0 = bert.make_weights(cfg, run.seed, run.device)
    model = trainer.state.model
    model.load_state_dict(port_state(weights0, model.state_dict()))
    params = dict(model.named_parameters())
    feed = Feed(trainer)
    batches, losses, alignment = [], [], []
    first_grad = change = None
    for i in range(max(p["warmup_steps"], p["check_steps"])):
        batch, metrics = step(trainer, feed, run.tracer, p["log_every_steps"])
        if i < p["check_steps"]:
            batches.append(batch)
            losses.append(float(metrics[f"train/{cfg['train_loss']}"]))
            alignment.append(float(metrics["train/AlignmentLoss"]))
        if i == 0:
            # AdamW's first moment after one step is (1 - beta1) * grad
            state = trainer.state.optimizer.state
            first_grad = {
                reference_name(n): state.get(w, {}).get(
                    "exp_avg", torch.zeros_like(w)) / (1 - BETAS[0])
                for n, w in params.items()}
        if i + 1 == p["check_steps"]:
            change = {reference_name(n): (w.detach() - weights0[
                reference_name(n)].reshape(w.shape)).clone()
                for n, w in params.items()}
    sync(run)
    run.mark(f"{max(p['warmup_steps'], p['check_steps'])} steps done")
    return FirstSteps(trainer, feed, weights0, batches, losses, alignment,
                      first_grad, change)


def run(run: Run) -> Outcome:
    p = run.traffic
    first = first_steps(run)
    trainer, feed = first.trainer, first.feed
    steps = 0
    run.window_starts()
    start = time.perf_counter()
    while True:
        step(trainer, feed, run.tracer, p["log_every_steps"])
        steps += 1
        elapsed = time.perf_counter() - start
        run.tracer.tick(elapsed, run.seconds)
        if elapsed >= run.seconds:
            break
    sync(run)
    window_s = time.perf_counter() - start
    run.tracer.finish()
    run.read_memory_peak()
    log(f"train: {steps} steps of {p['batch']} in {window_s:.3f} s, "
        f"{1e3 * window_s / steps:.3f} ms a step; peak device memory "
        f"{run.memory_peak_bytes} bytes")
    first.trainer = first.feed = trainer = feed = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    readings, _ = check_steps(run, first)
    return Outcome(metrics={p["metric"]: steps * p["batch"] / window_s},
                   attempted=steps, failed=0,
                   checks=checks_from(readings, p["limits"]))


def sync(run: Run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def rebuild_batches(run: Run, batches: list[dict]) -> tuple[list, int]:
    """Each batch's tensors rebuilt by the reference from the corpus files
    for the rows the port's batch names (movies by `item_idx`, the movie's
    row in movies.dat; users by their token row among the reference's own
    tokenization of every user), and the count of rows whose tensors or
    labels the corpus does not bear out."""
    cfg = run.config
    corpus = movielens.read_ml1m(run.run_dir / "ml1m")
    movie_ids = list(corpus["movies"])
    encode = lambda texts: tokenizer.encode(  # noqa: E731
        texts, cfg["vocab_size"], cfg["max_length"])
    movie_tokens = encode([corpus["movies"][m] for m in movie_ids])
    user_ids = list(corpus["users"])
    user_tokens = encode([corpus["users"][u] for u in user_ids])
    users_by_row: dict[bytes, list[int]] = {}
    for uid, row in zip(user_ids, user_tokens, strict=True):
        users_by_row.setdefault(row.tobytes(), []).append(uid)
    rated_by: dict[int, set] = {}
    for u, m, _ in corpus["rated"]:
        rated_by.setdefault(u, set()).add(m)
    off = 0
    rebuilt = []
    for batch in batches:
        rows = len(batch["user_tokens"])
        item_idx = np.asarray(batch["item_idx"], np.int64)
        items = movie_tokens[item_idx - 1]
        users = np.empty_like(batch["user_tokens"])
        for r in range(rows):
            candidates = users_by_row.get(batch["user_tokens"][r].tobytes(), [])
            movie = movie_ids[item_idx[r] - 1]
            rating = int(batch["target"][r])
            positives = {movie_ids[i - 1] for i in batch["pos_idx"][r] if i > 0}
            fits = [u for u in candidates
                    if (u, movie, rating) in corpus["rated"]
                    and positives <= rated_by.get(u, set())]
            if fits:
                users[r] = user_tokens[user_ids.index(fits[0])]
            else:
                off += 1
                users[r] = batch["user_tokens"][r]
        off += int((items[:rows] != batch["item_tokens"]).any(axis=1).sum())
        off += int((items[rows:] != batch["neg_item_tokens"]).any(axis=1).sum())
        rebuilt.append({
            "user_tokens": users, "item_tokens": items[:rows],
            "neg_item_tokens": items[rows:], "target": batch["target"],
            "item_idx": item_idx, "pos_idx": batch["pos_idx"],
        })
    tensors = [{k: torch.as_tensor(np.asarray(v)).to(run.device)
                for k, v in b.items()} for b in rebuilt]
    return tensors, off


def leaf_gaps(port: dict, ref: dict, keep=None) -> dict[str, float]:
    """Each weight's |‖port‖ - ‖ref‖| against the larger of its reference
    norm and the median weight's reference norm."""
    ref_norms = {k: float(torch.linalg.vector_norm(v.float()))
                 for k, v in ref.items()}
    floor = float(np.median(list(ref_norms.values())))
    gaps = {}
    for name, value in ref_norms.items():
        if keep is not None and name not in keep:
            continue
        got = float(torch.linalg.vector_norm(port[name].float()))
        gaps[name] = (abs(got - value) / max(value, floor, 1e-30)
                      if np.isfinite(got) else float("inf"))
    return gaps


def _relative(got: list[float], want: list[float]) -> float:
    if not all(np.isfinite(got)):
        return float("inf")
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(got, want, strict=True))


def step_readings(side: dict, ref: dict) -> tuple[dict, dict]:
    """The training check's numbers for one side against the reference,
    each given as `losses`, `alignment` (the forward's alignment term, a
    step), `first_grad` and `change` (weight by weight): (readings, where
    the worst weights are)."""
    norms = {k: float(torch.linalg.vector_norm(v))
             for k, v in ref["first_grad"].items()}
    median = float(np.median(list(norms.values())))
    moved = {k for k, v in norms.items() if v >= ROUNDING_GRAD_SHARE * median}
    grad = leaf_gaps(side["first_grad"], ref["first_grad"])
    moves = leaf_gaps(side["change"], ref["change"], keep=moved)
    readings = {
        "train_loss_gap": _relative(side["losses"], ref["losses"]),
        "train_align_gap": _relative(side["alignment"][:1],
                                     ref["alignment"][:1]),
        "train_grad_gap": max(grad.values()),
        "train_change_gap": max(moves.values()),
    }
    where = {"grad": max(grad, key=grad.get), "change": max(moves, key=moves.get),
             "unmoved": sorted(set(norms) - moved)}
    return readings, where


def reference_side(ref: dict, weights0: dict) -> dict:
    """The reference's steps in `step_readings`' terms."""
    return {"losses": ref["losses"], "alignment": ref["alignment"],
            "first_grad": ref["first_grad"],
            "change": {k: ref["weights"][k] - weights0[k] for k in weights0}}


def check_steps(run: Run, first: FirstSteps) -> tuple[dict, dict]:
    """(the port's readings, the reference's steps)."""
    set_exact_float32()
    tensors, off = rebuild_batches(run, first.batches)
    ref = run_steps(first.weights0, tensors, run.config,
                    dropout_seed=run.seed + 1)
    ref["tensors"] = tensors
    readings, where = step_readings(
        {"losses": first.losses, "alignment": first.alignment,
         "first_grad": first.first_grad, "change": first.change},
        reference_side(ref, first.weights0))
    readings["train_rows_off"] = float(off)
    log(f"train check: {len(first.batches)} steps; losses port "
        f"{first.losses} reference {ref['losses']}; alignment port "
        f"{first.alignment} reference {ref['alignment']}; worst weights "
        f"{where}")
    return readings, ref
