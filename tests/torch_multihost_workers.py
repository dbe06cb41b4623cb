"""One process of the port's multi-process flows on the CPU.

Counterpart of the reference's `runs/multihost_worker.py`,
`runs/multihost_ckpt_worker.py` and `runs/multihost_serving_worker.py`,
driven by `tests/test_torch_multihost.py`:

    PYTHONPATH=. python tests/torch_multihost_workers.py <flow> <rank> <world> <init> <dir> [arg]

Each process joins a gloo group (`initialize_distributed`, pinned to
the CPU, every collective bounded by a timeout), lays out four slots on
the CPU, runs one flow on inputs the test wrote under <dir>, and writes
its results to `<dir>/<flow>_<rank>.pt` for the test to hold against the
single-process mesh and the JAX package. The flow functions also run in
the test's own process on a one-controller mesh, so both sides run one
code path. The `card_*` flows pin process r to `cuda:{r % cards}` (two
slots each) for `tests/test_torch_parallel_cuda.py`: on one card both
share it over gloo, staged through the host; with a card each they take
NCCL.
Imports nothing of the JAX package (the card's machine has none).
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

from xfmr_rec_torch.parallel import mesh as mesh_mod
from xfmr_rec_torch.parallel import retrieval
from xfmr_rec_torch.parallel.train import (
    gathered_state_dict,
    make_sharded_train_step,
    place_state,
)
from xfmr_rec_torch.training import module as train_mod

SLOTS = 4  # slots a process
CPU = torch.device("cpu")

TINY = dict(
    hidden_size=32,
    num_hidden_layers=1,
    num_attention_heads=4,
    intermediate_size=32,
    vocab_size=300,
    max_position_embeddings=16,
    max_length=8,
    dropout_rate=0.0,
    compute_dtype="float32",
    learning_rate=1e-3,
)
HISTORY = dict(
    user_tower="history",
    max_history=3,
    train_loss="InfomationNoiseContrastiveEstimationLoss",
    item_id_buckets=256,
    item_id_embedding="bloom",
    item_bias=True,
    max_bag=4,
)
TOWERS = {"text": {}, "history": HISTORY}
# name -> (tower, this process's slots, model_parallel, shard_vocab)
TRAIN_CASES = {
    "text": ("text", ["cpu"] * SLOTS, 2, False),
    "history": ("history", ["cpu"] * SLOTS, 2, False),
    # distinct device slots: four replicas a process, summed locally and
    # then over the processes; the token table split over each model row
    "text-vocab-distinct": ("text", [f"cpu:{i}" for i in range(SLOTS)], 2, True),
}
# the checkpoint flow's synthetic corpus (the test prepares it first)
CKPT_DATA = dict(batch_size=8, max_length=8, vocab_size=300,
                 synthetic_users=40, synthetic_movies=120,
                 synthetic_ratings=1200)
TRAIN_STEPS = 2
BF16 = "text-bf16"  # the text case in bfloat16, held at step 1
MESHES = ((4, 2), (1, 8))  # (data, model) over two processes of 4 slots


# -- flows ----------------------------------------------------------------
def train_case(name: str, inputs: dict, devices: list[str], **kw) -> dict:
    """`TRAIN_STEPS` sharded steps of one case from the saved init (`kw`
    overrides the config): {"losses": per-step metrics, "params": the
    gathered state dict}."""
    tower, _, model_parallel, shard_vocab = TRAIN_CASES[name]
    config = train_mod.TrainConfig(**dict(TINY, **TOWERS[tower], **kw))
    state = train_mod.TrainState(config, device=CPU)
    state.model.load_state_dict(inputs[f"init/{tower}"])
    mesh = mesh_mod.create_mesh(model_parallel=model_parallel, devices=devices)
    place_state(state, mesh, config, shard_vocab=shard_vocab)
    step = make_sharded_train_step(
        config, mesh, shard_vocab=shard_vocab, state=state
    )
    losses = []
    for batch in inputs[f"batches/{tower}"]:
        metrics = step(state, mesh_mod.shard_batch(batch, mesh))
        losses.append(torch.stack([metrics[k] for k in sorted(metrics)]))
    return {
        "metric_names": sorted(metrics),
        "losses": torch.stack(losses),
        "params": gathered_state_dict(state.model),
    }


def search_cases(inputs: dict, mesh) -> dict:
    """The five sharded searches on the saved exact inputs, replicated
    and data-sharded queries: name -> outputs (on the CPU)."""
    out = {}
    for shard_queries in (False, True):
        for name, (fn, args, kw) in search_calls(inputs).items():
            got = fn(*args, mesh, shard_queries=shard_queries, **kw)
            out[f"{name}/{shard_queries}"] = tuple(t.cpu() for t in got)
    return out


def search_calls(inputs: dict) -> dict:
    """name -> (function, (queries, corpus, k), keywords)."""
    t = inputs["search"]
    return {
        "topk": (retrieval.sharded_topk, (t["q"], t["c"], 12),
                 dict(exclude_positions=t["excl"], true_num_items=500)),
        "certified": (retrieval.sharded_certified_topk,
                      (t["q"], t["c768"], 10),
                      dict(corpus_tile=64, true_num_items=760)),
        "packed": (retrieval.sharded_packed_certified_topk,
                   (t["q"], t["c1000"], 10),
                   dict(score_bound=t["bound1000"], corpus_tile=64,
                        merge_levels=1, true_num_items=997)),
        "guaranteed": (retrieval.sharded_packed_guaranteed_topk,
                       (t["qg"], t["cg"], 10),
                       dict(score_bound=t["boundg"], corpus_tile=64,
                            true_num_items=1020, retry_width=8, retries=2)),
        "excluding": (retrieval.sharded_packed_topk_excluding,
                      (t["q"], t["c1000"], 12),
                      dict(exclude_positions=t["excl1000"],
                           score_bound=t["bound1000"], corpus_tile=64,
                           true_num_items=995)),
    }


def flow_steps(directory: pathlib.Path, rank: int) -> dict:
    inputs = torch.load(directory / "inputs.pt", weights_only=False)
    out = {name: train_case(name, inputs, case[1])
           for name, case in TRAIN_CASES.items()}
    # the port's default compute type, whose rows travel as bf16
    out[BF16] = train_case("text", inputs, TRAIN_CASES["text"][1],
                           compute_dtype="bfloat16")
    # the model axis across the processes: refused
    config = train_mod.TrainConfig(**TINY)
    state = train_mod.TrainState(config, device=CPU)
    wide = mesh_mod.create_mesh(model_parallel=8, devices=["cpu"] * SLOTS)
    try:
        place_state(state, wide, config, shard_vocab=True)
        out["vocab_across"] = ""
    except NotImplementedError as err:
        out["vocab_across"] = str(err)
    return out


def flow_search(directory: pathlib.Path, rank: int) -> dict:
    inputs = torch.load(directory / "inputs.pt", weights_only=False)
    out = {"transport": mesh_mod.describe_transport(),
           "process_count": mesh_mod.process_count()}
    for data, model in MESHES:
        mesh = mesh_mod.create_mesh(model_parallel=model, devices=["cpu"] * SLOTS)
        assert mesh.shape == {"data": data, "model": model}, mesh
        out[f"slots/{data}x{model}"] = mesh.local_slots()
        out[f"query_spec/{data}x{model}"] = retrieval._query_spec(mesh, 8, None)
        for key, value in search_cases(inputs, mesh).items():
            out[f"{data}x{model}/{key}"] = value
        # the data-sharded exclusion search as the reference's caller
        # gathers it: each process's own data rows, process_allgather'ed
        scores, positions = out[f"{data}x{model}/excluding/True"]
        per = positions.shape[0] // data
        rows = [i for i in range(data) if mesh.owns_row(i)]
        mine = torch.cat(
            [positions[i * per : (i + 1) * per] for i in rows] or [positions[:0]]
        )
        out[f"allgather/{data}x{model}"] = mesh_mod.process_allgather(
            mine.numpy(), tiled=True
        )
    # every process's answers side by side (each must equal the others)
    out["stacked"] = mesh_mod.process_allgather(
        out["1x8/guaranteed/False"][1]
    )
    return out


def flow_ckpt(directory: pathlib.Path, rank: int, phase: str) -> dict:
    """Phase "a": 2 steps, `save_checkpoint` (the first process writes),
    step 3. Phase "b" (a fresh group): restore, step 3."""
    from xfmr_rec_torch.data.module import DataConfig, RecDataModule
    from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig

    trainer = Trainer(
        # dropout on: the resumed step must draw the masks the
        # uninterrupted one drew, in every process
        train_mod.TrainConfig(**dict(TINY, dropout_rate=0.1)),
        data=RecDataModule(
            DataConfig(data_dir=str(directory / "data"), **CKPT_DATA)
        ),
        trainer_config=TrainerConfig(
            mesh=True, model_parallel=2, log_dir=str(directory / "runs"),
            run_name="ckpt", ckpt_dir=str(directory / "ckpt"), seed=3,
        ),
        device="cpu",
        devices=["cpu"] * SLOTS,
    )
    trainer.setup()
    batches = [b for _, b in zip(range(3), trainer.data.train_batches(0))]
    if phase == "a":
        for batch in batches[:2]:
            trainer.train_step(batch)
        trainer.save_checkpoint("step2")
    else:
        trainer.restore_checkpoint("step2")
    step = trainer.global_step
    metrics = trainer.train_step(batches[2])
    return {
        "restored_step": step,
        "loss": metrics["train/PairwiseHingeLoss"].cpu(),
        "params": gathered_state_dict(trainer.state.model),
        "mesh": repr(trainer.mesh),
    }


def serve_requests(engine) -> list:
    """The requests both processes (and the exact engine) answer, through
    `RecService`'s handlers: (ids, scores) a request."""
    from xfmr_rec_torch.serving.schemas import Query
    from xfmr_rec_torch.serving.service import RecService

    service = RecService(engine)
    user_ids = [int(u) for u in engine.users.arrays["user_id"][:3]]
    item_ids = [int(i) for i in engine.index.ids[:3]]
    answers = []
    for text in ("comedy", "action thriller", "a quiet drama about family"):
        answers.append(service.recommend_with_query(Query(text=text), top_k=5))
    for item_id in item_ids:
        answers.append(service.recommend_with_item_id(item_id, top_k=5))
    for user_id in user_ids:
        answers.append(service.recommend_with_user_id(user_id, top_k=5))
    return [([c.movie_id for c in a], [c.score for c in a]) for a in answers]


def flow_serve(directory: pathlib.Path, rank: int, artifact: str) -> dict:
    from xfmr_rec_torch.serving.engine import RecommenderEngine

    out = {}
    for name, mesh in (
        ("1x8", mesh_mod.create_mesh(model_parallel=8, devices=["cpu"] * SLOTS)),
        ("default", None),
    ):
        engine = RecommenderEngine(
            artifact, index_kind="sharded", mesh=mesh, device="cpu", warmup=False
        )
        out[f"mesh/{name}"] = repr(engine.index.mesh)
        out[name] = serve_requests(engine)
    return out


CARD_N, CARD_D, CARD_B, CARD_K = 1 << 16, 64, 256, 50
CARD_STEPS = 3


def card_inputs() -> tuple[torch.Tensor, torch.Tensor]:
    """A corpus of unit rows and unit queries, from a seed (the same in
    every process and in the test)."""
    gen = torch.Generator().manual_seed(5)
    corpus = torch.nn.functional.normalize(
        torch.randn(CARD_N, CARD_D, generator=gen), dim=1
    )
    queries = torch.nn.functional.normalize(
        torch.randn(CARD_B, CARD_D, generator=gen), dim=1
    )
    return corpus, queries


def card_batches() -> list[dict]:
    """Batches of the reference config's widths (as the reference's
    multihost worker derives them)."""
    rng = np.random.default_rng(3)
    return [{
        "user_tokens": rng.integers(1, 30522, (32, 64)).astype(np.int32),
        "item_tokens": rng.integers(1, 30522, (32, 64)).astype(np.int32),
        "neg_item_tokens": rng.integers(1, 30522, (32, 64)).astype(np.int32),
        "target": rng.integers(1, 6, 32).astype(np.float32),
        "item_idx": rng.integers(1, 500, 64).astype(np.int64),
        "pos_idx": rng.integers(0, 500, (32, 4)).astype(np.int64),
    } for _ in range(CARD_STEPS)]


def card_config():
    import dataclasses

    return dataclasses.replace(
        train_mod.TrainConfig(), dropout_rate=0.0, compute_dtype="float32"
    )


def card_search(mesh) -> dict:
    """`search_certified("fused")` over the card corpus on `mesh`."""
    from xfmr_rec_torch.index.sharded import ShardedRetrievalIndex
    from xfmr_rec_torch.ops import kernels

    corpus, queries = card_inputs()
    index = ShardedRetrievalIndex(corpus, np.arange(CARD_N), mesh=mesh)
    kernels.reset_launch_counts()
    scores, ids = index.search_certified(queries.numpy(), top_k=CARD_K)
    return {"scores": scores, "ids": ids, "launches": kernels.launch_counts(),
            "transport": mesh_mod.describe_transport()}


def flow_card_search(directory: pathlib.Path, rank: int) -> dict:
    # "cuda": the card this process is pinned to
    return card_search(mesh_mod.create_mesh(model_parallel=4,
                                            devices=["cuda"] * 2))


def flow_card_steps(directory: pathlib.Path, rank: int) -> dict:
    config = card_config()
    state = train_mod.TrainState(config, device="cuda")
    mesh = mesh_mod.create_mesh(model_parallel=2, devices=["cuda"] * 2)
    place_state(state, mesh, config)
    step = make_sharded_train_step(config, mesh, state=state)
    metrics = [step(state, mesh_mod.shard_batch(batch, mesh))
               for batch in card_batches()]
    return {
        "losses": torch.stack(
            [m["train/PairwiseHingeLoss"] for m in metrics]).cpu(),
        "grad_norms": torch.stack([m["train/grad_norm"] for m in metrics]).cpu(),
        "params": {k: v.cpu() for k, v in gathered_state_dict(state.model).items()},
    }


FLOWS = {
    "steps": flow_steps,
    "search": flow_search,
    "ckpt": flow_ckpt,
    "serve": flow_serve,
    "card_search": flow_card_search,
    "card_steps": flow_card_steps,
}


def main(argv: list[str]) -> int:
    flow, rank, world, init, directory, *extra = argv
    torch.set_num_threads(2)
    directory = pathlib.Path(directory)
    device = "cuda" if flow.startswith("card") else "cpu"
    mesh_mod.initialize_distributed(init, int(world), int(rank), device=device)
    try:
        result = FLOWS[flow](directory, int(rank), *extra)
    finally:
        mesh_mod.shutdown_distributed()
    suffix = "_".join([flow, *extra[:1]]) if flow == "ckpt" else flow
    torch.save(result, directory / f"{suffix}_{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
