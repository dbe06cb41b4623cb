"""Port parity: the mesh over a process group, on the CPU.

Two gloo processes of four CPU slots each (`initialize_distributed`,
`tests/torch_multihost_workers.py`: the counterpart of the reference's
`runs/multihost_*.py`) run the port's sharded flows; this process holds
their results against the port's single-process mesh of eight slots and
the JAX package on its 8 forced CPU devices. Every spawn is waited on
with a timeout and killed after it; every collective of the group gives
up after a minute. Dropout is off except in the checkpoint cycle.

- Training (text tower, history tower, and the token table split with
  four distinct replicas a process): both processes' losses and
  parameters are the same bits, and within 5e-5 of the single-process
  steps and of the reference's `make_sharded_train_step`; the text tower
  in bf16: the same bits in both, step 1 within 1e-4 of the
  single-process mesh; `shard_vocab` with the model axis across the
  processes is refused.
- The five sharded searches on exact inputs, on a (4, 2) mesh (each
  model row inside one process: the reference's layout) and a (1, 8) one
  (the model axis across the processes), queries replicated and
  data-sharded: keys, positions, dmax-composed `exact` and values
  bit-equal to the single-process mesh and to the reference, the same in
  both processes (the reference's answers computed in a process of
  their own, `tests/torch_multihost_reference.py`); the data-sharded
  exclusion search gathered by `process_allgather`; `_query_spec`'s auto
  rule replicates.
- The checkpoint cycle: 2 steps, `save_checkpoint` (the first process
  writes), step 3; in a fresh group, restore and step 3: the same loss
  and parameters, bit for bit, dropout on.
- `RecommenderEngine(index_kind="sharded")` over both processes (a
  (1, 8) mesh and the default one): the same lists in both and the exact
  engine's.
- The transport rule, from each rank's host and card: gloo for CPU
  slots and for processes sharing a card, NCCL where no two share one
  (two hosts of eight cards, or a card each by `CUDA_VISIBLE_DEVICES`);
  NCCL asked for where it cannot run raises.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests import torch_multihost_workers as workers
from tests.test_torch_kernels_cuda import exact_inputs
from tests.test_torch_serving import artifact  # noqa: F401 (the fixture)
from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.models import convert
from xfmr_rec_torch.parallel import mesh as port_mesh
from xfmr_rec_torch.parallel import retrieval as port
from xfmr_rec_torch.serving.engine import RecommenderEngine as PortEngine
from xfmr_rec_torch.training import module as port_module
from xfmr_rec_tpu.data import DataConfig, RecDataModule
from xfmr_rec_tpu.data.prepare import prepare_movielens
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.parallel import create_mesh as ref_create_mesh
from xfmr_rec_tpu.parallel import make_sharded_train_step as ref_sharded_step
from xfmr_rec_tpu.parallel import shard_batch as ref_shard_batch
from xfmr_rec_tpu.parallel.mesh import replicate as ref_replicate
from xfmr_rec_tpu.parallel.train import place_state as ref_place_state
from xfmr_rec_tpu.serving.portable import _flatten
from xfmr_rec_tpu.training import module as ref_module

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 2
SPAWN_TIMEOUT_S = 300
BATCH = 4 * 8  # 4 rows a slot, 8 slots
PARAM_TOL = 5e-5  # the repo's parameter rule
SEARCHES = ("topk", "certified", "packed", "guaranteed", "excluding")
MESH_IDS = [f"{d}x{m}" for d, m in workers.MESHES]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start(flow: str, directory: pathlib.Path, init: str, *extra: str):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "2"
    return [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_multihost_workers.py"),
             flow, str(rank), str(WORLD), init, str(directory), *extra],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(WORLD)
    ]


def finish(procs, directory: pathlib.Path, name: str) -> list:
    """Wait for every process (killing all on a timeout or a failure) and
    load their results."""
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, out in zip(procs, outs, strict=True):
        assert proc.returncode == 0, out[-4000:]
    if name == "reference":
        return torch.load(directory / "reference.pt", weights_only=False)
    return [
        torch.load(directory / f"{name}_{rank}.pt", weights_only=False)
        for rank in range(WORLD)
    ]


def store(directory: pathlib.Path, name: str) -> str:
    return f"file://{directory / f'store_{name}'}"


def ref_batches(directory: pathlib.Path, tower: str) -> list[dict]:
    extra = dict(max_history=3, max_bag=4) if tower == "history" else {}
    dm = RecDataModule(DataConfig(
        data_dir=str(directory / "refdata"), batch_size=BATCH,
        max_length=8, vocab_size=300, **extra,
    ))
    dm.setup()
    return [b for _, b in zip(range(workers.TRAIN_STEPS), dm.train_batches(0))]


def port_init(ref_params, config) -> dict:
    flat = {k: np.asarray(v, np.float32) for k, v in _flatten(ref_params).items()}
    if config.user_tower == "history":
        return convert.two_tower_state_from_flat(flat, config)
    return convert.encoder_state_from_flat(flat, config)


def search_inputs() -> dict:
    q, c, _, _ = exact_inputs(10, 8, 512, 16)
    _, c768, _, _ = exact_inputs(20, 8, 768, 16)
    _, c1000, _, _ = exact_inputs(30, 8, 1000, 16)
    bound1000 = float(2.0 ** np.ceil(np.log2(np.abs(q @ c1000.T).max() + 1e-3)))
    # planted lane-pair collisions: pass 1 leaves rows for the retries
    qg, cg, _, _ = exact_inputs(40, 16, 1024, 16)
    for row in range(4):
        for offset in (0, 32, 64, 96):
            cg[row + offset] = qg[row]
    boundg = float(2.0 ** np.ceil(np.log2(np.abs(qg @ cg.T).max() + 1e-3)))
    rng = np.random.default_rng(1)
    arrays = dict(
        q=q, c=c, c768=c768, c1000=c1000, qg=qg, cg=cg,
        excl=rng.integers(0, 520, size=(8, 5)).astype(np.int32),
        excl1000=rng.integers(0, 1010, size=(8, 6)).astype(np.int32),
    )
    out = {k: torch.from_numpy(v) for k, v in arrays.items()}
    out.update(bound1000=bound1000, boundg=boundg)
    return out


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The directory of the inputs written for the workers, the inputs,
    and the process computing the reference's searches (started first:
    it takes the longest)."""
    directory = tmp_path_factory.mktemp("multihost")
    inputs = {"search": search_inputs()}
    torch.save(inputs, directory / "search.pt")
    reference = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_multihost_reference.py"),
         str(directory)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        generate_movielens(directory / "refdata", num_users=40,
                           num_movies=120, num_ratings=1200, seed=1)
        prepare_movielens(str(directory / "refdata"), overwrite=True)
        for tower, extra in workers.TOWERS.items():
            kw = dict(workers.TINY, **extra)
            _, state = ref_module.create_train_state(
                ref_module.TrainConfig(**kw), rng=0
            )
            inputs[f"init/{tower}"] = port_init(
                state.params, port_module.TrainConfig(**kw)
            )
            inputs[f"batches/{tower}"] = ref_batches(directory, tower)
        torch.save(inputs, directory / "inputs.pt")
        PortDataModule(PortDataConfig(
            data_dir=str(directory / "data"), **workers.CKPT_DATA
        )).prepare_data()
    except BaseException:
        reference.kill()
        reference.communicate()
        raise
    return directory, inputs, reference


@pytest.fixture(scope="module")
def runs(work, request):
    """Every flow's results (rank -> result, by flow). The flows run side
    by side while this process builds the served artifact and computes
    the single-process and reference answers."""
    directory = work[0]
    started = {
        "reference": [work[2]],
        "steps": start("steps", directory, store(directory, "steps")),
        "search": start("search", directory, f"127.0.0.1:{free_port()}"),
        "ckpt_a": start("ckpt", directory, store(directory, "a"), "a"),
    }
    done = {}
    try:
        artifact = request.getfixturevalue("artifact")
        started["serve"] = start(
            "serve", directory, store(directory, "serve"), str(artifact)
        )
        # the second half of the cycle: a fresh group restores
        done["ckpt_a"] = finish(started.pop("ckpt_a"), directory, "ckpt_a")
        started["ckpt_b"] = start("ckpt", directory, store(directory, "b"), "b")
        request.getfixturevalue("single_process")
        request.getfixturevalue("reference_steps")
    finally:
        for name, procs in started.items():
            done[name] = finish(procs, directory, name)
    return done


def assert_same_bits(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            assert_same_bits(a[key], b[key])
    elif isinstance(a, list | tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b, strict=True):
            assert_same_bits(x, y)
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# -- the mesh and the transport --------------------------------------------
def test_mesh_is_process_major(runs):
    r0, r1 = runs["search"]
    assert r0["process_count"] == r1["process_count"] == WORLD
    assert r0["slots/4x2"] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert r1["slots/4x2"] == [(2, 0), (2, 1), (3, 0), (3, 1)]
    assert r0["slots/1x8"] == [(0, j) for j in range(4)]
    assert r1["slots/1x8"] == [(0, j) for j in range(4, 8)]


def test_transport_rule(runs):
    for result in runs["search"]:
        assert result["transport"].startswith("gloo")
    assert port_mesh.device_identity(torch.device("cpu")) is None
    rule = port_mesh.transport_backend
    assert rule([None, None]) == "gloo"
    # processes sharing a card: gloo, staged through the host
    assert rule(["h0/GPU-a", "h0/GPU-a"]) == "gloo"
    assert rule(["h0/GPU-a", None]) == "gloo"


@pytest.mark.parametrize("layout", ["2-hosts-x-8-cards", "a-card-each-by-env"])
def test_transport_rule_with_a_card_a_process(layout):
    """What the ranks see decides, not their count: an explicit
    `initialize_distributed(addr, 16, rank)` over two hosts of eight
    cards, and eight ranks each given one card by `CUDA_VISIBLE_DEVICES`
    (each sees only its `cuda:0`), both take NCCL."""
    if layout == "2-hosts-x-8-cards":
        seen = [f"h{r // 8}/GPU-{r % 8}" for r in range(16)]
    else:
        seen = [f"h0/GPU-{r}" for r in range(8)]
    assert port_mesh.transport_backend(seen) == "nccl"
    seen[-1] = seen[0]  # two ranks on one card
    assert port_mesh.transport_backend(seen) == "gloo"


def test_nccl_where_it_cannot_run_raises(tmp_path):
    with pytest.raises((RuntimeError, ValueError), match="(?i)nccl"):
        port_mesh.initialize_distributed(
            f"file://{tmp_path / 'store'}", 1, 0, backend="nccl", device="cpu"
        )
    assert not port_mesh.is_distributed()


def test_query_spec_auto_rule_under_a_group(runs):
    for result in runs["search"]:
        # the reference's rule: more than one process -> replicated
        assert result["query_spec/4x2"] == 1
        assert result["query_spec/1x8"] == 1
    one = port_mesh.create_mesh(model_parallel=2, devices=["cpu"] * 8)
    assert port._query_spec(one, 8, None) == 4


# -- training -------------------------------------------------------------
@pytest.mark.parametrize("case", [*workers.TRAIN_CASES, workers.BF16])
def test_steps_same_bits_in_both_processes(runs, case):
    r0, r1 = runs["steps"]
    assert_same_bits(r0[case], r1[case])


@pytest.mark.parametrize("case", list(workers.TRAIN_CASES))
def test_steps_match_the_single_process_mesh(work, runs, case):
    inputs = work[1]
    slots = workers.TRAIN_CASES[case][1]
    devices = slots * 2 if slots[0] == "cpu" else [f"cpu:{i}" for i in range(8)]
    want = workers.train_case(case, inputs, devices)
    got = runs["steps"][0][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=PARAM_TOL)
    for key, value in want["params"].items():
        np.testing.assert_allclose(
            got["params"][key], value, rtol=0, atol=PARAM_TOL, err_msg=key
        )


@pytest.fixture(scope="module")
def reference_steps(work) -> dict:
    """case -> (the reference's per-step train losses, its parameters
    after the steps in the port's layout)."""
    inputs = work[1]
    out = {}
    for case, (tower, _, model_parallel, shard_vocab) in workers.TRAIN_CASES.items():
        kw = dict(workers.TINY, **workers.TOWERS[tower])
        config = ref_module.TrainConfig(**kw)
        mesh = ref_create_mesh(8, model_parallel=model_parallel)
        # the step donates its input: a fresh state from the same seed
        _, state = ref_module.create_train_state(config, rng=0)
        state = ref_replicate(state, mesh)
        if shard_vocab:
            state = ref_place_state(state, mesh, config, shard_vocab=True)
        step = ref_sharded_step(config, mesh, shard_vocab=shard_vocab, state=state)
        name = f"train/{kw.get('train_loss', 'PairwiseHingeLoss')}"
        losses = []
        for batch in inputs[f"batches/{tower}"]:
            state, metrics = step(state, ref_shard_batch(batch, mesh))
            losses.append(float(metrics[name]))
        params = port_init(
            jax.device_get(state.params), port_module.TrainConfig(**kw)
        )
        out[case] = (name, losses, params)
    return out


@pytest.mark.parametrize("case", list(workers.TRAIN_CASES))
def test_steps_match_the_reference(runs, reference_steps, case):
    name, losses, want = reference_steps[case]
    got = runs["steps"][1][case]
    metric_names = sorted(got["metric_names"])
    for index, loss in enumerate(losses):
        np.testing.assert_allclose(
            float(got["losses"][index][metric_names.index(name)]),
            loss,
            rtol=PARAM_TOL,
        )
    for key, value in want.items():
        np.testing.assert_allclose(
            got["params"][key], value, rtol=0, atol=PARAM_TOL, err_msg=key
        )


# step 1 in bf16 against one pass over the whole batch: every metric
# within this relative gap (CPU readings: the losses equal, the gradient
# norm 8.6e-6; a world size counted twice would double the norm)
BF16_STEP1_RTOL = 1e-4


def test_bf16_step_matches_the_single_process_mesh(work, runs):
    """The port's default compute type, whose rows cross the processes as
    bf16: each process encodes half the batch, which rounds otherwise
    than the single-process mesh's one pass, so step 1 is held, before
    Adam amplifies the difference."""
    want = workers.train_case(
        "text", work[1], ["cpu"] * 8, compute_dtype="bfloat16"
    )
    got = runs["steps"][0][workers.BF16]
    assert got["metric_names"] == want["metric_names"]
    assert "train/grad_norm" in got["metric_names"]
    np.testing.assert_allclose(
        got["losses"][0], want["losses"][0], rtol=BF16_STEP1_RTOL
    )


def test_shard_vocab_across_processes_is_refused(runs):
    for result in runs["steps"]:
        assert "model axis across processes" in result["vocab_across"]


# -- retrieval ------------------------------------------------------------
@pytest.fixture(scope="module")
def single_process(work):
    """The single-process 8-slot mesh's answers."""
    inputs = work[1]
    return {
        f"{data}x{model}": workers.search_cases(
            inputs,
            port_mesh.create_mesh(model_parallel=model, devices=["cpu"] * 8),
        )
        for data, model in workers.MESHES
    }


@pytest.mark.parametrize("shard_queries", [False, True])
@pytest.mark.parametrize("name", SEARCHES)
@pytest.mark.parametrize("tag", MESH_IDS)
def test_search_bit_equal(runs, single_process, tag, name, shard_queries):
    key = f"{name}/{shard_queries}"
    r0, r1 = runs["search"]
    got = r0[f"{tag}/{key}"]
    assert_same_bits(got, r1[f"{tag}/{key}"])
    assert_same_bits(got, single_process[tag][key])
    # the reference with replicated queries (the port's data-sharded
    # answers are held to it too: a row's answer does not depend on how
    # the batch splits)
    data, model = map(int, tag.split("x"))
    for g, w in zip(got, runs["reference"][(data, model)][name], strict=True):
        np.testing.assert_array_equal(g.numpy(), w)
    if len(got) == 3:
        assert got[2].any()


@pytest.mark.parametrize("tag", MESH_IDS)
def test_process_allgather_of_the_data_sharded_search(runs, tag):
    for result in runs["search"]:
        gathered = result[f"allgather/{tag}"]
        assert isinstance(gathered, np.ndarray)
        np.testing.assert_array_equal(
            gathered, result[f"{tag}/excluding/True"][1].numpy()
        )
    stacked = runs["search"][0]["stacked"]
    assert stacked.shape[0] == WORLD
    assert torch.equal(stacked[0], stacked[1])


# -- the checkpoint cycle --------------------------------------------------
def test_checkpoint_cycle_bit_equal(work, runs):
    directory = work[0]
    saved = sorted(p.name for p in (directory / "ckpt").iterdir())
    assert saved == ["step2"]  # one writer, no temporary left
    for a, b in zip(runs["ckpt_a"], runs["ckpt_b"], strict=True):
        assert b["restored_step"] == 2
        assert a["loss"].dtype == torch.float32
        assert torch.equal(a["loss"], b["loss"])
        assert_same_bits(a["params"], b["params"])
        assert "p1:" in a["mesh"]
    assert_same_bits(runs["ckpt_a"][0], runs["ckpt_a"][1])


# -- the sharded engine ----------------------------------------------------
@pytest.mark.parametrize("mesh", ["1x8", "default"])
def test_sharded_engine_answers_in_every_process(runs, artifact, mesh):  # noqa: F811
    r0, r1 = runs["serve"]
    assert r0[mesh] == r1[mesh]
    assert "p1:" in r0[f"mesh/{mesh}"]
    exact = workers.serve_requests(PortEngine(artifact, device="cpu"))
    assert [ids for ids, _ in r0[mesh]] == [ids for ids, _ in exact]
    for (_, got), (_, want) in zip(r0[mesh], exact, strict=True):
        np.testing.assert_allclose(got, want, atol=2e-2)
