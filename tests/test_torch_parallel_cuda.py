"""Corpus-sharded search and the sharded train step on the card.

Marked `cuda`: these need an H100 (sm_90a) and nvcc, and skip elsewhere.
The mesh is four slots on the card (`["cuda:0"] * 4`), or four cards
where the machine has them. Run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_cuda.py

- every row of the sharded searches (exclusion search, `search_certified`
  "fused" and "packed", the f32 `sharded_certified_topk`) equals dense
  top-k on the card, at the key quantum, on a (1, 4) and a (2, 2) mesh,
  and the sharded paths launch kernels 1, 2 and 3;
- the sharded packed functions give the keys of their plain versions:
  the same call on the CPU, bit for bit, on exact inputs;
- 3 sharded steps (and 3 with `shard_vocab`) equal 3 single-device steps
  within the repo's 5e-5 parameter rule.
"""

import dataclasses

import numpy as np
import pytest
import torch

from xfmr_rec_torch.index.sharded import ShardedRetrievalIndex
from xfmr_rec_torch.ops import kernels, topk
from xfmr_rec_torch.parallel import retrieval
from xfmr_rec_torch.parallel.mesh import create_mesh, shard_batch
from xfmr_rec_torch.parallel.train import (
    gathered_state_dict,
    make_sharded_train_step,
    place_state,
)
from xfmr_rec_torch.training import module as train_mod

pytestmark = pytest.mark.cuda

N, D, B, K = 1 << 16, 64, 256, 50


@pytest.fixture
def devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    count = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(4)] if count >= 4 else ["cuda:0"] * 4


def unit(gen, rows, dim):
    return torch.nn.functional.normalize(
        torch.randn(rows, dim, generator=gen), dim=1
    )


def quantum(index, merge_levels):
    local = index.corpus.shape[0] // index.num_shards
    ct = topk.pick_corpus_tile(local, index.dim)
    bits = max((local // ct - 1).bit_length(), 1) + merge_levels
    return 2.0 ** (bits - 23) + 1e-6


def hold_to_dense(index, queries, ids, tight):
    """Every row exact in the packed order: each returned item at or
    above the dense k-th (scaled units, within one key quantum) and every
    item a quantum above it returned; a row the dense path answered is
    exact in the bf16 order instead. Returns the rows of the second
    kind."""
    lead = index.mesh.lead
    rows = index.dequantized(lead)
    q = torch.from_numpy(queries).to(lead, torch.bfloat16)
    q_s = (q.float() * (0.25 / index._score_bound(q))).bfloat16().float()
    pos = torch.from_numpy(ids.astype(np.int64)).to(lead)
    dense = q_s @ rows.T
    kth = torch.topk(dense, K, dim=1).values[:, -1:]
    got = torch.gather(dense, 1, pos)
    ok = (got >= kth - tight).all(1) & (
        (got > kth + tight).sum(1) == (dense > kth + tight).sum(1)
    )
    plain = q.float() @ rows.T
    kth_p = torch.topk(plain, K, dim=1).values[:, -1:]
    ok_p = (torch.gather(plain, 1, pos) >= kth_p - 1e-6).all(1)
    assert bool((ok | ok_p).all())
    return int((~ok).sum())


@pytest.mark.parametrize("model", [4, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sharded_index_equals_dense(devices, model, dtype):
    gen = torch.Generator().manual_seed(model)
    corpus = unit(gen, N, D)
    mesh = create_mesh(model_parallel=model, devices=devices)
    index = ShardedRetrievalIndex(corpus, np.arange(N), mesh=mesh, dtype=dtype)
    queries = unit(gen, B, D).numpy()
    kernels.reset_launch_counts()
    for method, merge in (("fused", 1), ("packed", 0)):
        _, ids = index.search_certified(queries, top_k=K, method=method)
        off = hold_to_dense(index, queries, ids, quantum(index, merge))
        assert off <= index.last_certified_stats["pass1_bad"]
    counts = kernels.launch_counts()
    assert counts["packed_scan"] > 0 and counts["threshold_select"] > 0


def test_sharded_f32_certificate_and_exclusions(devices):
    gen = torch.Generator().manual_seed(7)
    corpus = unit(gen, N, D).cuda().bfloat16()
    queries = unit(gen, B, D).cuda().bfloat16()
    mesh = create_mesh(model_parallel=4, devices=devices)
    kernels.reset_launch_counts()
    vals, pos, exact = retrieval.sharded_certified_topk(queries, corpus, K, mesh)
    assert kernels.launch_counts()["lane_max_scan"] >= 4
    assert bool(exact.any())
    dense = queries.float() @ corpus.float().T
    want = torch.topk(dense, K, dim=1).values
    torch.testing.assert_close(vals[exact], want[exact], rtol=0, atol=1e-5)
    excl = torch.topk(dense, 3, dim=1).indices.int()
    scores, got = retrieval.sharded_packed_topk_excluding(
        queries, corpus, K, mesh, exclude_positions=excl,
        score_bound=torch.tensor(1.05, device="cuda"),
    )
    assert torch.isfinite(scores).all()
    assert not (got[:, :, None] == excl[:, None, :]).any()


@pytest.mark.parametrize("name", ["excluding", "guaranteed"])
def test_sharded_packed_keys_equal_the_plain_versions(devices, name):
    """Exact inputs: the kernels' sharded answer == the CPU's, bit for bit."""
    gen = torch.Generator().manual_seed(11)
    q = torch.randint(-8, 9, (64, 32), generator=gen).float() / 16
    c = torch.randint(-8, 9, (8192, 32), generator=gen).float() / 16
    bound = 2.0 ** np.ceil(np.log2(float((q @ c.T).abs().max()) + 1e-3))
    fn = {
        "excluding": retrieval.sharded_packed_topk_excluding,
        "guaranteed": retrieval.sharded_packed_guaranteed_topk,
    }[name]
    kw = dict(score_bound=bound, corpus_tile=256)
    want = fn(q.bfloat16(), c.bfloat16(), 20,
              create_mesh(model_parallel=2, devices=["cpu"] * 4), **kw)
    got = fn(q.bfloat16().cuda(), c.bfloat16().cuda(), 20,
             create_mesh(model_parallel=2, devices=devices), **kw)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("shard_vocab", [False, True])
def test_sharded_steps_equal_single_device_steps(devices, shard_vocab):
    config = dataclasses.replace(
        train_mod.TrainConfig(), dropout_rate=0.0, compute_dtype="float32"
    )
    rng = np.random.default_rng(3)
    batches = [{
        "user_tokens": rng.integers(1, 30522, (32, 64)).astype(np.int32),
        "item_tokens": rng.integers(1, 30522, (32, 64)).astype(np.int32),
        "neg_item_tokens": rng.integers(1, 30522, (32, 64)).astype(np.int32),
        "target": rng.integers(1, 6, 32).astype(np.float32),
        "item_idx": rng.integers(1, 500, 64).astype(np.int64),
        "pos_idx": rng.integers(0, 500, (32, 4)).astype(np.int64),
    } for _ in range(3)]
    single = train_mod.TrainState(config, device="cuda")
    state = train_mod.TrainState(config, device="cuda")
    mesh = create_mesh(model_parallel=2, devices=devices)
    place_state(state, mesh, config, shard_vocab=shard_vocab)
    step = make_sharded_train_step(config, mesh, shard_vocab=shard_vocab,
                                   state=state)
    for batch in batches:
        want = train_mod.train_step(
            single, train_mod.batch_to_device(batch, torch.device("cuda"))
        )
        got = step(state, shard_batch(batch, mesh))
        torch.testing.assert_close(
            got["train/PairwiseHingeLoss"].cpu(),
            want["train/PairwiseHingeLoss"].cpu(), rtol=1e-4, atol=1e-5,
        )
    ours, theirs = gathered_state_dict(state.model), single.model.state_dict()
    worst = max((ours[n].cpu() - v.cpu()).abs().max().item()
                for n, v in theirs.items())
    assert worst <= 5e-5
