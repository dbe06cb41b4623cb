"""The IVF index and remat on the card.

Marked `cuda`: these need a CUDA card and skip elsewhere. Run them on the
card with

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_ivf_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the card's
machine does not have; nothing here imports it.)

- Two builds of one corpus give one layout (the k-means sums are a
  one-hot product, not atomics).
- The probe's scores are f32 dots of the rounded query and the bf16
  rows, never rounded to bf16, with TF32 on or off (bf16 values are
  exact in TF32).
- Three remat steps with dropout on equal three plain steps (parameters
  within 5e-5), for the text and the history tower.
"""

import dataclasses

import numpy as np
import pytest
import torch

from xfmr_rec_torch.data.module import DataConfig, RecDataModule
from xfmr_rec_torch.data.prepare import prepare_movielens
from xfmr_rec_torch.data.synthetic import generate_movielens
from xfmr_rec_torch.index.ivf import IVFIndex
from xfmr_rec_torch.training import module as train_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def clustered(n, d, centres, seed):
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(centres, d))
    mus /= np.linalg.norm(mus, axis=1, keepdims=True)
    x = mus[rng.integers(0, centres, n)] + 0.04 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = mus[rng.integers(0, centres, 64)] + 0.04 * rng.normal(size=(64, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x.astype(np.float32), q.astype(np.float32)


def test_ivf_build_is_deterministic(card):
    x, _ = clustered(1 << 16, 64, 128, seed=1)
    first = IVFIndex(x, np.arange(len(x)), spill_factor=1.5, device=card)
    second = IVFIndex(x, np.arange(len(x)), spill_factor=1.5, device=card)
    np.testing.assert_array_equal(first._assign, second._assign)
    for name in ("centroids", "buckets", "positions", "radii"):
        assert torch.equal(getattr(first, name), getattr(second, name)), name
    assert (first.bucket_size, first.fill) == (second.bucket_size,
                                               second.fill)


@pytest.mark.parametrize("tf32", [False, True])
def test_bucket_scores_are_f32(card, tf32):
    x, q = clustered(1 << 15, 64, 64, seed=2)
    index = IVFIndex(x, np.arange(len(x)), nprobe=4, device=card)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        scores, ids, _ = index.search_certified(q, top_k=50)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert scores.dtype == np.float32
    served = torch.from_numpy(x).bfloat16().double().numpy()
    q_served = torch.from_numpy(q).bfloat16().double().numpy()
    exact = np.einsum("bd,bkd->bk", q_served, served[ids])
    # f32 sums of 64 products of unit-scale values: 64 * 2^-24
    np.testing.assert_allclose(scores, exact, rtol=0, atol=4e-6)
    rounded = torch.from_numpy(scores).bfloat16().float().numpy()
    assert (rounded != scores).mean() > 0.5


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    path = tmp_path_factory.mktemp("rematcard")
    generate_movielens(path, num_users=60, num_movies=200,
                       num_ratings=3000, seed=1)
    prepare_movielens(path)
    out = {}
    for history in (0, 8):
        dm = RecDataModule(DataConfig(data_dir=str(path), batch_size=64,
                                      max_length=32, vocab_size=2000,
                                      max_history=history))
        dm.setup()
        out[history] = [b for _, b in zip(range(3), dm.train_batches(0))]
    return out


@pytest.mark.parametrize("tower", ["text", "history"])
def test_remat_equals_plain_on_the_card(card, batches, tower):
    model = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=32, vocab_size=2000, max_length=32,
                 max_position_embeddings=64, dropout_rate=0.1)
    if tower == "history":
        model.update(user_tower="history", max_history=8, history_layers=2)
    config = train_mod.TrainConfig(**model)

    def run(cfg):
        state = train_mod.TrainState(cfg, seed=0, device=card)
        for batch in batches[cfg.max_history if tower == "history" else 0]:
            train_mod.train_step(state, train_mod.batch_to_device(batch,
                                                                   card))
        torch.cuda.synchronize()
        return state.model.state_dict(), state.generator.get_state()

    plain, plain_gen = run(config)
    remat, remat_gen = run(dataclasses.replace(config, remat=True))
    assert torch.equal(plain_gen, remat_gen)
    for name, value in plain.items():
        torch.testing.assert_close(remat[name], value, rtol=0, atol=5e-5)
