"""The plain reference against brute force at tiny sizes."""

from __future__ import annotations

import itertools
import math

import numpy as np
import pytest
import torch

from benchmark.reference import bert, losses, movielens, search, tokenizer
from benchmark.reference.train import run_steps

TINY = {"vocab_size": 50, "hidden_size": 8, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 12,
        "max_position_embeddings": 16, "layer_norm_eps": 1e-12,
        "dropout_rate": 0.1, "max_length": 6, "train_loss": "PairwiseHingeLoss",
        "num_negatives": 2, "sigma": 1.0, "margin": 1.0,
        "learning_rate": 1e-2, "weight_decay": 0.01}


def test_tokenizer_by_hand():
    # FNV-1a 64 of "a" from the offset basis xor the first seed
    h = (0xCBF29CE484222325 ^ 0x9E3779B97F4A7C15)
    h = ((h ^ ord("a")) * 0x100000001B3) % (1 << 64)
    ids = tokenizer.encode(["A b's!", ""], 30522, 4)
    assert ids[0, 0] == tokenizer.CLS_ID
    assert ids[0, 1] == 2 + h % 30520
    assert ids[0, 2] == tokenizer.token_id("b's", 30522)
    assert list(ids[0, 3:]) == [0]
    assert list(ids[1]) == [1, 0, 0, 0]


def test_exact_topk_and_gap_against_a_sort():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(5, 4, generator=gen)
    c = torch.randn(40, 4, generator=gen)
    scores = q @ c.T
    values, positions = search.exact_topk(q, c, 3, block=2)
    want = torch.sort(scores, dim=1, descending=True)
    assert torch.equal(values, want.values[:, :3])
    assert torch.equal(positions, want.indices[:, :3])
    assert search.answer_gap(q, c, positions, 3, block=2) == 0.0
    worse = positions.clone()
    worse[1, 2] = want.indices[1, 10]
    gap = float(want.values[1, 2] - want.values[1, 10])
    assert search.answer_gap(q, c, worse, 3) == pytest.approx(gap)
    duplicate = positions.clone()
    duplicate[0, 1] = duplicate[0, 0]
    assert math.isinf(search.answer_gap(q, c, duplicate, 3))


def _naive_encode(w, tokens, cfg):
    """Token by token, head by head, in float64."""
    heads = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // heads
    out = []
    w = {k: v.double() for k, v in w.items()}

    def ln(x, a, b):
        mu = x.mean()
        return (x - mu) / torch.sqrt(((x - mu) ** 2).mean() + 1e-12) * a + b

    for row in tokens.tolist():
        real = [i for i, t in enumerate(row) if t != 0]
        x = [ln(w["word"][t] + w["pos"][i], w["emb_ln.w"], w["emb_ln.b"])
             for i, t in enumerate(row)]
        for layer in range(cfg["num_hidden_layers"]):
            p = f"l{layer}."
            q = [xi @ w[p + "q.w"] + w[p + "q.b"] for xi in x]
            k = [xi @ w[p + "k.w"] + w[p + "k.b"] for xi in x]
            v = [xi @ w[p + "v.w"] + w[p + "v.b"] for xi in x]
            new = []
            for i in range(len(x)):
                ctx = []
                for h in range(heads):
                    s = slice(h * hd, (h + 1) * hd)
                    logits = torch.stack([q[i][s] @ k[j][s] / math.sqrt(hd)
                                          for j in real])
                    a = torch.softmax(logits, 0)
                    ctx.append(sum(a[n] * v[j][s] for n, j in enumerate(real)))
                attn = torch.cat(ctx) @ w[p + "o.w"] + w[p + "o.b"]
                y = ln(x[i] + attn, w[p + "ln1.w"], w[p + "ln1.b"])
                f = torch.nn.functional.gelu(y @ w[p + "ffn1.w"] + w[p + "ffn1.b"])
                f = f @ w[p + "ffn2.w"] + w[p + "ffn2.b"]
                new.append(ln(y + f, w[p + "ln2.w"], w[p + "ln2.b"]))
            x = new
        pooled = sum(x[i] for i in real) / len(real)
        out.append(pooled / pooled.norm())
    return torch.stack(out).float()


def test_encoder_against_a_naive_loop():
    w = bert.make_weights(TINY, 3, torch.device("cpu"))
    tokens = torch.tensor([[1, 5, 9, 0, 0, 0], [1, 7, 7, 7, 3, 2]])
    got = bert.encode(w, tokens, TINY)
    assert torch.allclose(got, _naive_encode(w, tokens, TINY), atol=1e-5)


def test_lower_precision_moves_the_encoder():
    w = bert.make_weights(TINY, 3, torch.device("cpu"))
    tokens = torch.tensor([[1, 5, 9, 4, 0, 0]])
    exact = bert.encode(w, tokens, TINY)
    low = bert.encode(w, tokens, TINY, precision="float8_e4m3fn")
    assert 1e-3 < float((exact - low).abs().max()) < 0.5


def _naive_pairwise(users, items, target, item_idx, pos_idx, k, margin):
    total = 0.0
    for r in range(len(users)):
        d = [0.5 * float(((users[r] - it) ** 2).sum()) for it in items]
        logit = [-x * np.sign(target[r]) for x in d]
        valid = [j for j in range(len(items)) if item_idx[j] != item_idx[r]
                 and item_idx[j] not in set(pos_idx[r].tolist()) - {0}]
        rel = [logit[j] - logit[r] for j in range(len(items))]
        low = min(rel)
        pref = {j: (rel[j] - low if rel[j] < 0 else -rel[j]) for j in valid}
        kept = sorted(valid, key=lambda j: (-pref[j], j))[:k]
        if kept:
            terms = [max(logit[j] - logit[r] + margin, 0.0) for j in kept]
            total += abs(target[r]) * sum(terms) / len(kept)
    return total


def test_pairwise_loss_against_loops():
    gen = torch.Generator().manual_seed(1)
    users = torch.nn.functional.normalize(torch.randn(4, 3, generator=gen), dim=1)
    items = torch.nn.functional.normalize(torch.randn(8, 3, generator=gen), dim=1)
    target = torch.tensor([5.0, 3.0, 4.0, 1.0])
    item_idx = torch.tensor([1, 2, 3, 1, 4, 5, 2, 6])
    pos_idx = torch.tensor([[1, 4, 0], [2, 0, 0], [3, 5, 6], [1, 0, 0]])
    got = losses.pairwise_loss("PairwiseHingeLoss", users, items, target,
                               item_idx, pos_idx, num_negatives=2, sigma=1.0,
                               margin=1.0)
    want = _naive_pairwise(users, items, target.numpy(), item_idx.tolist(),
                           pos_idx, 2, 1.0)
    assert float(got) == pytest.approx(want, rel=1e-5)


def test_adamw_steps_equal_torch_adamw():
    w0 = bert.make_weights(TINY, 4, torch.device("cpu"))
    gen = torch.Generator().manual_seed(2)
    batches = [{
        "user_tokens": torch.randint(1, 50, (3, 6), generator=gen),
        "item_tokens": torch.randint(1, 50, (3, 6), generator=gen),
        "neg_item_tokens": torch.randint(1, 50, (3, 6), generator=gen),
        "target": torch.tensor([4.0, 5.0, 3.0]),
        "item_idx": torch.tensor([1, 2, 3, 4, 5, 6]),
        "pos_idx": torch.tensor([[1, 0], [2, 0], [3, 0]]),
    } for _ in range(2)]
    cfg = dict(TINY, dropout_rate=0.0)
    got = run_steps(w0, batches, cfg, dropout_seed=0)
    params = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    opt = torch.optim.AdamW(params.values(), lr=cfg["learning_rate"],
                            weight_decay=cfg["weight_decay"], eps=1e-8)
    for batch in batches:
        opt.zero_grad()
        tokens = torch.cat([batch["user_tokens"], batch["item_tokens"],
                            batch["neg_item_tokens"]])
        e = bert.encode(params, tokens, cfg)
        loss = losses.pairwise_loss(
            cfg["train_loss"], e[:3], e[3:], batch["target"], batch["item_idx"],
            batch["pos_idx"], num_negatives=2, sigma=1.0, margin=1.0)
        loss.backward()
        opt.step()
    for name, value in params.items():
        assert torch.allclose(got["weights"][name], value, atol=1e-6), name


def test_dropout_masks_follow_the_generator():
    w = bert.make_weights(TINY, 3, torch.device("cpu"))
    tokens = torch.tensor([[1, 5, 9, 4, 0, 0]])
    runs = [bert.encode(w, tokens, TINY,
                        generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_corpus_files_read_back(tmp_path):
    movielens.write_ml1m(tmp_path, 11, movies=30, users=20, wanted=200)
    corpus = movielens.read_ml1m(tmp_path)
    assert len(corpus["movies"]) == 30 and len(corpus["users"]) == 20
    texts = movielens.Catalogue(np.random.default_rng(11), 30, 20)
    assert list(corpus["movies"].values()) == texts.movie_texts()
    assert list(corpus["users"].values()) == texts.user_texts()
    pairs = [(u, m) for u, m, _ in corpus["rated"]]
    assert len(pairs) == len(set(pairs))
    assert all(1 <= r <= 5 for _, _, r in corpus["rated"])
    assert list(itertools.islice(corpus["movies"], 3)) == [1, 2, 3]
