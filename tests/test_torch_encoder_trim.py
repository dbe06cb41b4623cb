"""Training batches run only as wide as their text (`run_width`).

`batch_to_device`, given the encoder's pooling mode, cuts the trailing
columns that are PAD in every row before the upload. The flax parity
tests hold the cut batch to the flax encoder and train step
(`test_torch_encoder.py`, `test_torch_train_step.py` and
`test_torch_history_train.py`, the `_cut` cases), with dropout off.
These tests cover what they cannot:

- dropout on, from one generator state: a cut batch against the same
  batch at its padded width, embeddings and every parameter gradient,
  with and without remat, in f32 (the two differ only in the order a
  GEMM sums its terms, as the cut columns add exact zeros: atol 1e-5
  on unit-norm embeddings, as the f32 parity tests, and 1e-5 of each
  gradient's largest entry);
- the generator ends where a padded forward leaves it (the masks are
  drawn at `max_length`);
- a batch that fills its width is uploaded whole and runs exactly the
  encoder's ops before the cut existed;
- `token_slots` counts the padded slots and those run;
- `run_width`'s rounding and its rules for a PAD inside a row, narrow
  inputs and PAD-only rows under first-token pooling.
"""

import numpy as np
import pytest
import torch

from xfmr_rec_torch.models.encoder import (
    ModelConfig,
    dropout,
    init_encoder,
    l2_normalize,
    run_layer,
    run_width,
)
from xfmr_rec_torch.training.module import batch_to_device

WIDTH = 32
CPU = torch.device("cpu")

TINY = dict(
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=64,
    max_position_embeddings=64,
    max_length=WIDTH,
    vocab_size=1000,
    dropout_rate=0.1,
    compute_dtype="float32",
)


def _encoder(**overrides):
    return init_encoder(ModelConfig(**{**TINY, **overrides}), seed=3)


def _short_rows(rows: int = 6, seed: int = 0) -> np.ndarray:
    """`rows` texts of 3 to 11 tokens (a PAD inside one), padded to WIDTH."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((rows, WIDTH), dtype=np.int32)
    for r in range(rows):
        n = 3 + r * 8 // max(rows - 1, 1)
        tokens[r, :n] = rng.integers(1, 1000, n)
    tokens[1, 1] = 0  # a PAD inside a row cuts nothing
    return tokens


def _with_full_last_row(tokens: np.ndarray) -> np.ndarray:
    out = tokens.copy()
    out[-1] = np.arange(1, WIDTH + 1)
    return out


def _cut(tokens: np.ndarray, pooling_mode: str = "mean") -> torch.Tensor:
    return batch_to_device({"item_tokens": tokens}, CPU, pooling_mode)[
        "item_tokens"
    ]


def _untrimmed(encoder, token_ids, generator):
    """The encoder's forward before the cut: every op at the input width."""
    cfg = encoder.config
    dtype = cfg.torch_dtype
    token_ids = token_ids.long()
    mask = token_ids != 0
    embeds = encoder.word_embed(token_ids, dtype)
    positions = torch.arange(token_ids.shape[-1])
    embeds = embeds + encoder.position_embed(positions, dtype)[None]
    hidden = encoder.embed_norm(embeds, dtype)
    hidden = dropout(hidden, cfg.dropout_rate, generator)
    mask_bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :]
    for layer in encoder.layers:
        hidden = run_layer(
            layer, hidden, mask_bias, dtype, generator, remat=cfg.remat
        )
    pooled = encoder._pool(hidden, mask, dtype).float()
    return l2_normalize(pooled) if cfg.normalize else pooled


def _embeds_and_grads(encoder, tokens):
    """Dropout on from seed 11: the embeddings and the parameter
    gradients of a fixed linear loss over them."""
    encoder.zero_grad(set_to_none=True)
    generator = torch.Generator().manual_seed(11)
    out = encoder(tokens, generator)
    weights = torch.randn(
        out.shape, generator=torch.Generator().manual_seed(5)
    )
    (out * weights).sum().backward()
    grads = {
        name: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
        for name, p in encoder.named_parameters()
    }
    return out.detach(), grads


@pytest.mark.parametrize("remat", [False, True])
def test_trim_on_equals_trim_off(remat):
    encoder = _encoder(remat=remat)
    short = _short_rows()
    cut = _cut(short)
    assert cut.shape == (6, 16)
    got, got_grads = _embeds_and_grads(encoder, cut)
    want, want_grads = _embeds_and_grads(encoder, torch.from_numpy(short))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for name, want_grad in want_grads.items():
        scale = float(want_grad.abs().max())
        torch.testing.assert_close(
            got_grads[name], want_grad, rtol=0, atol=1e-5 * max(scale, 1e-6),
            msg=lambda m, name=name: f"{name}: {m}",
        )


@pytest.mark.parametrize("remat", [False, True])
def test_generator_ends_where_untrimmed_does(remat):
    encoder = _encoder(remat=remat)
    short = _short_rows()
    states = []
    for tokens in (_cut(short), torch.from_numpy(short)):
        generator = torch.Generator().manual_seed(11)
        encoder(tokens, generator).sum().backward()
        states.append(generator.get_state())
    assert encoder.token_slots["run"] < encoder.token_slots["padded"]
    assert torch.equal(states[0], states[1])


@pytest.mark.parametrize("pooling_mode", ["mean", "max", "cls", "pooler"])
@pytest.mark.parametrize("dropout_on", [False, True])
def test_full_width_batch_runs_untrimmed_ops(pooling_mode, dropout_on):
    encoder = _encoder(pooling_mode=pooling_mode, compute_dtype="bfloat16")
    host = _with_full_last_row(_short_rows())
    tokens = _cut(host, pooling_mode)
    assert torch.equal(tokens, torch.from_numpy(host))

    def generator():
        return torch.Generator().manual_seed(2) if dropout_on else None

    got = encoder(tokens, generator())
    want = _untrimmed(encoder, tokens, generator())
    assert torch.equal(got, want)


def test_token_slots_count_padded_and_run():
    encoder = _encoder()
    with torch.no_grad():
        encoder(_cut(_short_rows(rows=6)))
        assert encoder.token_slots == {"padded": 6 * WIDTH, "run": 6 * 16}
        encoder(_cut(_with_full_last_row(_short_rows(rows=4))))
    assert encoder.token_slots == {
        "padded": 6 * WIDTH + 4 * WIDTH,
        "run": 6 * 16 + 4 * WIDTH,
    }


def test_batch_to_device_cuts_every_text_field_to_one_width():
    """One width over every `*_tokens` field, the history's (B, H, L)
    too; other fields untouched; nothing cut without a pooling mode."""
    users = _short_rows(rows=4)
    hist = np.zeros((4, 3, WIDTH), dtype=np.int32)
    hist[2, 1, :19] = 9
    batch = {
        "user_tokens": users,
        "item_tokens": _short_rows(rows=4, seed=1),
        "hist_tokens": hist,
        "target": np.arange(4 * WIDTH, dtype=np.float32).reshape(4, WIDTH),
    }
    got = batch_to_device(batch, CPU, "mean")
    assert got["user_tokens"].shape == (4, 24)
    assert got["hist_tokens"].shape == (4, 3, 24)
    assert torch.equal(got["hist_tokens"], torch.from_numpy(hist[..., :24]))
    assert torch.equal(got["target"], torch.from_numpy(batch["target"]))
    whole = batch_to_device(batch, CPU)
    for key, value in batch.items():
        assert torch.equal(whole[key], torch.from_numpy(value))


@pytest.mark.parametrize(
    ("last", "width"),
    [(0, 8), (1, 8), (8, 8), (9, 16), (11, 16), (17, 24), (25, 32), (31, 32)],
)
def test_run_width_rounds_up_to_eight(last, width):
    tokens = np.zeros((3, WIDTH), dtype=np.int64)
    tokens[1, :last] = 7
    assert run_width([tokens], "mean") == width


def test_pad_inside_a_row_cuts_nothing():
    """The width follows the last occupied position, not a token count:
    9 positions with a PAD among them still run at 16, and the cut batch
    equals the padded one."""
    encoder = _encoder()
    tokens = np.zeros((6, WIDTH), dtype=np.int32)
    tokens[:, :9] = np.arange(1, 10)
    tokens[:, 3] = 0
    assert run_width([tokens], "mean") == 16
    with torch.no_grad():
        torch.testing.assert_close(
            encoder(_cut(tokens)), encoder(torch.from_numpy(tokens)),
            rtol=0, atol=1e-5,
        )


def test_run_width_keeps_narrow_and_odd_inputs():
    assert run_width([np.ones((2, 8), dtype=np.int64)], "mean") == 8
    tokens = np.zeros((2, 12), dtype=np.int64)
    tokens[0, :10] = 5
    assert run_width([tokens], "mean") == 12


@pytest.mark.parametrize("pooling_mode", ["cls", "pooler"])
def test_pad_only_row_keeps_width_under_first_token_pooling(pooling_mode):
    """A row of PAD alone pools position 0, which attends evenly over
    every column: under `cls` / `pooler` such a batch keeps its width."""
    tokens = _short_rows()
    tokens[2] = 0
    assert run_width([tokens], pooling_mode) == WIDTH
    assert run_width([_short_rows(), tokens], pooling_mode) == WIDTH
    assert run_width([tokens], "mean") == 16
