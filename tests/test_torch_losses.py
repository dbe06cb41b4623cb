"""Port parity: the loss family, accidental-hit masking and mining.

The same numpy-seeded embeddings, targets, item indices and positive
sets go through `xfmr_rec_tpu.ops.losses` (values and `jax.grad`) and
`xfmr_rec_torch.ops.losses` (values and `torch.autograd`), in f32 at
B = 16. Both sides run the same f32 arithmetic up to summation order, so
values and gradients agree to 1e-5 relative (the largest seen here is
under 1e-6), with 1e-6 absolute for entries near 0.

Mining selections are boolean and must be identical, ties included:
`_restrict_to_topk` against the reference's on rows full of ties, on rows
with -inf entries and on a row that is entirely -inf, in both branches
(k <= 32 argmax passes, k > 32 sort); and against the set `lax.top_k`
picks on every row with at least k finite scores. (With fewer, the
argmax passes keep re-selecting index 0 where `lax.top_k` takes further
-inf entries; mining feeds the passes -inf exactly where the mask is
False, so the masked result is the same.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmr_rec_torch.ops import losses as port_losses
from xfmr_rec_torch.ops import masking as port_masking
from xfmr_rec_torch.ops import similarity as port_similarity
from xfmr_rec_tpu.ops import losses as ref_losses
from xfmr_rec_tpu.ops import masking as ref_masking
from xfmr_rec_tpu.ops import similarity as ref_similarity

B, D = 16, 8
RTOL, ATOL = 1e-5, 1e-6


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def inputs(seed, duplicate_items=False):
    rng = np.random.default_rng(seed)
    user = _unit(rng.standard_normal((B, D)))
    item = _unit(rng.standard_normal((2 * B, D)))
    target = rng.integers(-2, 6, B).astype(np.float32)
    target[target == 0] = 3.0
    item_idx = rng.integers(1, 20, 2 * B).astype(np.int64)
    if duplicate_items:
        item_idx[:] = 7
    pos_idx = np.zeros((B, 5), np.int64)
    pos_idx[:, :3] = rng.integers(1, 20, (B, 3))
    log_q = rng.standard_normal(2 * B).astype(np.float32)
    return user, item, target, item_idx, pos_idx, log_q


def both(name, data, **config):
    user, item, target, item_idx, pos_idx, log_q = data
    ref_config = ref_losses.LossConfig(**config)

    def ref(u, i):
        return ref_losses.LOSSES[name](
            u,
            i,
            jnp.asarray(target),
            item_idx=jnp.asarray(item_idx),
            pos_idx=jnp.asarray(pos_idx),
            config=ref_config,
            log_q=jnp.asarray(log_q),
        )

    value, (g_user, g_item) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(user), jnp.asarray(item)
    )
    t_user = torch.tensor(user, requires_grad=True)
    t_item = torch.tensor(item, requires_grad=True)
    got = port_losses.LOSSES[name](
        t_user,
        t_item,
        torch.from_numpy(target),
        item_idx=torch.from_numpy(item_idx),
        pos_idx=torch.from_numpy(pos_idx),
        config=port_losses.LossConfig(**config),
        log_q=torch.from_numpy(log_q),
    )
    got.backward()
    return (
        (float(value), np.asarray(g_user), np.asarray(g_item)),
        (float(got.detach()), t_user.grad.numpy(), t_item.grad.numpy()),
    )


def test_registry_names_match():
    assert tuple(port_losses.LOSSES) == tuple(ref_losses.LOSSES)
    assert port_losses.LOSS_NAMES == ref_losses.LOSS_NAMES


@pytest.mark.parametrize("name", ref_losses.LOSS_NAMES)
@pytest.mark.parametrize("num_negatives", [0, 4])
@pytest.mark.parametrize("logq", [False, True])
def test_loss_values_and_grads(name, num_negatives, logq):
    want, got = both(
        name,
        inputs(num_negatives + 10 * logq),
        num_negatives=num_negatives,
        use_logq_correction=logq,
        margin=0.3,
        gamma=0.7,
        gamma_user=1.3,
    )
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    for g_got, g_want in zip(got[1:], want[1:], strict=True):
        scale = max(np.abs(g_want).max(), 1e-6)
        np.testing.assert_allclose(g_got, g_want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("name", ref_losses.LOSS_NAMES)
def test_fully_masked_rows(name):
    """Every candidate an accidental hit: the masked losses are 0 and no
    loss backpropagates NaN; all agree with the reference."""
    want, got = both(
        name, inputs(3, duplicate_items=True), num_negatives=4,
        use_logq_correction=True,
    )
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    if name in (
        "ContrastiveLoss",
        "InfomationNoiseContrastiveEstimationLoss",
        "MutualInformationNeuralEstimationLoss",
        "PairwiseHingeLoss",
        "PairwiseLogisticLoss",
    ):
        assert got[0] == 0.0
    for grad in got[1:]:
        assert np.isfinite(grad).all()


def test_compute_losses_shares_one_pass():
    user, item, target, item_idx, pos_idx, log_q = inputs(5)
    config = port_losses.LossConfig(num_negatives=4)
    args = (torch.from_numpy(user), torch.from_numpy(item),
            torch.from_numpy(target))
    kw = dict(item_idx=torch.from_numpy(item_idx),
              pos_idx=torch.from_numpy(pos_idx), config=config,
              log_q=torch.from_numpy(log_q))
    together = port_losses.compute_losses(*args, **kw)
    assert tuple(together) == port_losses.LOSS_NAMES
    for name, value in together.items():
        assert float(value) == pytest.approx(
            float(port_losses.LOSSES[name](*args, **kw)), rel=1e-6, abs=1e-6
        )
    only = port_losses.compute_losses(
        *args, **kw, names=("PairwiseHingeLoss",)
    )
    assert tuple(only) == ("PairwiseHingeLoss",)


def test_squared_distance_and_weighted_mean():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((5, 7)).astype(np.float32)
    c = rng.standard_normal((9, 7)).astype(np.float32)
    w = (rng.random((5, 9)) > 0.5).astype(np.float32)
    w[2] = 0.0
    np.testing.assert_allclose(
        port_similarity.squared_distance(
            torch.from_numpy(q), torch.from_numpy(c)
        ).numpy(),
        np.asarray(ref_similarity.squared_distance(q, c)),
        rtol=1e-5, atol=1e-5,
    )
    for dim in (None, -1):
        np.testing.assert_allclose(
            port_similarity.weighted_mean(
                torch.from_numpy(q @ c.T), torch.from_numpy(w), dim=dim
            ).numpy(),
            np.asarray(ref_similarity.weighted_mean(q @ c.T, w, axis=dim)),
            rtol=1e-6, atol=1e-6,
        )


def tied_scores(seed, rows, cols):
    """Small integer scores (many ties), some entries and one whole row
    at -inf, and a random mask."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 4, (rows, cols)).astype(np.float32)
    scores[rng.random((rows, cols)) < 0.2] = -np.inf
    scores[1] = -np.inf
    masks = rng.random((rows, cols)) < 0.7
    return scores, masks


@pytest.mark.parametrize("k", [1, 4, 32, 33, 40])
def test_restrict_to_topk_matches_lax_top_k_on_ties(k):
    scores, masks = tied_scores(k, 6, 64)
    got = port_masking._restrict_to_topk(
        torch.from_numpy(masks), torch.from_numpy(scores), k
    ).numpy()
    want = np.asarray(
        ref_masking._restrict_to_topk(
            jnp.asarray(masks), jnp.asarray(scores), k
        )
    )
    np.testing.assert_array_equal(got, want)
    _, idx = jax.lax.top_k(jnp.asarray(scores), k)
    selected = np.zeros_like(masks)
    np.put_along_axis(selected, np.asarray(idx), True, axis=1)
    full = np.isfinite(scores).sum(axis=1) >= k
    assert full.sum() >= 4
    np.testing.assert_array_equal(got[full], (masks & selected)[full])


@pytest.mark.parametrize("mining", ["hard_mining", "semi_hard_mining"])
@pytest.mark.parametrize("num_negatives", [0, 3, 40, 64])
def test_mining_matches(mining, num_negatives):
    user, item, target, item_idx, pos_idx, _ = inputs(7)
    rng = np.random.default_rng(8)
    user = np.repeat(user, 3, axis=0)[:B]  # tied logits across rows
    logits = -np.asarray(ref_similarity.squared_distance(user, item))
    logits = np.round(logits * 4) / 4  # ties inside rows
    logits *= np.sign(target)[:, None]
    ref_mask = ref_masking.negative_masks(
        jnp.asarray(logits), item_idx=jnp.asarray(item_idx),
        pos_idx=jnp.asarray(pos_idx),
    )
    port_mask = port_masking.negative_masks(
        torch.from_numpy(logits), item_idx=torch.from_numpy(item_idx),
        pos_idx=torch.from_numpy(pos_idx),
    )
    np.testing.assert_array_equal(port_mask.numpy(), np.asarray(ref_mask))
    ref_mask = np.asarray(ref_mask) & (rng.random(ref_mask.shape) < 0.9)
    want = getattr(ref_masking, mining)(
        jnp.asarray(logits), jnp.asarray(ref_mask),
        num_negatives=num_negatives,
    )
    got = getattr(port_masking, mining)(
        torch.from_numpy(logits), torch.from_numpy(ref_mask),
        num_negatives=num_negatives,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_negative_masks_match_the_pairwise_compare(seed):
    """The binary search gives the booleans of comparing every candidate
    with every positive, pads, duplicates and a 0 index included."""
    rng = np.random.default_rng(seed)
    batch, positives = 6, 9
    item_idx = rng.integers(0, 15, 2 * batch)
    pos_idx = rng.integers(0, 15, (batch, positives))
    pos_idx[:, -3:] = 0
    got = port_masking.negative_masks(
        torch.zeros(batch, 2 * batch), item_idx=torch.from_numpy(item_idx),
        pos_idx=torch.from_numpy(pos_idx),
    ).numpy()
    hits = item_idx[:batch, None] == item_idx[None, :]
    hits |= (pos_idx[:, None, :] == item_idx[None, :, None]).any(axis=-1)
    np.testing.assert_array_equal(got, ~hits)
