"""Port parity: `retrieval_metrics` (NDCG, Recall, Precision, MAP,
HitRate, MRR @ k) on the same predicted ids, targets and ratings.

Each input set has padded rows (targets zeroed, as the trainer does for
the fixed-shape last batch), a user with no target, duplicate-free
predictions with some hits and some misses, and graded ratings. Both
sides compute the same f32 sums of at most k terms, so they agree to
1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmr_rec_torch.training.metrics import METRIC_NAMES as PORT_NAMES
from xfmr_rec_torch.training.metrics import retrieval_metrics as port_metrics
from xfmr_rec_tpu.training.metrics import METRIC_NAMES as REF_NAMES
from xfmr_rec_tpu.training.metrics import retrieval_metrics as ref_metrics


def metric_inputs(seed, users=24, pred_width=12, max_targets=6, items=40):
    rng = np.random.default_rng(seed)
    pred = np.stack(
        [rng.permutation(np.arange(1, items + 1))[:pred_width]
         for _ in range(users)]
    ).astype(np.int32)
    target_ids = np.zeros((users, max_targets), np.int64)
    target_ratings = np.zeros((users, max_targets), np.float32)
    for u in range(users):
        n = int(rng.integers(0, max_targets + 1))
        ids = rng.choice(np.arange(1, items + 1), size=n, replace=False)
        if n and rng.random() < 0.6:  # plant a hit at a random rank
            ids[0] = pred[u, int(rng.integers(0, pred_width))]
            ids = np.unique(ids)
            n = len(ids)
        target_ids[u, :n] = ids
        target_ratings[u, :n] = np.sort(rng.integers(1, 6, n))[::-1]
    valid = np.ones(users, bool)
    valid[-3:] = False  # padded rows
    target_ids *= valid[:, None]
    target_ratings *= valid[:, None]
    return pred, target_ids, target_ratings


def test_metric_names_match():
    assert PORT_NAMES == REF_NAMES


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("top_k", [1, 5, 12])
def test_retrieval_metrics_match(seed, top_k):
    pred, target_ids, target_ratings = metric_inputs(seed)
    want = ref_metrics(
        jnp.asarray(pred), jnp.asarray(target_ids),
        jnp.asarray(target_ratings), top_k=top_k, prefix="val/",
    )
    got = port_metrics(
        torch.from_numpy(pred), torch.from_numpy(target_ids),
        torch.from_numpy(target_ratings), top_k=top_k, prefix="val/",
    )
    assert got.keys() == want.keys()
    for key in want:
        assert 0.0 <= float(got[key]) <= 1.0
        np.testing.assert_allclose(
            float(got[key]), float(want[key]), rtol=1e-6, atol=1e-6,
            err_msg=key,
        )


def test_all_padded_rows_give_zero():
    pred, target_ids, target_ratings = metric_inputs(3)
    got = port_metrics(
        torch.from_numpy(pred), torch.from_numpy(target_ids * 0),
        torch.from_numpy(target_ratings * 0), top_k=5,
    )
    assert all(float(v) == 0.0 for v in got.values())
