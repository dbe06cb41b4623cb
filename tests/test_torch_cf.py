"""Port parity: the factorized item-CF channel (`models/cf.py`).

The port's copy runs the same numpy and scipy calls in the same order as
the reference, so for one seed the factors, the popularity prior and the
user vectors are equal bit for bit, and `cf.npz` files cross between the
packages.
"""

import numpy as np
import pytest

from xfmr_rec_torch.models.cf import CFChannel as PortCF
from xfmr_rec_torch.models.cf import factorize_item_cf as port_factorize
from xfmr_rec_tpu.models.cf import CFChannel, factorize_item_cf


def interactions(n_users, n_items, per_user, seed):
    rng = np.random.default_rng(seed)
    return {
        u: sorted(rng.choice(n_items, size=per_user, replace=False).tolist())
        for u in range(n_users)
    }


@pytest.mark.parametrize(
    "n_users,n_items,per_user,rank,seed",
    [(60, 40, 6, 8, 0), (120, 200, 10, 32, 3), (30, 12, 4, 12, 1)],
)
def test_factorization_equal(n_users, n_items, per_user, rank, seed):
    inter = interactions(n_users, n_items, per_user, seed)
    want = factorize_item_cf(inter, n_items, rank=rank, seed=seed)
    got = port_factorize(inter, n_items, rank=rank, seed=seed)
    for name in ("item_factors", "hist_factors", "pop_prior"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.rank == want.rank and got.num_items == want.num_items


def test_user_vectors_equal():
    inter = interactions(50, 30, 5, 7)
    want = factorize_item_cf(inter, 30, rank=6, seed=2)
    got = port_factorize(inter, 30, rank=6, seed=2)
    rng = np.random.default_rng(8)
    positions = rng.integers(-1, 32, size=(9, 5))  # -1 and 30, 31: masked
    positions[0] = -1  # a cold user: zero vector
    for normalize in (True, False):
        np.testing.assert_array_equal(
            got.user_vectors(positions, normalize=normalize),
            want.user_vectors(positions, normalize=normalize),
        )
    assert not got.user_vectors(positions)[0].any()
    np.testing.assert_array_equal(got.user_vectors(positions[3]),
                                  want.user_vectors(positions[3]))


def test_cf_npz_crosses_packages(tmp_path):
    inter = interactions(40, 25, 5, 4)
    port_factorize(inter, 25, rank=5).save(tmp_path / "port.npz")
    factorize_item_cf(inter, 25, rank=5).save(tmp_path / "ref.npz")
    a, b = CFChannel.load(tmp_path / "port.npz"), PortCF.load(
        tmp_path / "ref.npz"
    )
    np.testing.assert_array_equal(a.item_factors, b.item_factors)
    np.testing.assert_array_equal(a.pop_prior, b.pop_prior)
