"""Port parity: the history and bag fields of the batches, and the user
store.

- With `max_history` and `max_bag` set, the first batches of
  `train_batches`, `eval_interaction_batches` and `eval_batches` equal
  the reference's field by field, dtype and value (`hist_tokens`,
  `hist_mask`, `hist_ratings`, `hist_rns`, `hist_positions`, `bag_rns`,
  `bag_ratings`, `bag_mask`; the row's own positive masked out of its
  bag), and so do the history tables and `train_history_item_ids`.
- The user store built from the port's prepared tables, and the one
  converted from the reference's `users.parquet`, answer `get(user_id)`
  with the `UserQuery` the reference engine builds from that parquet.
"""

import dataclasses
import itertools

import numpy as np
import pandas as pd
import pytest

from xfmr_rec_torch.data import prepare as port_prepare
from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.serving.users import UserStore
from xfmr_rec_tpu.data.module import DataConfig, RecDataModule
from xfmr_rec_tpu.data.prepare import prepare_movielens
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.serving.engine import _activity_list
from xfmr_rec_tpu.serving.schemas import UserQuery as RefUserQuery


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("histdata")
    generate_movielens(root, num_users=45, num_movies=80, num_ratings=1400,
                       seed=6)
    prepare_movielens(str(root), overwrite=True)
    port_prepare.prepare_movielens(root, overwrite=True)
    return root


def assert_batches_equal(got, want, count):
    got = list(itertools.islice(got, count))
    want = list(itertools.islice(want, count))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize(
    "widths",
    [dict(max_history=4), dict(max_history=6, max_bag=5),
     dict(max_history=1, max_bag=40)],
    ids=["history", "history-bag", "short-history-long-bag"],
)
def test_history_batches_equal(corpus, widths):
    kw = dict(data_dir=str(corpus), batch_size=8, eval_batch_size=8,
              max_length=16, vocab_size=600, **widths)
    port = PortDataModule(PortDataConfig(**kw))
    port.setup()
    ref = RecDataModule(DataConfig(**kw))
    ref.setup()
    for epoch in (0, 1):
        assert_batches_equal(port.train_batches(epoch),
                             ref.train_batches(epoch), 3)
    for subset in ("val", "test"):
        assert_batches_equal(port.eval_interaction_batches(subset),
                             ref.eval_interaction_batches(subset), 2)
        assert_batches_equal(port.eval_batches(subset),
                             ref.eval_batches(subset), 2)
    for name in ("train_hist_pos", "train_hist_rating", "user_hist_pos",
                 "user_hist_rating", "user_bag_pos", "user_bag_rating"):
        if hasattr(ref, name):
            np.testing.assert_array_equal(getattr(port, name),
                                          getattr(ref, name), err_msg=name)
    for upos in (0, 7, port.num_users - 1):
        assert port.train_history_item_ids(upos) == (
            ref.train_history_item_ids(upos)
        )
    batch = next(port.train_batches(0))
    if "bag_mask" in batch:
        own = batch["bag_rns"] == batch["item_idx"][: len(batch["bag_rns"]),
                                                    None]
        assert not (own & batch["bag_mask"]).any()


def ref_users(corpus):
    return pd.read_parquet(corpus / "ml-1m" / "users.parquet")


def ref_user_query(row):
    return RefUserQuery(
        user_rn=int(row["user_rn"]), user_id=int(row["user_id"]),
        user_text=str(row["user_text"]),
        history=_activity_list(row.get("history")),
        target=_activity_list(row.get("target")),
    )


@pytest.mark.parametrize("source", ["prepared", "parquet"])
def test_user_store_equals_reference(corpus, tmp_path, source):
    rows = ref_users(corpus).to_dict("records")
    store = (UserStore.from_prepared(corpus) if source == "prepared"
             else UserStore.from_rows(rows))
    store.save(tmp_path / "users.npz")
    store = UserStore.load(tmp_path / "users.npz")
    assert len(store) == len(rows)
    for row in rows:
        want = ref_user_query(row).model_dump()
        got = dataclasses.asdict(store.get(int(row["user_id"])))
        assert got == want
    assert sum(len(store.get(r["user_id"]).history) for r in rows) > 0


def test_unknown_user_raises(corpus):
    from xfmr_rec_torch.serving.schemas import NotFoundError

    store = UserStore.from_prepared(corpus)
    with pytest.raises(NotFoundError):
        store.get(10**9)
