"""Port parity: the synthetic corpus, the pandas-free ETL and the batches.

- The port's generator writes byte-identical `.dat` files for a seed.
- The port's prepared tables equal the reference's parquet tables column
  by column (exactly: ids, flags, row numbers, history ranges and text),
  on a small synthetic corpus and on hand-written `.dat` fixtures with
  tied timestamps inside one user, a one-rating user, a movie nobody
  rated, a title with a colon, and zipcodes in both forms (all numeric
  with a leading zero, which pandas reads as integers, and one with a
  hyphen, which keeps every zipcode as written).
- The first batches of `train_batches` (two epochs),
  `eval_interaction_batches` and `eval_batches` are equal field by
  field, dtype and value, for the hashing and the vocab tokenizer.
"""

import itertools

import numpy as np
import pandas as pd
import pytest

from xfmr_rec_torch.data import prepare as port_prepare
from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.data.synthetic import generate_movielens as port_generate
from xfmr_rec_torch.models.tokenizer import build_vocab as port_build_vocab
from xfmr_rec_tpu.data.module import DataConfig, RecDataModule
from xfmr_rec_tpu.data.prepare import prepare_movielens
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.models.tokenizer import build_vocab

RAW = ("movies.dat", "users.dat", "ratings.dat")

MOVIES_DAT = """\
1::Toy Story (1995)::Animation|Children's|Comedy
2::Star Wars: Episode IV - A New Hope (1977)::Action|Adventure|Sci-Fi
3::Heat (1995)::Action|Crime|Thriller
4::Nobody Watched This (2000)::Drama
5::Fargo (1996)::Crime|Drama|Thriller
6::Alien (1979)::Horror|Sci-Fi
"""
USERS_DAT = """\
1::F::1::10::48067
2::M::56::16::02460
3::M::25::15::{zip3}
4::M::45::7::02460
5::F::35::1::10001
6::F::18::4::90210
"""
# user 1 has tied timestamps; user 2 one rating; movie 4 is unrated;
# lines are not in (user, time) order
RATINGS_DAT = """\
1::1::5::978300760
3::2::4::978300100
1::2::3::978300760
1::3::4::978300760
2::5::5::978299000
1::5::2::978301000
3::3::2::978300200
4::1::3::978302000
5::1::4::978302100
5::2::5::978302200
5::3::1::978302300
4::6::4::978302400
5::5::3::978302500
5::6::2::978302600
3::5::5::978300300
6::2::4::978303000
6::3::3::978303100
4::3::5::978302050
1::6::1::978300900
3::6::3::978300050
"""


def fixture_corpus(root, zip3):
    raw = root / "ml-1m"
    raw.mkdir(parents=True)
    (raw / "movies.dat").write_text(MOVIES_DAT, encoding="iso-8859-1")
    (raw / "users.dat").write_text(
        USERS_DAT.format(zip3=zip3), encoding="iso-8859-1"
    )
    (raw / "ratings.dat").write_text(RATINGS_DAT, encoding="iso-8859-1")
    return root


@pytest.fixture(scope="module", params=["synthetic", "zip-int", "zip-hyphen"])
def corpus(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    if request.param == "synthetic":
        generate_movielens(
            root, num_users=50, num_movies=90, num_ratings=1500, seed=4
        )
    else:
        fixture_corpus(root, "55117" if request.param == "zip-int"
                       else "55455-1234")
    prepare_movielens(str(root), overwrite=True)
    port_prepare.prepare_movielens(root, overwrite=True)
    return root


@pytest.mark.parametrize("text_signal", [False, True])
def test_synthetic_files_byte_identical(tmp_path, text_signal):
    kw = dict(num_users=70, num_movies=120, num_ratings=2500, seed=9,
              text_signal=text_signal)
    generate_movielens(tmp_path / "ref", **kw)
    port_generate(tmp_path / "port", **kw)
    for name in RAW:
        assert (tmp_path / "ref" / "ml-1m" / name).read_bytes() == (
            tmp_path / "port" / "ml-1m" / name
        ).read_bytes()


@pytest.mark.parametrize("table", ["movies", "users", "ratings"])
def test_prepared_tables_equal_pandas(corpus, table):
    want = pd.read_parquet(corpus / "ml-1m" / f"{table}.parquet")
    got = port_prepare.load_table(corpus, table)
    assert len(next(iter(got.values()))) == len(want)
    for column, values in got.items():
        ref = want[column].to_numpy()
        if values.dtype.kind == "U":
            assert values.tolist() == ref.tolist(), column
        else:
            assert values.dtype == ref.dtype, column
            np.testing.assert_array_equal(values, ref, err_msg=column)
    if table == "ratings":
        movies = port_prepare.load_table(corpus, "movies")
        users = port_prepare.load_table(corpus, "users")
        assert (
            movies["movie_text"][got["movie_rn"] - 1].tolist()
            == want["movie_text"].tolist()
        )
        assert (
            users["user_text"][got["user_rn"] - 1].tolist()
            == want["user_text"].tolist()
        )


def test_fixture_cases_are_present(tmp_path):
    """The fixture exercises what it claims to, through the port's ETL."""
    for zip3, zips in (
        ("55117", ["48067", "2460", "55117", "2460", "10001", "90210"]),
        ("55455-1234",
         ["48067", "02460", "55455-1234", "02460", "10001", "90210"]),
    ):
        root = fixture_corpus(tmp_path / zip3, zip3)
        port_prepare.prepare_movielens(root)
        users = port_prepare.load_table(root, "users")
        texts = [t.split('"zipcode":"')[1][:-2] for t in users["user_text"]]
        assert texts == zips
        movies = port_prepare.load_table(root, "movies")
        assert not movies["is_train"][3]  # nobody rated movie 4
        assert '"title":"Star Wars: Episode IV' in movies["movie_text"][1]
        ratings = port_prepare.load_table(root, "ratings")
        assert (ratings["user_id"] == 2).sum() == 1
        first = ratings["user_id"] == 1
        assert len(set(ratings["timestamp"][first])) < first.sum()


def test_build_vocab_matches():
    texts = ['{"title":"A B (1995)"}', "b b c", "Zed's zed, zed", ""]
    for vocab_size, oov in ((40, 2), (6, 2), (4, 2)):
        assert port_build_vocab(
            texts, vocab_size=vocab_size, oov_buckets=oov
        ) == build_vocab(texts, vocab_size=vocab_size, oov_buckets=oov)


def _assert_batches_equal(got, want, count):
    got = list(itertools.islice(got, count))
    want = list(itertools.islice(want, count))
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    return len(got)


@pytest.mark.parametrize("tokenizer", ["hashing", "vocab"])
def test_batches_equal(corpus, tokenizer):
    kw = dict(data_dir=str(corpus), batch_size=4, eval_batch_size=4,
              max_length=16, vocab_size=600, oov_buckets=50,
              tokenizer=tokenizer)
    # the port first: with the vocab tokenizer it builds and caches the
    # vocab, which the reference then reads from the shared cache
    port = PortDataModule(PortDataConfig(**kw))
    port.setup()
    ref = RecDataModule(DataConfig(**kw))
    ref.setup()
    np.testing.assert_array_equal(port.item_tokens, ref.item_tokens)
    np.testing.assert_array_equal(port.user_tokens, ref.user_tokens)
    assert port.steps_per_epoch == ref.steps_per_epoch
    seen = 0
    for epoch in (0, 1):
        seen += _assert_batches_equal(
            port.train_batches(epoch), ref.train_batches(epoch), 3
        )
    for subset in ("val", "test"):
        seen += _assert_batches_equal(
            port.eval_interaction_batches(subset),
            ref.eval_interaction_batches(subset), 2,
        )
        seen += _assert_batches_equal(
            port.eval_batches(subset), ref.eval_batches(subset), 2
        )
        np.testing.assert_array_equal(
            port.eval_users(subset), ref.eval_users(subset)
        )
    assert seen >= 8
    np.testing.assert_array_equal(port.item_log_q_inbatch,
                                  ref.item_log_q_inbatch)


def test_prepare_data_generates_then_reuses(tmp_path):
    cfg = PortDataConfig(data_dir=str(tmp_path / "d"), synthetic_users=20,
                         synthetic_movies=30, synthetic_ratings=300)
    data = PortDataModule(cfg)
    data.prepare_data()
    assert data.provenance["source"] == "synthetic"
    assert not data.provenance["matches_real_ml1m"]
    assert port_prepare.prepared(cfg.data_dir)
    again = PortDataModule(cfg)
    again.prepare_data()
    assert again.provenance["source"] == "preexisting"


def test_refused_and_missing(tmp_path):
    """History and bag widths are accepted now; an unknown tokenizer and
    a missing corpus with no synthetic fallback are refused."""
    assert PortDataModule(PortDataConfig(max_history=4)).config.max_history
    assert PortDataModule(PortDataConfig(max_bag=4)).config.max_bag == 4
    with pytest.raises(ValueError, match="tokenizer"):
        PortDataModule(PortDataConfig(tokenizer="wordpiece"))
    data = PortDataModule(PortDataConfig(data_dir=str(tmp_path / "none"),
                                         synthetic_if_missing=False))
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        data.prepare_data()
