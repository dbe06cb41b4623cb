"""Port parity: the trainer's recommend surface, the data helpers it
leans on, and the engine's `user_activity`.

A tiny JAX `Trainer` is fitted (f32 compute, f32 index) and its
parameters are carried into the port's trainer (`models/convert.py`).
Then, against the JAX package on the same data:
- `Trainer.recommend` (raw texts, with and without `exclude_ids`; raw
  text on a history tower with `item_bias` and the CF channel) and
  `Trainer.recommend_users` (text tower and history tower) give the
  same ids in the same order, scores within 1e-5, the same metadata;
- `cli predict --user_id` prints the list the JAX CLI builds for that
  user (its train history excluded), and an unknown id exits with the
  JAX CLI's message;
- `unpack_data` unpacks a local archive to the same files, and
  `load_provenance` gives the same record on a directory with its raw
  files and on one with only the prepared tables; `RecDataModule.setup`
  reads the record back when `prepare_data` did not run;
- `RecommenderEngine.user_activity` equals the JAX engine's on the JAX
  trainer's artifact (its `users.parquet` converted to `users.npz`).
"""

import json
import shutil

import numpy as np
import pandas as pd
import pytest

from xfmr_rec_torch.data import prepare as port_prepare
from xfmr_rec_torch.data.module import DataConfig as PortDataConfig
from xfmr_rec_torch.data.module import RecDataModule as PortDataModule
from xfmr_rec_torch.models import convert
from xfmr_rec_torch.serving.engine import RecommenderEngine as PortEngine
from xfmr_rec_torch.serving.users import UserStore
from xfmr_rec_torch.training import cli as port_cli
from xfmr_rec_torch.training.module import TrainConfig as PortTrainConfig
from xfmr_rec_torch.training.trainer import Trainer as PortTrainer
from xfmr_rec_torch.training.trainer import TrainerConfig as PortTrainerConfig
from xfmr_rec_tpu.data import DataConfig, RecDataModule
from xfmr_rec_tpu.data import prepare as ref_prepare
from xfmr_rec_tpu.data.synthetic import generate_movielens
from xfmr_rec_tpu.serving.engine import RecommenderEngine as RefEngine
from xfmr_rec_tpu.serving.portable import _flatten
from xfmr_rec_tpu.training import cli as ref_cli
from xfmr_rec_tpu.training.module import TrainConfig
from xfmr_rec_tpu.training.trainer import Trainer, TrainerConfig

TEXT = dict(
    hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
    intermediate_size=32, vocab_size=500, max_position_embeddings=32,
    max_length=16, compute_dtype="float32", index_dtype="float32",
    dropout_rate=0.0,
)
HISTORY = dict(
    TEXT, user_tower="history", max_history=4, item_id_buckets=256,
    train_loss="InfomationNoiseContrastiveEstimationLoss",
    item_id_embedding="bloom", item_bias=True, max_bag=5, cf_rank=4,
)
DATA = dict(batch_size=8, eval_batch_size=16, max_length=16, vocab_size=500)
TRAIN = dict(max_steps=4, checkpointing=False, limit_val_loss_batches=1,
             run_name="r")
SCORE_TOL = 1e-5
TEXTS = ["comedy", "action thriller", "a quiet drama about family", ""]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("recdata")
    generate_movielens(path, num_users=40, num_movies=120, num_ratings=1200,
                       seed=1)
    ref_prepare.prepare_movielens(str(path), overwrite=True)
    return str(path)


def data_kw(model):
    kw = dict(DATA)
    if model.get("user_tower") == "history":
        kw.update(max_history=model["max_history"], max_bag=model["max_bag"])
    return kw


def fitted_pair(data_dir, root, model):
    """A JAX trainer fitted 4 steps, and a port trainer holding its
    parameters; both with their eval index built from those."""
    ref = Trainer(
        TrainConfig(**model),
        data=RecDataModule(DataConfig(data_dir=data_dir, **data_kw(model))),
        trainer_config=TrainerConfig(log_dir=str(root / "ref"), mesh=False,
                                     **TRAIN),
    )
    ref.fit()
    ref.build_index()
    port = PortTrainer(
        PortTrainConfig(**model),
        data=PortDataModule(PortDataConfig(data_dir=data_dir,
                                           **data_kw(model))),
        trainer_config=PortTrainerConfig(log_dir=str(root / "port"), **TRAIN),
        device="cpu",
    )
    port.setup()
    flat = {k: np.asarray(v, np.float32)
            for k, v in _flatten(ref.state.params).items()}
    to_state = (convert.two_tower_state_from_flat
                if model.get("user_tower") == "history"
                else convert.encoder_state_from_flat)
    port.state.model.load_state_dict(to_state(flat, port.config))
    port.build_index()
    return ref, port


@pytest.fixture(scope="module")
def text_pair(data_dir, tmp_path_factory):
    return fitted_pair(data_dir, tmp_path_factory.mktemp("text"), TEXT)


@pytest.fixture(scope="module")
def history_pair(data_dir, tmp_path_factory):
    return fitted_pair(data_dir, tmp_path_factory.mktemp("hist"), HISTORY)


def assert_same_lists(got, want):
    assert len(got) == len(want)
    for got_row, want_row in zip(got, want, strict=True):
        assert [c["movie_id"] for c in got_row] == [
            c["movie_id"] for c in want_row]
        np.testing.assert_allclose([c["score"] for c in got_row],
                                   [c["score"] for c in want_row],
                                   atol=SCORE_TOL, rtol=0)
        for g, w in zip(got_row, want_row, strict=True):
            assert {k: v for k, v in g.items() if k != "score"} == {
                k: v for k, v in w.items() if k != "score"}


@pytest.mark.parametrize("excluded", [False, True])
def test_recommend_equals_reference(text_pair, excluded):
    ref, port = text_pair
    texts = TEXTS + list(port.data.item_texts[:4]) + list(
        port.data.user_texts[:4])
    exclude = None
    if excluded:
        plain = port.recommend(texts, top_k=10)
        exclude = [[c["movie_id"] for c in row[:3]] for row in plain]
    got = port.recommend(texts, top_k=10, exclude_ids=exclude)
    want = ref.recommend(texts, top_k=10, exclude_ids=exclude)
    assert_same_lists(got, want)
    assert all(len(row) == 10 for row in got)
    if excluded:
        for row, ids in zip(got, exclude, strict=True):
            assert not {c["movie_id"] for c in row} & set(ids)


def test_recommend_raw_text_with_item_bias(history_pair):
    """A history tower with the bias column and the CF channel: a raw text
    query carries the constant 1 and zero CF columns."""
    ref, port = history_pair
    assert port.index.corpus.shape[1] == 32 + 1 + 4 + 1
    got = port.recommend(TEXTS, top_k=7)
    assert_same_lists(got, ref.recommend(TEXTS, top_k=7))
    assert all(len(row) == 7 for row in got)


@pytest.mark.parametrize("tower", ["text", "history"])
def test_recommend_users_equals_reference(text_pair, history_pair, tower):
    ref, port = text_pair if tower == "text" else history_pair
    upos = np.arange(0, port.data.num_users, 3)
    exclude = [port.data.train_history_item_ids(int(u)) for u in upos]
    assert exclude == [ref.data.train_history_item_ids(int(u)) for u in upos]
    got = port.recommend_users(upos, top_k=10, exclude_ids=exclude)
    assert_same_lists(
        got, ref.recommend_users(upos, top_k=10, exclude_ids=exclude))
    for row, ids in zip(got, exclude, strict=True):
        assert not {c["movie_id"] for c in row} & set(ids)


def cli_config(tmp_path, data_dir):
    path = tmp_path / "run.json"
    path.write_text(json.dumps({
        "model": TEXT,
        "data": {"data_dir": data_dir, **DATA},
        "trainer": {"log_dir": str(tmp_path / "runs"), "run_name": "cli",
                    "checkpointing": False},
    }))
    return str(path)


def test_cli_predict_user_id_equals_reference(text_pair, data_dir, tmp_path,
                                              capsys):
    ref, port = text_pair
    ckpt = tmp_path / "ckpt" / "carried"
    port.save_checkpoint(str(ckpt))
    upos = 5
    user_id = int(port.data.user_ids[upos])
    capsys.readouterr()
    port_cli.run(["predict", "--config", cli_config(tmp_path, data_dir),
                  "--device", "cpu", "--ckpt", str(ckpt),
                  "--user_id", str(user_id)])
    got = json.loads(capsys.readouterr().out)
    # what the JAX CLI prints for this user
    exclude = ref.data.train_history_item_ids(upos)
    want = ref.recommend_users([upos], exclude_ids=[exclude])[0]
    assert len(got) == port.config.top_k
    assert_same_lists([got], [want])


def test_cli_unknown_user_id_exits_as_reference(data_dir, tmp_path):
    config = cli_config(tmp_path, data_dir)
    with pytest.raises(SystemExit) as ref_exit:
        ref_cli.main(["predict", "--config", config, "--user_id", "987654"])
    with pytest.raises(SystemExit) as port_exit:
        port_cli.run(["predict", "--config", config, "--device", "cpu",
                      "--user_id", "987654"])
    assert str(port_exit.value) == str(ref_exit.value) == (
        "unknown user_id 987654")


def test_unpack_data_equals_reference(data_dir, tmp_path):
    shutil.make_archive(str(tmp_path / "ml-1m"), "zip", data_dir, "ml-1m")
    names = {}
    for name, mod in (("port", port_prepare), ("ref", ref_prepare)):
        root = tmp_path / name
        root.mkdir()
        shutil.copy(tmp_path / "ml-1m.zip", root)
        names[name] = sorted(mod.unpack_data(root / "ml-1m.zip"))
        # unpacked once: a second call keeps what is there
        (root / "ml-1m" / "movies.dat").write_text("kept")
        assert sorted(mod.unpack_data(root / "ml-1m.zip")) == names[name]
        assert (root / "ml-1m" / "movies.dat").read_text() == "kept"
        mod.unpack_data(root / "ml-1m.zip", overwrite=True)
    assert names["port"] == names["ref"]
    assert "ratings.dat" in names["port"]
    for file in ("ratings.dat", "users.dat", "movies.dat"):
        assert ((tmp_path / "port" / "ml-1m" / file).read_bytes()
                == (tmp_path / "ref" / "ml-1m" / file).read_bytes())


def test_load_provenance_equals_reference(data_dir, tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(data_dir, root)
    for raw_files in (True, False):
        if not raw_files:
            for name in ("ratings.dat", "users.dat", "movies.dat"):
                (root / "ml-1m" / name).unlink()
        for record in ("provenance.json", "prepared/provenance.json"):
            (root / "ml-1m" / record).unlink(missing_ok=True)
        if raw_files:
            port_prepare.prepare_movielens(root)
        got = port_prepare.load_provenance(root)
        want = ref_prepare.load_provenance(root)
        assert got == want
        assert got["source"] == "preexisting"
        assert got["raw_files_present"] is raw_files
        assert got["num_ratings"] > 0
        # read back, not rebuilt
        assert port_prepare.load_provenance(root) == got
    module = PortDataModule(PortDataConfig(data_dir=str(root), **DATA))
    module.setup()
    assert module.provenance == got


def test_load_provenance_label_on_a_count_match(data_dir, tmp_path,
                                                monkeypatch):
    """With the fingerprint set to this corpus's counts, both packages
    record a match and give it the same label: "MovieLens-1M" with the
    raw files, the reference's count-match label with only the prepared
    tables."""
    root = tmp_path / "copy"
    shutil.copytree(data_dir, root)
    raw = root / "ml-1m"
    port_prepare.prepare_movielens(root)
    with (raw / "ratings.dat").open(encoding="iso-8859-1") as fh:
        first_line = fh.readline().strip()
    counts = {
        key: value
        for key, value in ref_prepare.load_provenance(root).items()
        if key.startswith("num_")
    }
    fingerprint = {**counts, "first_rating_line": first_line}
    monkeypatch.setattr(ref_prepare, "_REAL_ML1M", fingerprint)
    monkeypatch.setattr(port_prepare, "_REAL_ML1M", fingerprint)
    labels = []
    for raw_files in (True, False):
        if not raw_files:
            for name in ("ratings.dat", "users.dat", "movies.dat"):
                (raw / name).unlink()
        for record in ("provenance.json", "prepared/provenance.json"):
            (raw / record).unlink(missing_ok=True)
        got = port_prepare.load_provenance(root)
        want = ref_prepare.load_provenance(root)
        assert got == want
        assert got["matches_real_ml1m"] is True
        labels.append(got["dataset_label"])
    assert labels == ["MovieLens-1M", "MovieLens-1M (parquet-count match)"]


def test_user_activity_equals_reference(text_pair, tmp_path):
    ref, _ = text_pair
    art = tmp_path / "art"
    ref.save(art)
    UserStore.from_rows(
        pd.read_parquet(art / "users.parquet").to_dict("records")
    ).save(art / "users.npz")
    ref_engine = RefEngine(art, warmup=False)
    port_engine = PortEngine(art, device="cpu", warmup=False)
    checked = 0
    for user_id in [int(u) for u in ref.data.user_ids[::4]] + [987654]:
        for activity in ("history", "target"):
            want = ref_engine.user_activity(user_id, activity)
            got = port_engine.user_activity(user_id, activity)
            assert got == want
            checked += bool(got)
    assert checked > 0
    assert port_engine.user_activity(987654, "history") == {}


def test_prepare_main_unpacks_a_local_archive_and_never_downloads(
        data_dir, tmp_path, monkeypatch):
    """`python -m xfmr_rec_torch.data.prepare` unpacks `<data_dir>/ml-1m.zip`
    and prepares; with no raw files it exits, naming the synthetic
    generator, and fetches nothing."""
    monkeypatch.setattr("urllib.request.urlopen", None)
    monkeypatch.setattr("urllib.request.urlretrieve", None)
    empty = tmp_path / "empty"
    with pytest.raises(SystemExit, match="xfmr_rec_torch.data.synthetic"):
        port_prepare.main(["--data_dir", str(empty)])
    root = tmp_path / "zipped"
    root.mkdir()
    shutil.make_archive(str(root / "ml-1m"), "zip", data_dir, "ml-1m")
    port_prepare.main(["--data_dir", str(root)])
    assert port_prepare.prepared(root)
    assert port_prepare.load_provenance(root)["raw_files_present"]
    port_prepare.prepare_movielens(data_dir)
    for table in port_prepare.TABLES:
        got = port_prepare.load_table(root, table)
        want = port_prepare.load_table(data_dir, table)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
