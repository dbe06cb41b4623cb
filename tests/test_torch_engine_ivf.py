"""Port parity: the serving engine with `index_kind="ivf"`.

A tiny JAX-trained artifact (tests/test_serving.py `build_artifact`) is
served by both packages' engines, with the IVF probe and with
`ivf_certified`; the answers must be the same ids. The cache: a port
restart loads its own `ivf/` (a hit), a cache the JAX engine wrote loads
in the port and the other way round, a changed fingerprint rebuilds with
a warning, a read-only directory warns. The recall guardrail raises
under `ivf_enforce_recall`; `add_items` is refused under the IVF and
under `index_kind="sharded"`, which serves; the micro-batcher and the
serve CLI go through the IVF.
"""

import concurrent.futures
import json
import shutil

import numpy as np
import pandas as pd
import pytest

from tests.test_serving import build_artifact
from xfmr_rec_torch.serving import prepare
from xfmr_rec_torch.serving.batching import MicroBatcher
from xfmr_rec_torch.serving.engine import RecommenderEngine as PortEngine
from xfmr_rec_torch.serving.schemas import ItemQuery, Query
from xfmr_rec_torch.serving.users import UserStore
from xfmr_rec_tpu.serving.engine import RecommenderEngine as RefEngine
from xfmr_rec_tpu.serving.schemas import Query as RefQuery

CPU = "cpu"
TEXTS = ["comedy", "action thriller", "a quiet drama about family", ""]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    path = build_artifact(tmp_path_factory)
    UserStore.from_rows(
        pd.read_parquet(path / "users.parquet").to_dict("records")
    ).save(path / "users.npz")
    return path


@pytest.fixture
def artifact(trained, tmp_path):
    """A fresh copy of the artifact, with no `ivf/` cache."""
    path = tmp_path / "model"
    shutil.copytree(trained, path)
    return path


@pytest.fixture(scope="module")
def engines(trained, tmp_path_factory):
    ref_path = tmp_path_factory.mktemp("ref") / "model"
    port_path = tmp_path_factory.mktemp("port") / "model"
    shutil.copytree(trained, ref_path)
    shutil.copytree(trained, port_path)
    out = {}
    for certified in (False, True):
        out[certified] = (
            RefEngine(ref_path, index_kind="ivf", nprobe=4,
                      ivf_certified=certified),
            PortEngine(port_path, index_kind="ivf", nprobe=4,
                       ivf_certified=certified, device=CPU),
        )
    return out


@pytest.mark.parametrize("certified", [False, True])
@pytest.mark.parametrize("text", TEXTS)
def test_text_queries_same_ids(engines, certified, text):
    ref, port = engines[certified]
    want = ref.search_items(RefQuery(text=text), top_k=10)
    got = port.search_items(Query(text=text), top_k=10)
    assert [c.movie_id for c in got] == [c.movie_id for c in want]
    np.testing.assert_allclose(
        [c.score for c in got], [c.score for c in want], atol=1e-5
    )


@pytest.mark.parametrize("certified", [False, True])
def test_item_queries_same_ids_with_exclusions(engines, certified):
    ref, port = engines[certified]
    ids = [int(i) for i in port.index.ids[:6]]
    for item_id in ids:
        excl = [item_id, ids[0]]
        text = port.get_item(item_id).movie_text
        want = ref.search_items(RefQuery(text=text), exclude_item_ids=excl,
                                top_k=8)
        got = port.search_items(Query(text=text), exclude_item_ids=excl,
                                top_k=8)
        # the reference can return an excluded id when the probed pool
        # minus the exclusions is short (ROADMAP.md, Queue 3); the port
        # answers the rest the same
        assert [c.movie_id for c in got] == [
            c.movie_id for c in want if c.movie_id not in excl
        ]
        assert not set(excl) & {c.movie_id for c in got}


def test_certified_answers_equal_the_exact_engine(engines, trained):
    _, port = engines[True]
    exact = PortEngine(trained, device=CPU)
    before = dict(port.ivf_rows)
    for text in TEXTS:
        got = port.search_items(Query(text=text), exclude_item_ids=[3],
                                top_k=10)
        want = exact.search_items(Query(text=text), exclude_item_ids=[3],
                                  top_k=10)
        assert [c.movie_id for c in got] == [c.movie_id for c in want]
    rows = {k: port.ivf_rows[k] - before[k] for k in before}
    assert sum(rows.values()) == len(TEXTS)


def test_recall_matches_reference(engines):
    ref, port = engines[False]
    assert port.ivf_probe_recall == ref.ivf_probe_recall
    assert port.ivf.num_clusters == ref.ivf.num_clusters
    np.testing.assert_array_equal(port.ivf._assign, ref.ivf._assign)


def test_restart_hits_the_cache(artifact, caplog):
    first = PortEngine(artifact, index_kind="ivf", device=CPU)
    assert not first.ivf_cache_hit
    assert (artifact / "ivf" / "fingerprint.json").exists()
    second = PortEngine(artifact, index_kind="ivf", device=CPU)
    assert second.ivf_cache_hit
    np.testing.assert_array_equal(second.ivf._assign, first.ivf._assign)
    # a fingerprint of another corpus: rebuilt, with a warning
    (artifact / "ivf" / "fingerprint.json").write_text(
        json.dumps({"corpus_sha256": "0" * 64})
    )
    caplog.set_level("WARNING")
    third = PortEngine(artifact, index_kind="ivf", device=CPU)
    assert not third.ivf_cache_hit
    assert "different corpus" in caplog.text
    assert json.loads(
        (artifact / "ivf" / "fingerprint.json").read_text()
    )["corpus_sha256"] != "0" * 64


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_crosses_packages(artifact, writer):
    if writer == "jax":
        built = RefEngine(artifact, warmup=False, index_kind="ivf")
        loaded = PortEngine(artifact, index_kind="ivf", device=CPU)
        assert loaded.ivf_cache_hit
    else:
        built = PortEngine(artifact, index_kind="ivf", device=CPU)
        before = (artifact / "ivf" / "ivf.npz").stat().st_mtime_ns
        loaded = RefEngine(artifact, warmup=False, index_kind="ivf")
        # the JAX engine found the port's cache and did not rewrite it
        assert (artifact / "ivf" / "ivf.npz").stat().st_mtime_ns == before
    np.testing.assert_array_equal(
        np.asarray(loaded.ivf._assign), np.asarray(built.ivf._assign)
    )


def test_read_only_artifact_warns(artifact, caplog, monkeypatch):
    def refuse(*args, **kwargs):
        raise PermissionError("read-only")

    monkeypatch.setattr("xfmr_rec_torch.index.ivf.IVFIndex.save", refuse)
    caplog.set_level("WARNING")
    engine = PortEngine(artifact, index_kind="ivf", device=CPU)
    assert engine.ivf is not None
    assert "could not cache IVF" in caplog.text


def test_recall_guardrail(artifact, caplog):
    caplog.set_level("WARNING")
    PortEngine(artifact, index_kind="ivf", ivf_min_recall=1.01, device=CPU)
    assert "recall@10" in caplog.text
    with pytest.raises(RuntimeError, match="does not cluster well"):
        PortEngine(artifact, index_kind="ivf", ivf_min_recall=1.01,
                   ivf_enforce_recall=True, device=CPU)


def test_add_items_and_sharded_refused(engines, artifact):
    _, port = engines[False]
    item = ItemQuery(movie_rn=999, movie_id=99999, movie_text="new")
    with pytest.raises(RuntimeError, match="index_kind='exact'"):
        port.add_items([item])
    # the sharded kind serves the artifact (split over a virtual mesh of
    # two CPU devices) and refuses add_items the same way; its packed keys
    # quantize scores, so it answers the exact index's lists up to swaps
    # within a key quantum of the k-th
    sharded = PortEngine(artifact, index_kind="sharded", model_parallel=2,
                         device=CPU)
    assert sharded.index.num_shards == 2
    exact = PortEngine(artifact, warmup=False, device=CPU)
    for text in TEXTS:
        got = sharded.search_items(Query(text=text))
        want = exact.search_items(Query(text=text))
        np.testing.assert_allclose([c.score for c in got],
                                   [c.score for c in want], atol=4e-3)
        firm = {c.movie_id for c in want if c.score > want[-1].score + 8e-3}
        assert firm <= {c.movie_id for c in got}
    with pytest.raises(RuntimeError, match="index_kind='exact'"):
        sharded.add_items([item])
    with pytest.raises(ValueError, match="unknown index_kind"):
        PortEngine(artifact, index_kind="hnsw", device=CPU)


def test_microbatcher_goes_through_the_ivf(engines):
    _, port = engines[False]
    batcher = MicroBatcher(port, max_batch=8, max_wait_ms=20)
    try:
        texts = [TEXTS[i % len(TEXTS)] for i in range(12)]
        with concurrent.futures.ThreadPoolExecutor(12) as pool:
            futures = [
                pool.submit(batcher.search_items, t, top_k=5) for t in texts
            ]
            results = [f.result(timeout=60) for f in futures]
    finally:
        batcher.close()
    for text, got in zip(texts, results, strict=True):
        want = port.ivf.search(port.embed([text]), top_k=5)[1][0]
        assert [c.movie_id for c in got] == [int(i) for i in want if i != -1]


def test_serve_cli_with_ivf(artifact, caplog, capsys):
    args = prepare.parse_args(["--index_kind", "ivf", "--nprobe", "3"])
    assert (args.index_kind, args.nprobe) == ("ivf", 3)
    caplog.set_level("INFO")
    prepare.main(["--artifact_dir", str(artifact), "--device", CPU,
                  "--index_kind", "ivf", "--nprobe", "3"])
    assert "golden-value checks passed" in caplog.text
    assert (artifact / "ivf" / "ivf.npz").exists()
    assert prepare.parse_args(["--index_kind", "sharded"]).index_kind == (
        "sharded"
    )
    with pytest.raises(SystemExit):
        prepare.parse_args(["--index_kind", "hnsw"])
    assert "invalid choice" in capsys.readouterr().err


def test_entry_points_default_to_the_card(artifact, monkeypatch):
    """With no card visible, the IVF engine, the IVF index, a remat train
    state and the trainer (with its `predict`) raise rather
    than run on the CPU."""
    import torch

    from xfmr_rec_torch.index.ivf import IVFIndex
    from xfmr_rec_torch.training import module as train_mod
    from xfmr_rec_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = np.eye(8, dtype=np.float32)
    for build in (
        lambda: PortEngine(artifact, index_kind="ivf"),
        lambda: IVFIndex(corpus, np.arange(8)),
        lambda: train_mod.TrainState(train_mod.TrainConfig(remat=True)),
        lambda: Trainer(),
    ):
        with pytest.raises(RuntimeError, match="is_available"):
            build()
