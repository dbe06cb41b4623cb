"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# a width may never be cut
WIDTH = re.compile(r"hidden|intermediate|latent|state|proj|_dim$|_rank$|head|"
                   r"expansion|experts_per_tok")


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16
    for path in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path.split("/")
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(word) for word in spec["command"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024


def test_configs(spec):
    assert 1 <= len(spec["configs"]) <= 24
    used = {cell["config"] for cell in spec["workloads"]}
    files = set()
    for entry in spec["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(entry["name"]) and entry["name"] in used
        assert _line(entry["source"]) and _line(entry["why"])
        assert entry["file"].startswith(tuple(p + "/" for p in spec["paths"]))
        assert entry["file"] not in files
        files.add(entry["file"])
        body = json.loads((harness.ROOT / entry["file"]).read_text())
        assert body["source"] == entry["source"]
        assert body["reduced"] == entry["reduced"]
        assert len(entry["reduced"]) <= 16
        assert not any(WIDTH.search(key) for key in entry["reduced"])


def test_workloads(spec):
    cells = spec["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    four = sum(c["chips"] == 4 for c in cells)
    assert four <= max(1, len(cells) // 4)
    for cell in cells:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and _line(cell["why"])


def test_metrics(spec):
    e2e, layers = spec["end_to_end"], spec["per_layer"]
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in e2e)
    cells = {c["name"] for c in spec["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {x["name"] for x in e2e}
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        cell_e2e, cell_layers = harness.metrics_of_cell(spec, cell)
        assert "setup_s" in {m["name"] for m in cell_e2e}
        assert len(cell_e2e) >= 2 and cell_layers
        # a per-layer metric that names the cell reports an end-to-end
        # metric that the cell reports
        for m in layers:
            if cell in m.get("workloads", []):
                assert m in cell_layers
        # a kernel's roofline beside a share of the whole step's peak
        if any("roofline" in m["name"] for m in cell_layers):
            assert any("mfu" in m["name"] for m in cell_layers)


def test_every_file_is_found_by_name(spec):
    for cell in spec["workloads"]:
        config = harness.config_of(spec, cell)
        assert config["hidden_size"] > 0
        traffic = harness.traffic_of(cell)
        driver = harness.driver_module(traffic["driver"])
        assert callable(driver.run)
        assert "limits" in traffic
    for m in spec["per_layer"]:
        assert callable(harness.reader_module(m["name"]).read)


def test_new_cell_from_new_files_alone(tmp_path):
    """A cell added as a BENCHMARK.json entry and a traffic file runs with no
    file of the harness edited."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_spec()
    base = json.loads((harness.BENCH_DIR / "traffic" / "retrieve-b4096.json")
                      .read_text())
    small = dict(base, items=8192, batch=32, max_batches=4, warmup_batches=1,
                 check_batches=2)
    (tmp_path / "benchmark" / "traffic" / "retrieve-small.json").write_text(
        json.dumps(small))
    spec["workloads"].append({"name": "retrieve-h32-small",
                              "config": "bert-h32-ref",
                              "traffic": "retrieve-small", "chips": 1,
                              "why": "a small cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "retrieve-h32-b4096" in m.get("workloads", []):
            m["workloads"].append("retrieve-h32-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    import torch

    result = harness.run_cell("retrieve-h32-small", 5, 0.5, False,
                              torch.device("cpu"), 0.0, root=tmp_path)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"retrieval_qps", "setup_s"}


def test_a_reader_is_its_own_file_or_else_its_kinds(tmp_path):
    folder = tmp_path / "layer_metrics"
    folder.mkdir()
    (folder / "share.py").write_text("def read(view):\n    return 1.0\n")
    (folder / "share.train.py").write_text("def read(view):\n    return 2.0\n")
    assert harness.reader_module("share.train", tmp_path).read(None) == 2.0
    assert harness.reader_module("share.retrieve", tmp_path).read(None) == 1.0
    with pytest.raises(harness.BenchError):
        harness.reader_module("other.retrieve", tmp_path)


def test_host_threads_size_the_cpu_pools(monkeypatch):
    for name in harness.THREAD_VARS:
        monkeypatch.delenv(name, raising=False)
    harness.limit_host_threads({})
    assert not set(harness.THREAD_VARS) & set(os.environ)
    harness.limit_host_threads({"host_threads": 2})
    assert all(os.environ[name] == "2" for name in harness.THREAD_VARS)
