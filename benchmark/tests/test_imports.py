"""Nothing the benchmark loads is JAX or the JAX package, and the reference
loads nothing of the port."""

from __future__ import annotations

import subprocess
import sys

from benchmark import harness

MODULES = ["benchmark.run", "benchmark.harness", "benchmark.control",
           "benchmark.drivers.retrieve", "benchmark.drivers.train"]


def _loaded_after(imports: list[str]) -> set[str]:
    code = ("import sys\n" + "".join(f"import {m}\n" for m in imports)
            + "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=harness.ROOT)
    return set(out.stdout.split())


def test_benchmark_loads_no_jax():
    loaded = _loaded_after(MODULES + ["xfmr_rec_torch.index.mips",
                                      "xfmr_rec_torch.training.trainer"])
    assert not loaded & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after([
        "benchmark.reference.bert", "benchmark.reference.losses",
        "benchmark.reference.movielens", "benchmark.reference.search",
        "benchmark.reference.tokenizer", "benchmark.reference.train",
        "benchmark.reference.precision"])
    assert not loaded & ({harness.PORT} | set(harness.FORBIDDEN))


def test_reference_sources_import_nothing_outside():
    assert harness.reference_imports() == []


def test_the_check_flags_a_forbidden_import(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "bad.py").write_text(
        "import xfmr_rec_torch.ops\nfrom benchmark import harness\n")
    assert len(harness.reference_imports(tmp_path)) == 2
