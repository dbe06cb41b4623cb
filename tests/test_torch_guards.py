"""Guards of the port: no JAX inside it, the card by default, kernel
wrappers that never fall back."""

import ast
import importlib
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import xfmr_rec_torch
from xfmr_rec_torch import resolve_device
from xfmr_rec_torch.ops import kernels, topk

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "xfmr_rec_tpu")


def port_modules():
    return [
        info.name
        for info in pkgutil.walk_packages(
            xfmr_rec_torch.__path__, prefix="xfmr_rec_torch."
        )
    ]


def test_port_imports_no_jax():
    """Import every module of the port, and chip_smoke.py, in a fresh
    interpreter; none of JAX, flax or the JAX package may load."""
    modules = port_modules()
    assert "xfmr_rec_torch.serving.service" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300, check=False,
    )
    assert result.returncode == 0, result.stdout + result.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in REPO.glob("xfmr_rec_torch/**/*.py"))
    + ["chip_smoke.py"],
)
def test_sources_name_no_jax_import(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    from xfmr_rec_torch.index.mips import RetrievalIndex
    from xfmr_rec_torch.serving.engine import RecommenderEngine

    with pytest.raises(RuntimeError, match="is_available"):
        RetrievalIndex(np.zeros((4, 8), np.float32), np.arange(4))
    with pytest.raises(RuntimeError, match="is_available"):
        RecommenderEngine("no-such-artifact")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel launch was attempted on the CPU")

    monkeypatch.setattr(kernels, "packed_scan", refuse)
    monkeypatch.setattr(kernels, "threshold_select", refuse)
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(1024, 16)).astype(np.float32))
    keys, dmax = topk.packed_lane_scan(
        q, c, score_bound=8.0, batch_tile=8, corpus_tile=256
    )
    assert keys.shape == (8, 512) and dmax.shape == (8,)
    pool = torch.from_numpy(
        rng.integers(0, 1 << 30, size=(4, 768)).astype(np.int32)
    )
    top, lanes = topk.select_topk_keys(pool, 10)
    assert top.shape == lanes.shape == (4, 10)
    assert kernels.launch_counts() == {"packed_scan": 0, "threshold_select": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.packed_scan(q, q, None, corpus_tile=8, idx_bits=1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.threshold_select(
            torch.zeros((2, 256), dtype=torch.int32), 5, capacity=128
        )


@pytest.mark.parametrize("module", ["ops/topk.py", "ops/kernels.py"])
def test_no_try_around_kernel_paths(module):
    """A kernel path that fails must fail: neither the dispatching module
    nor the launch module may hold a try statement (no caught build or
    launch error falling back to the plain version)."""
    tree = ast.parse((REPO / "xfmr_rec_torch" / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_build_without_nvcc_fails_loudly(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_kernel_sources_present():
    for name in kernels.SOURCES:
        source = (kernels.CSRC_DIR / name).read_text()
        assert "Replaces:" in source and "extern \"C\"" in source
    importlib.import_module("xfmr_rec_torch.ops.kernels")
