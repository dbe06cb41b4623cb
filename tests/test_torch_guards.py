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
from xfmr_rec_torch.ops import kernels, topk, topk_f32

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

    for name in kernels.LAUNCHES:
        monkeypatch.setattr(kernels, name, refuse)
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
    vals, pos, evicted = topk_f32.lane_max_scan(
        q, c, batch_tile=8, corpus_tile=256, slots=2, track_discards=True
    )
    assert vals.shape == pos.shape == (8, 512) and evicted.shape == (8, 1)
    counts = topk_f32.count_at_least(
        q, c, vals[:, 0], batch_tile=8, corpus_tile=256
    )
    assert counts.shape == (8,) and (counts >= 1).all()
    sel_keys, sel_lanes, dmax = topk.packed_lane_scan_select(
        q, c, 10, score_bound=8.0, batch_tile=8, corpus_tile=256,
        merge_levels=1, merge_keep=3,
    )
    assert sel_keys.shape == sel_lanes.shape == (8, 128)
    assert dmax.shape == (8,)
    assert set(kernels.launch_counts()) == {
        "packed_scan", "threshold_select", "lane_max_scan",
        "count_at_least", "packed_scan_select",
    }
    assert not any(kernels.launch_counts().values())


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.packed_scan(q, q, None, corpus_tile=8, idx_bits=1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.threshold_select(
            torch.zeros((2, 256), dtype=torch.int32), 5, capacity=128
        )
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lane_max_scan(q, q, None, corpus_tile=8, slots=2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.count_at_least(q, q, torch.zeros(8), corpus_tile=8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.packed_scan_select(q, q, None, 5, corpus_tile=8, idx_bits=1)


@pytest.mark.parametrize(
    "module", ["ops/topk.py", "ops/topk_f32.py", "ops/kernels.py"]
)
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
    assert set(kernels.SOURCES) == {
        "packed_scan.cu", "threshold_select.cu", "lane_max_scan.cu",
        "count_at_least.cu", "packed_scan_select.cu",
    }
    for name in kernels.SOURCES:
        source = (kernels.CSRC_DIR / name).read_text()
        assert "Replaces:" in source and "extern \"C\"" in source
        assert "__global__" in source
        # each kernel has a wrapper of its source's name and a counter
        stem = name.removesuffix(".cu")
        assert callable(getattr(kernels, stem)) and stem in kernels.LAUNCHES
        assert f"xfmr_{stem}(" in source
    assert set(kernels.HEADERS) == {
        "scan_common.cuh", "mma_sweep.cuh", "packed_sweep.cuh",
        "select_common.cuh",
    }
    for name in kernels.HEADERS:
        assert (kernels.CSRC_DIR / name).exists()
    # every header a source includes is hashed into the build's name
    included = {
        line.split('"')[1]
        for path in kernels.CSRC_DIR.iterdir()
        for line in path.read_text().splitlines()
        if line.startswith('#include "')
    }
    assert included == set(kernels.HEADERS)
    importlib.import_module("xfmr_rec_torch.ops.kernels")


@pytest.mark.parametrize(
    "source", ["lane_max_scan.cu", "count_at_least.cu", "packed_scan_select.cu"]
)
def test_scan_kernels_do_their_own_dot(source):
    """The dot of each scan kernel is the repo's own: the tensor-core loop
    `mma_sweep` for bf16 and int8, the fmaf chain of the shared
    `tile_dot` (through `fma_sweep`) for f32 x f32, reached directly
    (kernels 3 and 4) or through packed_sweep.cuh (kernel 5); never a
    library call."""
    text = (kernels.CSRC_DIR / source).read_text()
    own_loops = "mma_sweep<" in text and "fma_sweep<" in text
    assert own_loops or "with_sweep(" in text
    for banned in ("cublas", "cutlass", "#include <torch", "#include <aten"):
        assert banned not in text.lower()
    common = (kernels.CSRC_DIR / "scan_common.cuh").read_text()
    assert "fmaf(" in common and "tile_dot<R>(sm, dim, acc)" in common
    sweep = (kernels.CSRC_DIR / "packed_sweep.cuh").read_text()
    assert "fma_sweep<" in sweep and "f(FmaSweep{})" in sweep


BANNED_IN_SWEEP = ("cublas", "#include <torch", "#include <aten",
                   "cutlass/gemm/device")


@pytest.mark.parametrize(
    "source",
    ["mma_sweep.cuh", "packed_sweep.cuh", "packed_scan.cu",
     "packed_scan_select.cu", "lane_max_scan.cu", "count_at_least.cu"],
)
def test_packed_sweep_multiplies_on_tensor_cores_itself(source):
    """Kernels 1, 3, 4 and 5 form their bf16 and int8 scores with `wgmma`
    written out in the repo's own header, behind `cp.async` copies, in
    one loop (`mma_sweep`) that kernels 1 and 5 reach through `MmaSweep`;
    no library GEMM anywhere on the way."""
    text = (kernels.CSRC_DIR / source).read_text()
    for banned in BANNED_IN_SWEEP:
        assert banned not in text.lower()
    if source == "mma_sweep.cuh":
        assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in text
        assert "cp.async.cg.shared.global" in text
        assert "fence.proxy.async" in text
        assert "mma_tile(acc, a_addr" in text and "ring.acquire(" in text
    elif source == "packed_sweep.cuh":
        assert '#include "mma_sweep.cuh"' in text
        assert "mma_sweep<CT, kAsync>(" in text
        # one sweep per dtype pair, chosen in one place
        for pair in ("f(MmaSweep<__nv_bfloat16, true>{})",
                     "f(MmaSweep<int8_t, true>{})", "f(FmaSweep{})"):
            assert text.count(pair) == 1
    elif source in ("lane_max_scan.cu", "count_at_least.cu"):
        # the f32-value sweeps: one loop, one lane width for both kernels
        assert '#include "mma_sweep.cuh"' in text
        assert text.count("mma_sweep<") == 1
        assert "kLanes = kMmaLanes" in text
        assert "tile_dot<" not in text and "ring.acquire(" not in text
    else:
        # no old sweep kept beside the new one, no sweep chosen here
        assert text.count("with_sweep(") == 2
        assert "packed_sweep<" not in text and "MmaSweep<" not in text


def test_split_plan_is_a_pure_function():
    """The number of corpus splits depends on the shapes and the SM count
    alone, never on a build or a launch having failed."""
    source = (REPO / "xfmr_rec_torch/ops/kernels.py").read_text()
    tree = ast.parse(source)
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "sweep_splits")
    names = {n.id for stmt in fn.body for n in ast.walk(stmt)
             if isinstance(n, ast.Name)}
    assert names <= {"batch", "num_tiles", "lane_chunks", "sm_count", "blocks",
                     "max", "min", "block_rows", "blocks_per_sm"}
    assert kernels.sweep_splits(4096, 512, 32, 132) == 1
    assert kernels.sweep_splits(64, 512, 32, 132) == 16
    # the f32 sweep: 128 lanes a block, one block an SM
    assert kernels.sweep_splits(64, 512, 16, 132, 64, 1) == 8


def test_sweep_shape_is_fixed_in_the_source():
    """One shape of the tensor-core sweep is built: no compile-time knob,
    no way to rebuild the library with other flags."""
    header = (kernels.CSRC_DIR / "mma_sweep.cuh").read_text()
    assert "#ifndef" not in header and "#define XFMR_MMA" not in header
    assert "m64n128k16" not in header
    assert not hasattr(kernels, "use_variant")
    assert not (REPO / "xfmr_rec_torch/tools").exists()
