"""Host-side C++ components (the batch tokenizer, BM25), bound with ctypes.

Each source in this directory is compiled by the local `g++` at first
use into `build/native/` at the root of the checkout, named by a hash of
the source and the flags, so a changed file rebuilds and an unchanged one
loads straight away. The library is written under a temporary name and
renamed into place, so processes that build the same library at the same
moment never load a half-written file. A failed build raises with the
compiler's output: there is no quiet fallback to the Python versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

SRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
# no fused multiply-adds: the BM25 scores must round as the Python oracle's
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")


def build(source: str) -> pathlib.Path:
    """Compile `source` (a file in this directory) if needed and return
    the library's path."""
    src = SRC_DIR / source
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        result = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True, check=False,
        )
        if result.returncode:
            msg = (
                f"g++ failed to build {src} (exit {result.returncode}):\n"
                f"{result.stdout}{result.stderr}"
            )
            raise RuntimeError(msg)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load(source: str) -> ctypes.CDLL:
    """The library built from `source`."""
    return ctypes.CDLL(str(build(source)))
