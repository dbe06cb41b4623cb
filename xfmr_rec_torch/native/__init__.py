"""Host-side C++ components (the batch tokenizer, BM25), bound with ctypes.

Each source in this directory is compiled by the local `g++` at first
use into `build/native/` at the root of the checkout, named by a hash of
the source and the flags, so a changed file rebuilds and an unchanged one
loads straight away. The library is written under a temporary name and
renamed into place, so processes that build the same library at the same
moment never load a half-written file.

A failed build, or a host with no `g++`, raises `RuntimeError` with the
compiler's output. The callers take a tri-state `native` argument
(`choose`): `None` (their default) uses the library where it builds and
otherwise the Python path, after one logged warning; `True` requires the
library and raises; `False` runs the Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import tempfile
from collections.abc import Callable
from typing import TypeVar

logger = logging.getLogger(__name__)

SRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
# no fused multiply-adds: the BM25 scores must round as the Python oracle's
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

T = TypeVar("T")

# sources whose build failed in this process -> the compiler's message
_failed: dict[str, str] = {}
# the libraries whose fallback has been logged in this process
_warned: set[str] = set()


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
        try:
            result = subprocess.run(
                ["g++", *GXX_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True, check=False,
            )
        except FileNotFoundError as err:
            msg = f"g++ failed to build {src}: no compiler on PATH ({err})"
            raise RuntimeError(msg) from err
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
    """The library built from `source`. A failed build is remembered, so
    later calls raise at once instead of running the compiler again."""
    if source in _failed:
        raise RuntimeError(_failed[source])
    try:
        return ctypes.CDLL(str(build(source)))
    except RuntimeError as err:
        _failed[source] = str(err)
        raise


def choose(native: bool | None, bind: Callable[[], T], what: str) -> T | None:
    """`bind()` (a binding's loader) as `native` asks: None under False;
    its result or its `RuntimeError` under True; under None its result,
    or None (the Python path) after a warning, logged once a process for
    `what`, that the library is unavailable."""
    if native is False:
        return None
    try:
        return bind()
    except RuntimeError as err:
        if native:
            raise
        if what not in _warned:
            _warned.add(what)
            logger.warning(
                "native %s unavailable; using the Python path: %s", what, err
            )
        return None
