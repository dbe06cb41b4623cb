"""Read and write flax's msgpack state format without msgpack or flax.

`flax.serialization.to_bytes(params)` writes nested maps of str keys
whose leaves are arrays packed as msgpack ext type 1, the ext payload
being itself a msgpack array `(shape, dtype name, C-order bytes)`;
numpy scalars are ext type 3 with the same payload. That subset is all
a parameter tree uses, and this module reads and writes exactly it:
maps, arrays, str, bin and ints (the reader also floats, bool and nil),
plus the two ext types. The writer picks the smallest encoding of each value, as the
msgpack packer does, and sorts map keys, so its bytes are
`flax.serialization.msgpack_serialize`'s for the same tree (`to_bytes`
keeps the params' creation order instead; a reader does not care). The reader refuses what it does not know (another ext type, a
dtype outside `_DTYPES`, flax's chunked-array maps for leaves over
2^30 bytes, trailing bytes) with a `ValueError`.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
_DTYPES = {
    name: np.dtype(name)
    for name in (
        "bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
        "uint32", "uint64", "float16", "float32", "float64",
    )
}


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------
def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A length header: the fix form below `fix_max`, else 8/16/32-bit
    (`codes`; a code of -1 means that width does not exist)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif n <= 0xFF and codes[0] >= 0:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        msg = f"msgpack object of length {n} is too large"
        raise ValueError(msg)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        msg = f"integer {v} does not fit msgpack"
        raise ValueError(msg)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        msg = f"integer {v} does not fit msgpack"
        raise ValueError(msg)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.name not in _DTYPES:
        msg = f"dtype {arr.dtype.name!r} is not written by this codec"
        raise ValueError(msg)
    payload = bytearray()
    _pack(payload, (list(arr.shape), arr.dtype.name, arr.tobytes("C")))
    return bytes(payload)


def _pack(out: bytearray, value: Any) -> None:
    if isinstance(value, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(value))
    elif isinstance(value, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(value)))
    elif isinstance(value, int):
        _pack_int(out, value)
    elif isinstance(value, str):
        data = value.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(value, (bytes, bytearray)):
        _pack_len(out, len(value), None, 0, (0xC4, 0xC5, 0xC6))
        out += value
    elif isinstance(value, (list, tuple)):
        _pack_len(out, len(value), 0x90, 16, (-1, 0xDC, 0xDD))
        for item in value:
            _pack(out, item)
    elif isinstance(value, dict):
        _pack_len(out, len(value), 0x80, 16, (-1, 0xDE, 0xDF))
        # sorted, as msgpack_serialize's tree_map hands them over
        for key, item in sorted(value.items()):
            _pack(out, key)
            _pack(out, item)
    else:
        msg = f"cannot pack {type(value).__name__}"
        raise TypeError(msg)


def dumps(tree: dict) -> bytes:
    """A nested dict of numpy arrays -> bytes in flax's msgpack format."""
    for leaf in _leaves(tree):
        if leaf.nbytes > 2**30:
            msg = "leaves over 2^30 bytes need flax's chunked form"
            raise ValueError(msg)
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, np.ndarray):
        yield tree


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------
class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            msg = "truncated msgpack data"
            raise ValueError(msg)
        chunk = self.data[self.pos : self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:  # noqa: C901, PLR0911, PLR0912 - one opcode table
        code = self.unpack(">B")
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [self.value() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return self.str(code & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in simple:
            return simple[code]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
        }
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if code in numbers:
            return self.unpack(numbers[code])
        if code in fixext:
            return self.ext(fixext[code])
        if code in sized:
            kind, fmt = sized[code]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(n)
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        msg = f"unknown msgpack type byte 0x{code:02x}"
        raise ValueError(msg)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            msg = (
                "flax chunked-array leaf (an array over 2^30 bytes) is not "
                "read by this codec"
            )
            raise ValueError(msg)
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            msg = f"unknown msgpack ext type {code}"
            raise ValueError(msg)
        inner = _Reader(payload)
        parts = inner.value()
        if (
            inner.pos != len(payload)
            or not isinstance(parts, list)
            or len(parts) != 3
            or not isinstance(parts[2], bytes)
        ):
            msg = "malformed array payload"
            raise ValueError(msg)
        shape, name, buffer = parts
        if name not in _DTYPES:
            msg = f"array dtype {name!r} is not read by this codec"
            raise ValueError(msg)
        arr = np.frombuffer(buffer, dtype=_DTYPES[name]).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def loads(data: bytes) -> Any:
    """Bytes in flax's msgpack format -> nested dicts of numpy arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        msg = f"{len(data) - reader.pos} trailing bytes after the msgpack tree"
        raise ValueError(msg)
    return tree


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> `/`-joined names (the layout of `encoder.npz`)."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten(value, f"{name}/"))
        else:
            flat[name] = value
    return flat


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    """`/`-joined names -> nested dicts."""
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree
