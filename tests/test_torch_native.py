"""Port parity: the native batch tokenizers against the Python path.

The port's C++ tokenizer (`xfmr_rec_torch/native/tokenizer.cpp`, built by
the local `g++`) must give the ids of the JAX package's pure-Python
tokenizer (`xfmr_rec_tpu.models.tokenizer`, which the port's
`native=False` path mirrors) byte for byte: on the reference's own
cases, on three inputs where the JAX package's native library departs
from its Python path (a KELVIN SIGN, a capital I with a dot, a token of
4097 bytes), on generated text with non-ASCII letters, at 1, 2 and 4
hashes with and without CLS, and for the vocab tokenizer. The JAX
library is built from a copy of its source in a temporary directory.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_native import CASES
from xfmr_rec_torch import native
from xfmr_rec_torch.models.tokenizer import HashingTokenizer as PortHashing
from xfmr_rec_torch.models.tokenizer import TokenizerConfig as PortConfig
from xfmr_rec_torch.models.tokenizer import VocabTokenizer as PortVocab
from xfmr_rec_torch.native import tokenizer_native
from xfmr_rec_tpu.models.tokenizer import (
    HashingTokenizer,
    TokenizerConfig,
    VocabTokenizer,
    build_vocab,
)

REPO_NATIVE = native.SRC_DIR.parent.parent / "xfmr_rec_tpu" / "native"

# where the JAX package's native tokenizer departs from its Python path
FAULTS = ["\u212aevin film", "\u0130stanbul nights", "a" * 4097]
EDGES = ["a" * 4096, "A" * 5000 + "'S tail", "ǅungla ΣΑΣ", "ﬁne ﬂow"]


def python_ids(texts, max_length=32, num_hashes=1, add_cls=True,
               lowercase=True):
    tok = HashingTokenizer(TokenizerConfig(
        vocab_size=30522, max_length=max_length, num_hashes=num_hashes,
        add_cls=add_cls, lowercase=lowercase))
    return tok._encode_batch_python(texts, max_length)


def port_tokenizer(max_length=32, num_hashes=1, add_cls=True,
                   lowercase=True):
    return PortHashing(PortConfig(
        vocab_size=30522, max_length=max_length, num_hashes=num_hashes,
        add_cls=add_cls, lowercase=lowercase))


def port_ids(texts, **kw):
    out = port_tokenizer(**kw).encode_batch(texts)
    return out[..., None] if out.ndim == 2 else out


@pytest.mark.parametrize("add_cls", [True, False])
@pytest.mark.parametrize("num_hashes", [1, 2, 4])
def test_native_equals_python(num_hashes, add_cls):
    texts = CASES + FAULTS + EDGES
    want = python_ids(texts, num_hashes=num_hashes, add_cls=add_cls)
    np.testing.assert_array_equal(
        port_ids(texts, num_hashes=num_hashes, add_cls=add_cls), want)


def test_native_equals_python_without_lowercase():
    texts = CASES + FAULTS + ["lower only TOKENS here", "don't"]
    want = python_ids(texts, max_length=16, lowercase=False, add_cls=False)
    np.testing.assert_array_equal(
        port_ids(texts, max_length=16, lowercase=False, add_cls=False), want)


def test_port_python_path_equals_reference():
    texts = CASES + FAULTS + EDGES
    tok = port_tokenizer(num_hashes=2)
    np.testing.assert_array_equal(
        tok.encode_batch(texts, native=False), python_ids(texts, num_hashes=2))
    np.testing.assert_array_equal(tok.encode_batch(texts),
                                  tok.encode_batch(texts, native=False))


def test_squeezed_at_one_hash_and_max_length_override():
    tok = port_tokenizer(max_length=32)
    out = tok.encode_batch(CASES, max_length=8)
    assert out.shape == (len(CASES), 8) and out.dtype == np.int32
    np.testing.assert_array_equal(out, python_ids(CASES, max_length=8)[..., 0])


LETTERS = st.sampled_from(list(
    "abzAZ09' -_.,\t\u212a\u0130\u0131\u00df\u00e9\u00c9\u01c5"
    "\u03a3\u03c2\ufb01\u65e5\u0307\U0001f600"
))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.text(LETTERS | st.characters(), max_size=40),
                min_size=1, max_size=6),
       st.sampled_from([1, 2, 4]))
def test_native_equals_python_on_generated_text(texts, num_hashes):
    np.testing.assert_array_equal(
        port_ids(texts, max_length=12, num_hashes=num_hashes),
        python_ids(texts, max_length=12, num_hashes=num_hashes))


VOCAB = ["the", "story", "toy", "comedy", "animation", "1995", "children's",
         "f", "m", "age", "k", "i"]
VOCAB_TEXTS = [
    "The Toy Story (1995) comedy",
    "unknown wørds éverywhere",
    "don't can't o' age AGE",
    "",
    "a" * 200,
    *FAULTS,
]


@pytest.mark.parametrize("add_cls", [True, False])
def test_vocab_native_equals_python(add_cls):
    ref = VocabTokenizer(VOCAB, TokenizerConfig(vocab_size=64, max_length=16,
                                                add_cls=add_cls))
    port = PortVocab(VOCAB, PortConfig(vocab_size=64, max_length=16,
                                       add_cls=add_cls))
    want = np.stack([ref.encode(t, 16) for t in VOCAB_TEXTS])
    np.testing.assert_array_equal(port.encode_batch(VOCAB_TEXTS), want)
    np.testing.assert_array_equal(
        port.encode_batch(VOCAB_TEXTS, native=False), want)
    # the map is built once and reused
    handle = port._native
    port.encode_batch(VOCAB_TEXTS[:2])
    assert port._native is handle


def test_vocab_from_corpus_native_equals_python():
    corpus = CASES * 3 + FAULTS
    vocab = build_vocab(corpus, vocab_size=40, oov_buckets=8)
    ref = VocabTokenizer(vocab, TokenizerConfig(vocab_size=40, max_length=24))
    port = PortVocab(vocab, PortConfig(vocab_size=40, max_length=24))
    want = np.stack([ref.encode(t, 24) for t in corpus])
    np.testing.assert_array_equal(port.encode_batch(corpus), want)


@pytest.fixture(scope="module")
def reference_native(tmp_path_factory):
    """The JAX package's tokenizer.cpp, built from a copy in a temporary
    directory with the flags of its own loader."""
    tmp = tmp_path_factory.mktemp("refnative")
    src = tmp / "tokenizer.cpp"
    shutil.copy(REPO_NATIVE / "tokenizer.cpp", src)
    lib_path = tmp / "libtokenizer.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o",
                    str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    offsets = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    out = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i32 = ctypes.c_int32
    lib.encode_batch.argtypes = [ctypes.c_char_p, offsets, ctypes.c_int64,
                                 i32, i32, i32, i32, i32, out]
    lib.encode_batch.restype = None

    def encode(texts, max_length=16):
        blob, offs = tokenizer_native.pack(texts, lowercase=False)
        ids = np.zeros((len(texts), max_length, 1), dtype=np.int32)
        lib.encode_batch(blob, offs, len(texts), max_length, 1, 30522, 1, 1,
                         ids)
        return ids

    return encode


@pytest.mark.parametrize("text", FAULTS)
def test_reference_native_fault_pinned(reference_native, text):
    """The JAX native library departs from the JAX Python path on these
    inputs (it lowercases ASCII only and splits a token at 4096 bytes);
    the port's library does not."""
    want = python_ids([text], max_length=16)
    assert not np.array_equal(reference_native([text]), want)
    np.testing.assert_array_equal(port_ids([text], max_length=16), want)


def test_reference_native_agrees_on_ascii(reference_native):
    texts = [t for t in CASES if t.isascii()]
    np.testing.assert_array_equal(reference_native(texts),
                                  python_ids(texts, max_length=16))


def test_library_named_by_source_hash_and_shared():
    path = native.build("tokenizer.cpp")
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libtokenizer_") and path.suffix == ".so"
    assert native.build("tokenizer.cpp") == path
    assert not list(native.BUILD_DIR.glob("*.tmp"))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cpp"):
        native.build("broken.cpp")
    assert not list((tmp_path / "build").iterdir())
