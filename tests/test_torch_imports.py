"""The port imports without the packages the card's machine lacks.

The machine with the card has torch, numpy and scipy but no JAX, flax,
optax, orbax, msgpack, pandas, pyarrow, pydantic or PyYAML. A
`sys.meta_path` finder refuses those here, in a fresh interpreter, while
every module of the port and `chip_smoke.py` is imported (the native
tokenizer and BM25 bindings, the serve CLI, the IVF index, the portable
encoder, the profiler helpers, the mesh and the sharded index among
them), the two file
formats the history tower adds (flax msgpack, the user store) are
written and read, and the native tokenizer and BM25 build and answer.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "pandas",
           "pyarrow", "pydantic", "yaml")

CODE = f"""
import importlib, importlib.abc, pkgutil, sys, tempfile, pathlib

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ModuleNotFoundError(f"blocked: {{name}}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import xfmr_rec_torch
names = [info.name for info in pkgutil.walk_packages(
    xfmr_rec_torch.__path__, prefix="xfmr_rec_torch.")]
required = {{"xfmr_rec_torch.native.tokenizer_native",
            "xfmr_rec_torch.native.bm25_native",
            "xfmr_rec_torch.serving.prepare",
            "xfmr_rec_torch.index.ivf",
            "xfmr_rec_torch.serving.portable",
            "xfmr_rec_torch.utils.profiling",
            "xfmr_rec_torch.parallel.mesh",
            "xfmr_rec_torch.parallel.retrieval",
            "xfmr_rec_torch.parallel.train",
            "xfmr_rec_torch.index.sharded",
            "xfmr_rec_torch.tuning",
            "xfmr_rec_torch.tuning.hpo",
            "xfmr_rec_torch.tuning.executor"}}
assert required <= set(names), required - set(names)
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
from xfmr_rec_torch.index.mips import BM25Index
from xfmr_rec_torch.models.tokenizer import HashingTokenizer
tok = HashingTokenizer(max_length=8)
texts = ["Toy Story", "\u212aelvin"]
assert (tok.encode_batch(texts, native=True)
        == tok.encode_batch(texts, native=False)).all()
fts = BM25Index([{{"t": "toy story"}}, {{"t": "heat"}}], native=True)
assert fts.search("heat")[0][0] == 1
from xfmr_rec_torch.utils import flax_msgpack
tree = {{"a": {{"b": np.arange(6, dtype=np.float32).reshape(2, 3)}}}}
back = flax_msgpack.loads(flax_msgpack.dumps(tree))
assert (back["a"]["b"] == tree["a"]["b"]).all()
from xfmr_rec_torch.serving.users import UserStore
store = UserStore.from_rows([{{"user_id": 7, "user_rn": 1, "user_text": "t",
    "history": [{{"datetime": 1, "rating": 4, "movie_rn": 2, "movie_id": 9,
                 "movie_text": "m"}}], "target": []}}])
path = pathlib.Path(tempfile.mkdtemp()) / "users.npz"
store.save(path)
assert UserStore.load(path).get(7).history[0].movie_id == 9
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r})
print(loaded, len(names))
sys.exit(1 if loaded else 0)
"""


def test_port_imports_with_missing_packages_blocked():
    result = subprocess.run(
        [sys.executable, "-c", CODE], cwd=REPO, capture_output=True,
        text=True, timeout=300, check=False,
    )
    assert result.returncode == 0, result.stdout + result.stderr
