"""The JAX package's answers to the multi-process searches, in a process
of their own.

`tests/test_torch_multihost.py` starts this beside the port's workers
(the reference's Pallas kernels run in interpret mode on the CPU, which
takes most of the file's time), on the 8 forced CPU devices of
`tests/conftest.py`:

    PYTHONPATH=. python tests/torch_multihost_reference.py <dir>

It reads `<dir>/search.pt` (the exact inputs), runs the five searches of
`tests/torch_multihost_workers.py` through the reference's
`parallel/retrieval.py` with replicated queries on each mesh of
`MESHES`, and writes `<dir>/reference.pt`: (data, model) -> name ->
outputs as numpy arrays.
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import tests.conftest  # noqa: E402, F401 (the 8 CPU devices, before JAX)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests import torch_multihost_workers as workers  # noqa: E402
from xfmr_rec_tpu.parallel import create_mesh  # noqa: E402
from xfmr_rec_tpu.parallel import retrieval  # noqa: E402


def reference_searches(inputs: dict) -> dict:
    out = {}
    for data, model in workers.MESHES:
        mesh = create_mesh(8, model_parallel=model)
        answers = {}
        for name, (fn, args, kw) in workers.search_calls(inputs).items():
            jkw = {
                k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
                for k, v in kw.items()
            }
            got = getattr(retrieval, fn.__name__)(
                *(jnp.asarray(a.numpy()) for a in args[:2]), args[2], mesh,
                shard_queries=False, **jkw,
            )
            answers[name] = [np.asarray(g) for g in got]
        out[(data, model)] = answers
    return out


def main(directory: str) -> int:
    directory = pathlib.Path(directory)
    inputs = torch.load(directory / "search.pt", weights_only=False)
    torch.save(reference_searches(inputs), directory / "reference.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
