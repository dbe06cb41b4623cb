"""Multi-device: the device mesh, the sharded train step and
corpus-sharded retrieval (one controller; `parallel/mesh.py`)."""

from xfmr_rec_torch.parallel.mesh import create_mesh, shard_batch
from xfmr_rec_torch.parallel.retrieval import (
    sharded_certified_topk,
    sharded_packed_certified_topk,
    sharded_packed_guaranteed_topk,
    sharded_packed_topk_excluding,
    sharded_topk,
)
from xfmr_rec_torch.parallel.train import make_sharded_train_step

__all__ = [
    "create_mesh",
    "make_sharded_train_step",
    "shard_batch",
    "sharded_certified_topk",
    "sharded_packed_certified_topk",
    "sharded_packed_guaranteed_topk",
    "sharded_packed_topk_excluding",
    "sharded_topk",
]
