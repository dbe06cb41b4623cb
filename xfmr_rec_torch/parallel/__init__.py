"""Multi-device and multi-process: the device mesh, the sharded train
step and corpus-sharded retrieval (`parallel/mesh.py`); one controller,
or every process of a group after `initialize_distributed`."""

from xfmr_rec_torch.parallel.mesh import (
    create_mesh,
    initialize_distributed,
    process_allgather,
    process_count,
    process_index,
    shard_batch,
)
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
    "initialize_distributed",
    "make_sharded_train_step",
    "process_allgather",
    "process_count",
    "process_index",
    "shard_batch",
    "sharded_certified_topk",
    "sharded_packed_certified_topk",
    "sharded_packed_guaranteed_topk",
    "sharded_packed_topk_excluding",
    "sharded_topk",
]
