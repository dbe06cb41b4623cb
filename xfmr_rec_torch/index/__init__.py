"""Retrieval indexes: exact MIPS and the IVF probe."""

from xfmr_rec_torch.index.ivf import IVFIndex
from xfmr_rec_torch.index.mips import RetrievalIndex, exact_topk

__all__ = ["IVFIndex", "RetrievalIndex", "exact_topk"]
