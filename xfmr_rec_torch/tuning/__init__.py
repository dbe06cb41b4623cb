"""Hyperparameter search: adaptive sampling + successive halving."""

from xfmr_rec_torch.tuning.executor import TrialExecutor, worker_device_env
from xfmr_rec_torch.tuning.hpo import (
    AdaptiveSampler,
    PlateauStopper,
    SearchSpace,
    TPESampler,
    TuneResult,
    tune,
    tune_adaptive,
)

__all__ = [
    "AdaptiveSampler",
    "PlateauStopper",
    "SearchSpace",
    "TPESampler",
    "TrialExecutor",
    "TuneResult",
    "tune",
    "tune_adaptive",
    "worker_device_env",
]
