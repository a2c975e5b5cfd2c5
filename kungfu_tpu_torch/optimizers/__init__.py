"""Optimizers of the port: the AdamW that the LM training benchmark runs
(`optimizers.adamw`) and synchronous SGD, the gradient all-reduce before
an inner torch optimizer (`optimizers.sync_sgd`)."""

from .adamw import lm_adamw
from .sync_sgd import (SyncSGD, bucketed_all_reduce_mean, sync_sgd,
                       sync_sgd_bucketed)

__all__ = ["SyncSGD", "bucketed_all_reduce_mean", "lm_adamw", "sync_sgd",
           "sync_sgd_bucketed"]
