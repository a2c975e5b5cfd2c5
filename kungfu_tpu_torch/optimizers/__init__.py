"""Optimizers of the port: the AdamW that the LM training benchmark runs
(`optimizers.adamw`), synchronous SGD, the gradient all-reduce before
an inner torch optimizer (`optimizers.sync_sgd`), S-SGD with the
gradient noise scale or variance monitor (`optimizers.monitors`), and
the model-averaging family: SMA (`optimizers.sma_sgd`), in-step pair
averaging (`optimizers.async_sgd`) and AdaSGD (`optimizers.ada_sgd`);
and the flat-buffer wrappers that fuse many small updates into few
(`optimizers.fused`)."""

from .ada_sgd import AdaSGD, ada_sgd
from .adamw import lm_adamw
from .async_sgd import PairAveraging, pair_averaging
from .fused import SMALL_LEAF_ELEMS, flatten_optimizer, group_small_leaves
from .monitors import (attach_gradient_noise_scale,
                       monitor_gradient_noise_scale,
                       monitor_gradient_variance)
from .sma_sgd import SMA, sma
from .sync_sgd import (SyncSGD, WrappedOptimizer, bucketed_all_reduce_mean,
                       sync_sgd, sync_sgd_bucketed)

__all__ = ["AdaSGD", "PairAveraging", "SMA",
           "SMALL_LEAF_ELEMS", "SyncSGD", "WrappedOptimizer",
           "ada_sgd", "attach_gradient_noise_scale",
           "bucketed_all_reduce_mean", "flatten_optimizer",
           "group_small_leaves", "lm_adamw",
           "monitor_gradient_noise_scale", "monitor_gradient_variance",
           "pair_averaging", "sma", "sync_sgd", "sync_sgd_bucketed"]
