"""Optimizers of the port: the AdamW that the LM training benchmark runs
(`optimizers.adamw`), synchronous SGD, the gradient all-reduce before
an inner torch optimizer (`optimizers.sync_sgd`), and S-SGD with the
gradient noise scale or variance monitor (`optimizers.monitors`)."""

from .adamw import lm_adamw
from .monitors import (attach_gradient_noise_scale,
                       monitor_gradient_noise_scale,
                       monitor_gradient_variance)
from .sync_sgd import (SyncSGD, bucketed_all_reduce_mean, sync_sgd,
                       sync_sgd_bucketed)

__all__ = ["SyncSGD", "attach_gradient_noise_scale",
           "bucketed_all_reduce_mean", "lm_adamw",
           "monitor_gradient_noise_scale", "monitor_gradient_variance",
           "sync_sgd", "sync_sgd_bucketed"]
