"""Optimizers of the port: the AdamW that the LM training benchmark
runs (`optimizers.adamw`)."""

from .adamw import lm_adamw

__all__ = ["lm_adamw"]
