"""Stateful scalar helpers: step counter and exponential moving average.

The port of `kungfu_tpu/ops/state.py` (reference:
srcs/cpp/src/tensorflow/ops/cpu/state.cpp:6-78 KungfuCounter /
KungfuExponentialMovingAverage; srcs/cpp/include/kungfu/utils/ema.hpp).
The state stays explicit — NamedTuples of 0-d tensors and pure update
functions, as in the JAX package — with the arithmetic in f32 (the EMA)
and int32 (the counter), so the values match the JAX functions' for
the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CounterState(NamedTuple):
    value: torch.Tensor  # int32


def counter(init: int = 0, incr: int = 1):
    """Returns (init_state, update) — update bumps and returns the *pre*
    increment value, matching the reference kernel's semantics."""

    def init_fn() -> CounterState:
        return CounterState(value=torch.tensor(init, dtype=torch.int32))

    def update(state: CounterState):
        return state.value, CounterState(value=state.value + incr)

    return init_fn, update


class EMAState(NamedTuple):
    value: torch.Tensor   # running average (bias-corrected on read)
    count: torch.Tensor   # int32 number of updates


def ema(alpha: float):
    """Bias-corrected EMA: value_t = a*value + (1-a)*x, read corrected by
    1/(1-a^t) (reference: ema.hpp bias correction)."""
    a = float(alpha)

    def init_fn(like=0.0) -> EMAState:
        like = torch.as_tensor(like, dtype=torch.float32)
        return EMAState(value=torch.zeros_like(like),
                        count=torch.tensor(0, dtype=torch.int32))

    def update(state: EMAState, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        count = state.count + 1
        value = a * state.value + (1.0 - a) * x
        corrected = value / (1.0 - a ** count.to(torch.float32))
        return corrected, EMAState(value=value, count=count)

    return init_fn, update
