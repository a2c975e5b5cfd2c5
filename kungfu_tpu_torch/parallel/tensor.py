"""Tensor parallelism: the historical import surface of the rule tables.

The port of `kungfu_tpu/parallel/tensor.py`. The Megatron rules for the
transformer layers of `models` — column-parallel QKV and up-projections,
row-parallel output and down-projections — live as data in
`parallel.rules`, one ordered table per model family; `shard_params`
gives each rank its blocks, and the modules run the split explicitly
inside ``with mesh:`` (`models.gpt`, `models.bert`). Every name here is
the engine's.
"""

from __future__ import annotations

from .rules import (Rules, bert_tp_rules, gpt_moe_rules,  # noqa: F401
                    gpt_tp_rules, shard_params, spec_for, tree_specs)

__all__ = [
    "Rules",
    "bert_tp_rules",
    "gpt_tp_rules",
    "gpt_moe_rules",
    "spec_for",
    "tree_specs",
    "shard_params",
]
