"""Data, sequence, tensor, expert and pipeline parallelism of the port
over a `torch.distributed` process group: the worker bootstrap
(`parallel.bootstrap`), the data mesh and the named process mesh
(`parallel.mesh`), ring and Ulysses attention (`parallel.sequence`), the
sharding-rule tables (`parallel.rules`, `parallel.tensor`), the
vocab-sharded fused cross-entropy (`parallel.vocab_ce`), ZeRO-1
(`parallel.zero`), the Switch MoE over an expert axis
(`parallel.expert`), GPipe and 1F1B over a pipe axis
(`parallel.pipeline`) and the train steps (`parallel.train`); and the
asynchronous pair averaging over libkf (`parallel.pair_host`)."""

from .bootstrap import (COORDINATOR_PORT_OFFSET, coordinator_address,
                        init_distributed, shutdown_distributed)
from .mesh import (Axis, DataMesh, ProcessMesh, axis_size, broadcast_params,
                   current_mesh, data_mesh, mesh_axis, replicate_to_workers,
                   seq_mesh, shard_batch, tp_mesh)
from .expert import (MoEParams, dispatch_tensors, init_moe_params,
                     moe_capacity, moe_mlp)
from .pair_host import PairAveragingHost
from .pipeline import (pipeline_apply, pipeline_train_step_1f1b,
                       stack_stage_params)
from .sequence import (heads_to_seq, ring_attention, seq_to_heads,
                       ulysses_attention)
from .rules import (PlanError, RuleTable, bert_tp_rules, gpt_moe_rules,
                    gpt_pp_rules, gpt_serve_rules, gpt_tp_rules,
                    match_partition_rules, moe_ep_rules, reshard,
                    seq_sp_rules, shard_params, spec_diff, tree_specs)
from .train import (build_dp_replicated_train_step, build_gspmd_train_step,
                    build_sp_train_step, build_train_step,
                    build_train_step_with_state)
from .vocab_ce import vocab_sharded_fused_ce
from .zero import zero1_shard_opt_state

__all__ = ["Axis", "COORDINATOR_PORT_OFFSET", "DataMesh", "MoEParams",
           "PairAveragingHost", "PlanError", "ProcessMesh", "RuleTable",
           "axis_size", "bert_tp_rules", "gpt_moe_rules", "gpt_pp_rules",
           "gpt_serve_rules", "gpt_tp_rules", "match_partition_rules",
           "moe_ep_rules", "reshard", "seq_sp_rules", "shard_params",
           "spec_diff", "tp_mesh", "tree_specs", "vocab_sharded_fused_ce",
           "zero1_shard_opt_state",
           "broadcast_params", "build_dp_replicated_train_step",
           "build_gspmd_train_step", "build_sp_train_step",
           "build_train_step", "build_train_step_with_state",
           "coordinator_address", "current_mesh", "data_mesh",
           "dispatch_tensors", "heads_to_seq", "init_distributed",
           "init_moe_params", "mesh_axis", "moe_capacity", "moe_mlp",
           "pipeline_apply", "pipeline_train_step_1f1b",
           "stack_stage_params",
           "replicate_to_workers", "ring_attention", "seq_mesh",
           "seq_to_heads", "shard_batch", "shutdown_distributed",
           "ulysses_attention"]
