"""The sharding-rules engine: specs as data, one ordered table of
``(path regex, spec)`` rules per model family.

The port of `kungfu_tpu/parallel/rules.py`. In the JAX package a table
places each weight with a ``NamedSharding`` and GSPMD inserts the
collectives; here the tables stay data, `shard_params` slices each
rank's local shard out of the full tensor by the rank's `ProcessMesh`
coordinates, and the modules run the Megatron split explicitly
(`models.gpt`, `models.bert`: column-parallel QKV and up-projection,
row-parallel output and down-projection, the collectives of
`ops.collective.copy_to_axis` / `reduce_from_axis`).

A spec is a tuple with one entry per leading dim: an axis name, a
tuple of axis names, or None (`spec`, `replicated`, `stacked`, `rows`,
`cols` build them; the port has no ``PartitionSpec``). A tree is a
mapping of ``/``-joined leaf paths to leaves (tensors, arrays, or shape
tuples), nested mappings flattening with ``/``; an ``nn.Module`` is its
``named_parameters()`` with ``.`` turned into ``/`` (`param_tree`).
The port's modules carry flax's names, so the JAX regexes carry over
verbatim.

Match semantics, as the JAX docstring pins them:

- **first match wins** over the ordered rules (``re.fullmatch`` on the
  leaf path);
- a rule whose spec has more entries than the leaf has dims is
  **skipped** (the rank guard);
- scalars are never partitioned (``()``);
- a `RuleTable` is **total**: an unmatched leaf raises `PlanError` at
  plan time, while a plain sequence of ``(pattern, spec)`` pairs is
  lenient (unmatched leaves replicate).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from functools import lru_cache
from typing import (Callable, Dict, Iterator, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

Spec = Tuple
# rule: (path regex, spec). First match wins.
Rules = Sequence[Tuple[str, Spec]]


class PlanError(ValueError):
    """A sharding plan cannot be derived: unmatched leaf, unknown mesh
    axis, or a non-divisible dimension — raised when the plan is built,
    never from inside a step."""


# -- spec constructors --------------------------------------------------------


def spec(*axes) -> Spec:
    """The generic constructor: one entry per leading dim."""
    return tuple(axes)


def replicated() -> Spec:
    """Fully replicated (the empty spec)."""
    return ()


def stacked(axis: str) -> Spec:
    """Leading dim split over ``axis``."""
    return (axis,)


def rows(axis: str) -> Spec:
    """A 2-D operand split along dim 0 (row-parallel kernels)."""
    return (axis, None)


def cols(axis: str) -> Spec:
    """A 2-D operand split along dim 1 (column-parallel kernels,
    vocab-sharded heads)."""
    return (None, axis)


# -- the rule table -----------------------------------------------------------


@dataclass(frozen=True)
class RuleTable:
    """An ordered, named, *total* rules table for one model family.
    Iterates as ``(pattern, spec)`` pairs. ``axes`` is the table's axis
    universe (derived from the rules unless given); ``batch_axes`` names
    the mesh axes a batch's leading dim shards over."""

    name: str
    rules: Tuple[Tuple[str, Spec], ...]
    batch_axes: Tuple[str, ...] = ()
    axes: Tuple[str, ...] = field(default=())

    def __post_init__(self):
        if not self.axes:
            object.__setattr__(self, "axes", _rule_axes(self.rules))

    def __iter__(self) -> Iterator[Tuple[str, Spec]]:
        return iter(self.rules)

    def __len__(self) -> int:
        return len(self.rules)

    def __getitem__(self, i) -> Tuple[str, Spec]:
        return self.rules[i]


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _spec_axes(s: Spec) -> Tuple[str, ...]:
    out = []
    for entry in s:
        for ax in _entry_axes(entry):
            if ax not in out:
                out.append(ax)
    return tuple(out)


def _rule_axes(rules: Rules) -> Tuple[str, ...]:
    out: list = []
    for _, s in rules:
        for ax in _spec_axes(s):
            if ax not in out:
                out.append(ax)
    return tuple(out)


# -- trees --------------------------------------------------------------------


def param_tree(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A module's parameters by leaf path (``.`` -> ``/``)."""
    return {n.replace(".", "/"): p for n, p in module.named_parameters()}


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    if isinstance(tree, torch.nn.Module):
        tree = param_tree(tree)
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def unflatten_like(tree: Mapping, leaves) -> Dict:
    """A mapping of `tree`'s (nested) keys holding `leaves` in
    `_flatten`'s order."""
    it = iter(leaves)

    def walk(sub):
        return {k: walk(v) if isinstance(v, Mapping) else next(it)
                for k, v in sub.items()}

    return walk(tree)


def leaf_shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tuple of ints (or ``torch.Size``) is a shape;
    tensors and arrays give theirs; a Python scalar has none."""
    if isinstance(leaf, (tuple, torch.Size)):
        return tuple(int(s) for s in leaf)
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


# -- matching -----------------------------------------------------------------


@lru_cache(maxsize=1024)
def _compiled(pattern: str):
    return re.compile(pattern)


def match_index(rules: Rules, path: str, ndim: int) -> Optional[int]:
    """Index of the first rule matching ``path`` at rank ``ndim`` (the
    rank guard skips rules written for larger ranks), or None."""
    for i, (pattern, s) in enumerate(rules):
        if _compiled(pattern).fullmatch(path) is None:
            continue
        if len(s) > ndim:
            continue
        return i
    return None


def spec_for(path: str, ndim: int, rules: Rules) -> Optional[Spec]:
    """First-match-wins spec for one leaf path, or None (unmatched)."""
    i = match_index(rules, path, ndim)
    return None if i is None else rules[i][1]


def match_partition_rules(rules: Rules, tree) -> Dict[str, Spec]:
    """``{leaf path: spec}`` for every leaf of `tree` per the ordered
    rules. Scalars never partition. With a `RuleTable` an unmatched leaf
    raises `PlanError`; a plain rules sequence replicates it."""
    strict = isinstance(rules, RuleTable)
    out = {}
    for path, leaf in _flatten(tree):
        nd = len(leaf_shape(leaf))
        if nd == 0:
            out[path] = replicated()
            continue
        s = spec_for(path, nd, rules)
        if s is None:
            if strict:
                raise PlanError(
                    f"table {rules.name!r}: no rule matches leaf "
                    f"{path!r} (rank {nd}) — rules tables must be total; "
                    "add a rule or a catch-all")
            s = replicated()
        out[path] = s
    return out


def tree_specs(params, rules: Rules) -> Dict[str, Spec]:
    """``{leaf path: spec}`` for every *matched* leaf (unmatched leaves
    are absent)."""
    out = {}
    for path, leaf in _flatten(params):
        s = spec_for(path, len(leaf_shape(leaf)), rules)
        if s is not None:
            out[path] = s
    return out


# -- plan-time validation -----------------------------------------------------


def _axis_sizes(entry, mesh_shape: Mapping[str, int]) -> int:
    return math.prod(int(mesh_shape[ax]) for ax in _entry_axes(entry))


def validate_specs(specs: Mapping[str, Spec], tree,
                   mesh_shape: Mapping[str, int],
                   table_name: str = "<specs>") -> None:
    """Prove a spec map instantiates on ``mesh_shape``: every named axis
    exists and every sharded dim divides. Raises PlanError with the leaf
    path."""
    for path, leaf in _flatten(tree):
        shape = leaf_shape(leaf)
        for dim, entry in enumerate(specs[path]):
            for ax in _entry_axes(entry):
                if ax not in mesh_shape:
                    raise PlanError(
                        f"table {table_name!r}: leaf {path!r} names axis "
                        f"{ax!r} absent from mesh {dict(mesh_shape)}")
            if entry is None:
                continue
            size = _axis_sizes(entry, mesh_shape)
            if shape[dim] % size:
                raise PlanError(
                    f"table {table_name!r}: leaf {path!r} dim {dim} of "
                    f"size {shape[dim]} does not divide over {entry!r} "
                    f"(size {size}) in mesh {dict(mesh_shape)}")


def plan(rules: Rules, tree, mesh_shape: Mapping[str, int]):
    """Validated ``{leaf path: spec}`` for `tree` on ``mesh_shape`` —
    match + validation, so every consumer fails the same way at the same
    time."""
    name = rules.name if isinstance(rules, RuleTable) else "<rules>"
    specs = match_partition_rules(rules, tree)
    validate_specs(specs, tree, mesh_shape, table_name=name)
    return specs


# -- placement / diff ---------------------------------------------------------


def placement_signature(s: Spec, ndim: int,
                        mesh_shape: Mapping[str, int]) -> Tuple:
    """Per-dim ``(axis names, split size)`` of a spec on one mesh shape;
    an axis absent from the mesh splits by 1, so signatures compare
    across mesh shapes."""
    sig = []
    for entry in tuple(s) + (None,) * (ndim - len(s)):
        axes = _entry_axes(entry)
        sig.append((axes, math.prod(int(mesh_shape.get(ax, 1))
                                    for ax in axes)))
    return tuple(sig)


def spec_diff(specs: Mapping[str, Spec], tree, axes_a: Mapping[str, int],
              axes_b: Mapping[str, int]) -> Dict[str, Tuple[Tuple, Tuple]]:
    """``{leaf path: (signature under axes_a, under axes_b)}`` for every
    leaf whose placement changes between the two mesh shapes."""
    out = {}
    for path, leaf in _flatten(tree):
        nd = len(leaf_shape(leaf))
        a = placement_signature(specs[path], nd, axes_a)
        b = placement_signature(specs[path], nd, axes_b)
        if a != b:
            out[path] = (a, b)
    return out


def local_slice(x: torch.Tensor, s: Spec, mesh_shape: Mapping[str, int],
                coords: Mapping[str, int]) -> torch.Tensor:
    """The block of `x` a rank at `coords` holds under spec `s`: each
    sharded dim cut into equal blocks, a tuple entry's axes major to
    minor (the first axis named varies slowest), as ``NamedSharding``
    lays them out. A contiguous copy."""
    for dim, entry in enumerate(s):
        axes = _entry_axes(entry)
        if not axes:
            continue
        idx, n = 0, 1
        for ax in axes:
            idx = idx * int(mesh_shape[ax]) + int(coords[ax])
            n *= int(mesh_shape[ax])
        if n > 1:
            per = x.shape[dim] // n
            x = x.narrow(dim, idx * per, per)
    return x.contiguous()


def place(tree, mesh, specs: Mapping[str, Spec]):
    """Each leaf's local block on this rank of `mesh` (a `ProcessMesh`:
    its ``shape`` and ``coords``). A module's parameters are replaced in
    place by their blocks (the module is returned); a mapping gives a new
    ``{leaf path: block}``."""
    shape, coords = mesh.shape, mesh.coords
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for path, p in _flatten(tree):
                p.data = local_slice(p.data, specs[path], shape, coords)
                p.spec = specs[path]     # the placement, as a sharding
        return tree

    def walk(sub, prefix):
        out = {}
        for k, v in sub.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            out[k] = (walk(v, path) if isinstance(v, Mapping) else
                      local_slice(torch.as_tensor(v), specs[path], shape,
                                  coords))
        return out

    return walk(tree, "")


def reshard(tree, mesh, rules: Rules,
            prev_axes: Optional[Mapping[str, int]] = None):
    """Plan + place `tree` on `mesh` per the table. Returns ``(placed,
    diff)``, `diff` the `spec_diff` against ``prev_axes`` (a fully
    replicated prior when None). `tree` holds full tensors."""
    mesh_shape = dict(mesh.shape)
    specs = plan(rules, tree, mesh_shape)
    diff = spec_diff(specs, tree, dict(prev_axes or {}), mesh_shape)
    return place(tree, mesh, specs), diff


# -- the model-family tables --------------------------------------------------


def _attention_rules(scope: str, axis: str) -> Tuple:
    """Megatron attention split: QKV column-parallel (heads shard), the
    output projection row-parallel, the QKV biases shard with the
    heads."""
    return (
        (r".*(query|key|value).*kernel", spec(None, axis, None)),
        (rf".*{scope}.*out.*kernel", spec(axis, None, None)),
        (r".*(query|key|value).*bias", rows(axis)),
    )


def _mlp_rules(scope: str, axis: str) -> Tuple:
    """Megatron dense-MLP split: up-projection column-parallel,
    down-projection row-parallel."""
    return (
        (rf".*{scope}.*Dense_0.*kernel", cols(axis)),
        (rf".*{scope}.*Dense_1.*kernel", rows(axis)),
        (rf".*{scope}.*Dense_0.*bias", stacked(axis)),
    )


def _megatron_rules(scope: str, axis: str) -> Tuple:
    """The Megatron split anchored to a block scope: the top-level vocab
    heads (also ``Dense_0`` in BERT) fall through to the catch-all."""
    return _attention_rules(scope, axis) + _mlp_rules(scope, axis)


_CATCH_ALL = (r".*", replicated())


def bert_tp_rules(axis: str = "model") -> RuleTable:
    """Megatron split for `models.bert` parameter paths."""
    return RuleTable(
        name=f"bert_tp[{axis}]",
        rules=_megatron_rules("TransformerLayer", axis) + (_CATCH_ALL,),
        batch_axes=("data",))


def gpt_tp_rules(axis: str = "model") -> RuleTable:
    """Megatron split for `models.gpt` parameter paths (Block scope)."""
    return RuleTable(
        name=f"gpt_tp[{axis}]",
        rules=_megatron_rules("Block", axis) + (_CATCH_ALL,),
        batch_axes=("data",))


def gpt_moe_rules(axis: str = "model") -> RuleTable:
    """Expert stacks [E, H, F] over `axis`, the router replicated, the
    attention split of `gpt_tp_rules` (a MoE GPT's blocks have no dense
    MLP)."""
    return RuleTable(
        name=f"gpt_moe[{axis}]",
        rules=(
            (r".*moe.*w_(up|down)", spec(axis, None, None)),
            (r".*moe.*router", replicated()),
        ) + _attention_rules("Block", axis) + (_CATCH_ALL,),
        batch_axes=("data",))


def gpt_pp_rules(axis: str = "pipe",
                 tp_axis: Optional[str] = None) -> RuleTable:
    """Stage-stacked pipeline placement of the stacked block half
    (leading [num_stages, layers_per_stage] dims, the Block scope
    stripped): the stage dim over `axis`; with `tp_axis` the Megatron
    split composes in behind the two stage entries."""
    if tp_axis is None:
        body: Tuple = ()
    else:
        body = (
            (r".*(query|key|value).*kernel",
             spec(axis, None, None, tp_axis, None)),
            (r".*out.*kernel", spec(axis, None, tp_axis, None, None)),
            (r".*Dense_0.*kernel", spec(axis, None, None, tp_axis)),
            (r".*Dense_1.*kernel", spec(axis, None, tp_axis, None)),
            (r".*(query|key|value).*bias",
             spec(axis, None, tp_axis, None)),
            (r".*Dense_0.*bias", spec(axis, None, tp_axis)),
        )
    return RuleTable(
        name=(f"gpt_pp[{axis}]" if tp_axis is None
              else f"gpt_pp[{axis}x{tp_axis}]"),
        rules=body + ((r".*", stacked(axis)),),
        batch_axes=())


def gpt_serve_rules(axis: str = "model") -> RuleTable:
    """The decode tier's placement: the Megatron block split, embeddings
    and the logits head replicated. A table of its own, so training and
    serving layouts evolve independently."""
    return RuleTable(
        name=f"gpt_serve[{axis}]",
        rules=_megatron_rules("Block", axis) + (_CATCH_ALL,),
        batch_axes=("data",))


def moe_ep_rules(axis: str = "expert") -> RuleTable:
    """Expert-parallel placement of a MoE layer's global view: expert
    stacks over `axis`, the router replicated. No catch-all: any other
    leaf is a wrong tree and must raise."""
    return RuleTable(
        name=f"moe_ep[{axis}]",
        rules=(
            (r".*router", replicated()),
            (r".*w_(up|down)", spec(axis, None, None)),
        ),
        batch_axes=(axis,))


def seq_sp_rules(data_axis: str = "data",
                 seq_axis: str = "seq") -> RuleTable:
    """Sequence-parallel placement: parameters replicate; the batch
    spec carries the [B, T] token layout (rows over data, positions over
    seq)."""
    return RuleTable(
        name=f"seq_sp[{data_axis}x{seq_axis}]",
        rules=(_CATCH_ALL,),
        batch_axes=(data_axis, seq_axis),
        axes=(data_axis, seq_axis))


# -- the registry -------------------------------------------------------------


@dataclass(frozen=True)
class RegisteredTable:
    """One table, the ``{leaf path: shape}`` template of a
    representative tree of its family, and the mesh shapes it may be
    instantiated on."""

    table: RuleTable
    template: Callable[[], Dict[str, Tuple[int, ...]]]
    mesh_shapes: Tuple[Mapping[str, int], ...]


REGISTRY: Dict[str, RegisteredTable] = {}


def register(name: str, table: RuleTable,
             template: Callable[[], Dict[str, Tuple[int, ...]]],
             mesh_shapes: Sequence[Mapping[str, int]]) -> None:
    """Register a table (re-registration replaces)."""
    REGISTRY[name] = RegisteredTable(
        table=table, template=template,
        mesh_shapes=tuple(dict(m) for m in mesh_shapes))


def _shapes(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {path: tuple(p.shape) for path, p in param_tree(module).items()}


@lru_cache(maxsize=8)
def _template_bert() -> Dict[str, Tuple[int, ...]]:
    """The tensor-parallel dry run's BERT (heads 4, intermediate 64),
    built on the meta device."""
    from ..models.bert import BertConfig, BertEncoder

    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                     num_heads=4, intermediate_size=64, max_position=8,
                     dtype=torch.float32)
    return _shapes(BertEncoder(cfg, device="meta"))


def _gpt_dryrun_config(num_layers: int = 2):
    from ..models.gpt import GPTConfig

    return GPTConfig(vocab_size=251, hidden_size=128, num_layers=num_layers,
                     num_heads=4, intermediate_size=256, max_position=32,
                     dtype=torch.float32)


@lru_cache(maxsize=8)
def _template_gpt(num_experts: int = 0) -> Dict[str, Tuple[int, ...]]:
    """The dp x tp dry run's GPT (vocab 251: deliberately non-divisible,
    covered by the catch-all). With `num_experts`, each block's dense MLP
    is the Switch MoE layer (``moe/router [H, E]``, ``moe/w_up [E, H,
    F]``, ``moe/w_down [E, F, H]``)."""
    from dataclasses import replace

    from ..models.gpt import GPTLM

    cfg = replace(_gpt_dryrun_config(), num_experts=num_experts)
    return _shapes(GPTLM(cfg, device="meta"))


@lru_cache(maxsize=8)
def _template_moe_params() -> Dict[str, Tuple[int, ...]]:
    """The expert-parallel dry run's global view (E = 4)."""
    hidden, ffn, experts = 16, 32, 4
    return {"router": (hidden, experts),
            "w_up": (experts, hidden, ffn),
            "w_down": (experts, ffn, hidden)}


@lru_cache(maxsize=8)
def _template_gpt_stacked(stages: int = 2) -> Dict[str, Tuple[int, ...]]:
    """The stacked block half at the dry run's GPT shapes: every Block
    leaf under leading [stages, layers_per_stage] dims, the Block scope
    stripped."""
    from ..models.gpt import GPTLM

    shapes = _shapes(GPTLM(_gpt_dryrun_config(stages), device="meta"))
    block = {p.split("/", 1)[1]: s for p, s in shapes.items()
             if p.startswith("Block_0/")}
    return {p: (stages, 1) + s for p, s in sorted(block.items())}


def _register_builtin_tables() -> None:
    register("bert_tp", bert_tp_rules(), _template_bert,
             [{"data": 4, "model": 2}, {"data": 2, "model": 2},
              {"data": 1, "model": 2}])
    register("gpt_tp", gpt_tp_rules(), _template_gpt,
             [{"data": 4, "model": 2}, {"data": 2, "model": 2},
              {"model": 2, "pipe": 2}])
    register("gpt_moe", gpt_moe_rules(), lambda: _template_gpt(4),
             [{"data": 4, "model": 2}, {"data": 2, "model": 2}])
    register("moe_ep", moe_ep_rules(), _template_moe_params,
             [{"expert": 2}, {"expert": 4}])
    register("seq_sp", seq_sp_rules(), _template_bert,
             [{"data": 2, "seq": 4}, {"data": 2, "seq": 2}])
    register("gpt_pp", gpt_pp_rules(), _template_gpt_stacked,
             [{"pipe": 2}, {"pipe": 2, "model": 2}])
    register("gpt_pp_tp", gpt_pp_rules(tp_axis="model"),
             _template_gpt_stacked,
             [{"data": 2, "model": 2, "pipe": 2},
              {"model": 2, "pipe": 2}])
    register("gpt_serve", gpt_serve_rules(), _template_gpt,
             [{"data": 1, "model": 2}, {"data": 2, "model": 2}])


_register_builtin_tables()


def _table_universe(table: RuleTable) -> Tuple[str, ...]:
    return table.axes + tuple(a for a in table.batch_axes
                              if a not in table.axes)


#: table constructor -> its default axis universe (rule axes, then
#: batch axes), derived from the table objects
TABLE_AXES: Dict[str, Tuple[str, ...]] = {
    f.__name__: _table_universe(f())
    for f in (bert_tp_rules, gpt_tp_rules, gpt_moe_rules,
              gpt_pp_rules, moe_ep_rules, seq_sp_rules,
              gpt_serve_rules)
}


# -- shard_params: the one placement entry point ------------------------------


def shard_params(params, mesh, rules: Rules):
    """Each parameter's local block on this rank of `mesh` per the first
    matching rule. `params` is a module (its parameters replaced in
    place by their blocks; the module is returned) or a mapping of full
    tensors (a new ``{leaf path: block}``). A `RuleTable` is validated
    first (coverage, axis existence and divisibility raise `PlanError`);
    a plain pairs sequence is lenient. Every rank must pass the same
    full tensors (the same seed)."""
    if isinstance(rules, RuleTable):
        specs = plan(rules, params, dict(mesh.shape))
    else:
        specs = match_partition_rules(rules, params)
    return place(params, mesh, specs)
