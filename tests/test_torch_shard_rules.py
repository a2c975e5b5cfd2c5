"""The port's rule tables (`kungfu_tpu_torch.parallel.rules`) against the
JAX package's (`kungfu_tpu.parallel.rules`), in one process.

A port spec is the tuple of a ``PartitionSpec``'s entries, so each
comparison is ``tuple(jax_spec) == port_spec``:

- every registered table gives the same spec leaf for leaf on the JAX
  templates, on the port's templates (the same paths and shapes, built
  from the port's modules on the meta device) and on the port's GPT-2
  and BERT-base parameter names;
- the match semantics (first match, the rank guard, scalars, a total
  table against a lenient sequence of pairs);
- `PlanError` names the same leaf path, in the same words, for an
  unknown axis and for a dim that does not divide;
- `placement_signature` and `spec_diff` give the JAX results;
- `local_slice` cuts the blocks ``NamedSharding`` lays out.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kungfu_tpu.parallel import rules as J
from kungfu_tpu_torch.models.bert import BertConfig, BertEncoder
from kungfu_tpu_torch.models.gpt import GPTConfig, GPTLM
from kungfu_tpu_torch.parallel import rules as R

TABLES = sorted(J.REGISTRY)


def _tuple(s):
    return None if s is None else tuple(s)


@pytest.mark.parametrize("name", TABLES)
def test_registry_templates_and_specs_match(name):
    jt, pt = J.REGISTRY[name], R.REGISTRY[name]
    assert pt.table.name == jt.table.name
    assert pt.table.axes == jt.table.axes
    assert pt.table.batch_axes == jt.table.batch_axes
    assert pt.table.rules == tuple((p, tuple(s)) for p, s in jt.table.rules)
    assert pt.mesh_shapes == jt.mesh_shapes
    assert pt.template() == jt.template()
    for path, shape in jt.template().items():
        assert R.spec_for(path, len(shape), pt.table) == _tuple(
            J.spec_for(path, len(shape), jt.table)), path
    for mesh_shape in jt.mesh_shapes:
        tree = {p: np.zeros(s, np.float32) for p, s in jt.template().items()}
        want = J.plan(jt.table, tree, mesh_shape)
        got = R.plan(pt.table, jt.template(), mesh_shape)
        assert got == {p: tuple(s) for p, s in want.items()}


def _port_names(kind):
    model = (GPTLM(GPTConfig(), device="meta") if kind == "gpt"
             else BertEncoder(BertConfig(), device="meta"))
    return {p: tuple(t.shape) for p, t in R.param_tree(model).items()}


@pytest.mark.parametrize("kind,tables", [
    ("gpt", ("gpt_tp", "gpt_serve", "gpt_moe")),
    ("bert", ("bert_tp", "seq_sp"))])
def test_tables_on_port_parameter_names(kind, tables):
    """GPT-2-small's and BERT-base's ``named_parameters()`` paths get the
    JAX tables' specs, and the Megatron rules claim every block kernel."""
    shapes = _port_names(kind)
    for name in tables:
        jt, pt = J.REGISTRY[name].table, R.REGISTRY[name].table
        specs = R.match_partition_rules(pt, shapes)
        for path, shape in shapes.items():
            assert specs[path] == (
                () if not shape else _tuple(J.spec_for(path, len(shape),
                                                       jt)) or ()), path
    specs = R.match_partition_rules(R.REGISTRY[tables[0]].table, shapes)
    sharded = [p for p, s in specs.items() if s]
    layers = 12
    # q, k, v, out kernels, q, k, v biases, Dense_0 kernel and bias,
    # Dense_1 kernel: 10 a layer
    assert len(sharded) == 10 * layers, sorted(sharded)
    head = "lm_head/kernel" if kind == "gpt" else "Dense_0/kernel"
    assert specs[head] == ()


@pytest.mark.parametrize("rules,path,ndim", [
    (((r".*w", P("a")), (r"x/w", P("b")), (r".*", P())), "x/w", 1),
    (((r".*w.*", P(None, "a")), (r".*", P("a"))), "w/kernel", 2),
    (((r".*w.*", P(None, "a")), (r".*", P("a"))), "w/bias", 1),
    (((r"only/this", P("a")),), "other", 1),
    (tuple(J.gpt_tp_rules()),
     "0/mu/Block_0/CausalSelfAttention_0/query/kernel", 3),
    (tuple(J.bert_tp_rules()), "Dense_0/kernel", 2),
    (tuple(J.bert_tp_rules()), "TransformerLayer_1/Dense_1/kernel", 2),
], ids=["first-match", "rank-guard-kernel", "rank-guard-bias",
        "unmatched", "opt-state-suffix", "bert-head", "bert-mlp"])
def test_match_semantics(rules, path, ndim):
    port = tuple((p, tuple(s)) for p, s in rules)
    assert R.spec_for(path, ndim, port) == _tuple(
        J.spec_for(path, ndim, rules))
    assert R.match_index(port, path, ndim) == J.match_index(rules, path,
                                                            ndim)


def test_scalars_totality_and_lenience():
    tree = {"s": 3.0, "v": np.zeros(4)}
    jt = J.RuleTable("t", ((r".*", P("a")),))
    pt = R.RuleTable("t", ((r".*", ("a",)),))
    assert R.match_partition_rules(pt, tree) == {
        k: tuple(v) for k, v in J.match_partition_rules(jt, tree).items()}
    strict_j = J.RuleTable("t", ((r"only/this", P("a")),))
    strict_p = R.RuleTable("t", ((r"only/this", ("a",)),))
    other = {"other": np.zeros(4)}
    with pytest.raises(J.PlanError) as je:
        J.match_partition_rules(strict_j, other)
    with pytest.raises(R.PlanError) as pe:
        R.match_partition_rules(strict_p, other)
    assert str(pe.value) == str(je.value)
    lenient = ((r"only/this", ("a",)),)
    assert R.match_partition_rules(lenient, other) == {"other": ()}
    assert R.tree_specs(other, lenient) == {}


@pytest.mark.parametrize("entry,mesh_shape", [
    ("a", {"a": 4}),             # 6 does not divide over 4
    ("b", {"a": 2}),             # axis b absent
    (("a", "b"), {"a": 2, "b": 2}),
], ids=["non-divisible", "unknown-axis", "tuple-non-divisible"])
def test_plan_error_names_the_leaf(entry, mesh_shape):
    tree = {"blk": {"w": np.zeros((6, 8), np.float32)}}
    jt = J.RuleTable("t", ((r".*", P(entry, None)),))
    pt = R.RuleTable("t", ((r".*", (entry, None)),))
    with pytest.raises(J.PlanError) as je:
        J.plan(jt, tree, mesh_shape)
    with pytest.raises(R.PlanError) as pe:
        R.plan(pt, tree, mesh_shape)
    assert "'blk/w'" in str(pe.value)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("a,b", [
    ({"data": 2, "model": 2}, {"model": 2, "pipe": 2}),
    ({"data": 2, "model": 2}, {"model": 4, "pipe": 2}),
    ({}, {"data": 1, "model": 2}),
], ids=["same-split", "model-grows", "fresh"])
def test_placement_signature_and_spec_diff(a, b):
    shapes = J.REGISTRY["bert_tp"].template()
    tree = {p: np.zeros(s, np.float32) for p, s in shapes.items()}
    jspecs = J.match_partition_rules(J.bert_tp_rules(), tree)
    pspecs = R.match_partition_rules(R.bert_tp_rules(), shapes)
    assert R.spec_diff(pspecs, shapes, a, b) == J.spec_diff(jspecs, tree,
                                                            a, b)
    for path, shape in shapes.items():
        assert R.placement_signature(pspecs[path], len(shape), b) == \
            J.placement_signature(jspecs[path], len(shape), b)


@pytest.mark.parametrize("s", [P("data", None), P(None, "model"),
                               P(("data", "model"), None),
                               P("model", "data"), P()])
def test_local_slice_is_the_named_sharding_block(s):
    """Each device's block under ``NamedSharding`` equals `local_slice`
    at that device's mesh coordinates."""
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    shape = {"data": 2, "model": 4}
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))
    arr = jax.device_put(x, NamedSharding(mesh, s))
    where = {d: (i, j) for i, row in enumerate(mesh.devices)
             for j, d in enumerate(row)}
    for shard in arr.addressable_shards:
        i, j = where[shard.device]
        got = R.local_slice(torch.tensor(x), tuple(s), shape,
                            {"data": i, "model": j})
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def test_shard_params_on_a_module_records_the_spec():
    """`shard_params` on a module keeps each Parameter object, replaces
    its data by the block and records the spec (what ZeRO-1 reads)."""

    class _Mesh:
        shape = {"data": 1, "model": 2}
        coords = {"data": 0, "model": 1}

    model = GPTLM(GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                            num_heads=4, intermediate_size=64,
                            max_position=8, dtype=torch.float32),
                  generator=torch.Generator().manual_seed(0))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    q = model.Block_0.CausalSelfAttention_0.query.kernel
    R.shard_params(model, _Mesh(), R.gpt_tp_rules())
    assert model.Block_0.CausalSelfAttention_0.query.kernel is q
    assert q.shape == (32, 2, 8) and q.spec == (None, "model", None)
    torch.testing.assert_close(
        q.data, full["Block_0.CausalSelfAttention_0.query.kernel"][:, 2:])
    assert model.lm_head.kernel.shape == (32, 64)
    assert model.Block_0.Dense_1.kernel.shape == (32, 32)
    with pytest.raises(R.PlanError, match="does not divide"):
        R.shard_params(GPTLM(GPTConfig(vocab_size=64, hidden_size=32,
                                       num_layers=1, num_heads=4,
                                       intermediate_size=63,
                                       max_position=8), device="meta"),
                       _Mesh(), R.gpt_tp_rules())


def test_table_axes_match():
    assert R.TABLE_AXES == J.TABLE_AXES


# -- restore_on_mesh and the elastic resync's placement ------------------------


class _Mesh:
    """A mesh shape and this rank's coordinates (what `place` reads)."""

    def __init__(self, shape, coords):
        self.shape, self.coords = dict(shape), dict(coords)


def _bert_tree():
    """The dry run's BERT parameters as a nested mapping of tensors."""
    model = BertEncoder(BertConfig(vocab_size=64, hidden_size=32,
                                   num_layers=1, num_heads=4,
                                   intermediate_size=64, max_position=8,
                                   dtype=torch.float32),
                        generator=torch.Generator().manual_seed(3))
    tree = {}
    for path, p in R.param_tree(model).items():
        node = tree
        *scopes, leaf = path.split("/")
        for k in scopes:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().clone()
    return tree


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _peers(n, base):
    from kungfu_tpu_torch import env as kfenv
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.plan import PeerList

    peers = PeerList.parse(",".join(f"127.0.0.1:{base + i}"
                                    for i in range(n)))
    return [Peer(kfenv.Config(self_id=peers[i], init_peers=peers,
                              version=0, timeout_ms=20000))
            for i in range(n)]


def _run_on_all(peers, fn):
    import threading

    results, errors = [None] * len(peers), []

    def work(i):
        try:
            results[i] = fn(peers[i], i)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    ts = [threading.Thread(target=work, args=(i,))
          for i in range(len(peers))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return results


def _jax_diff(shapes, table, a, b):
    tree = {p: np.zeros(s, np.float32) for p, s in shapes.items()}
    return J.spec_diff(J.match_partition_rules(table, tree), tree, a, b)


def test_dp_tp_save_restores_onto_tp_pp_cluster(tmp_path):
    """Saved on a dp x tp mesh by two ranks, restored onto a tp x pp one
    by two in-process peers: the bytes hash-verified by
    `restore_sharded`, each rank holding its ``bert_tp`` blocks, the diff
    empty (the model axis kept size 2) as the JAX function finds it."""
    from kungfu_tpu_torch import checkpoint_async as ca
    from kungfu_tpu_torch.elastic.harness import claim_port_span

    d = str(tmp_path)
    tree = _bert_tree()
    flat = dict(R._flatten(tree))
    gen = ca.next_generation(d)
    for r in reversed(range(2)):
        ca.save_sharded(d, tree, step=11, rank=r, nprocs=2,
                        chunk_bytes=2048, gen=gen,
                        mesh_axes={"data": 2, "model": 2})
    shape = {"model": 2, "pipe": 2}
    with claim_port_span() as span:
        peers = _peers(2, int(span.split("-")[0]))
        try:
            _run_on_all(peers, lambda p, i: p.start())
            outs = _run_on_all(peers, lambda p, i: ca.restore_on_mesh(
                d, _zeros_like(tree), mesh=_Mesh(shape, {"model": i,
                                                         "pipe": 0}),
                rules_table=R.bert_tp_rules(), peer=p))
        finally:
            for p in peers:
                p.close()
    shapes = {p: tuple(t.shape) for p, t in flat.items()}
    assert _jax_diff(shapes, J.bert_tp_rules(), {"data": 2, "model": 2},
                     shape) == {}
    specs = R.plan(R.bert_tp_rules(), shapes, shape)
    for i, (placed, step, meta, residual, diff) in enumerate(outs):
        assert step == 11 and residual is None and diff == {}
        assert meta["mesh_axes"] == {"data": 2, "model": 2}
        got = dict(R._flatten(placed))
        for path, full in flat.items():
            want = R.local_slice(full, specs[path], shape,
                                 {"model": i, "pipe": 0})
            assert torch.equal(got[path], want), path


def test_axis_growth_reports_diff_single_process(tmp_path):
    from kungfu_tpu_torch import checkpoint_async as ca

    d = str(tmp_path)
    tree = _bert_tree()
    ca.save_sharded(d, tree, step=5, rank=0, nprocs=1,
                    mesh_axes={"data": 4, "model": 2})
    shape = {"model": 4, "pipe": 2}
    placed, step, meta, residual, diff = ca.restore_on_mesh(
        d, _zeros_like(tree), mesh=_Mesh(shape, {"model": 3, "pipe": 1}),
        rules_table=R.bert_tp_rules())
    shapes = {p: tuple(t.shape) for p, t in R._flatten(tree)}
    assert step == 5
    assert diff == _jax_diff(shapes, J.bert_tp_rules(),
                             {"data": 4, "model": 2}, shape)
    assert any("query/kernel" in k for k in diff)
    q = placed["TransformerLayer_0"]["MultiHeadDotProductAttention_0"][
        "query"]["kernel"]
    assert q.shape == (32, 1, 8)


def test_async_saver_records_mesh_axes(tmp_path):
    from kungfu_tpu_torch import checkpoint_async as ca

    d = str(tmp_path)
    ckpt = ca.AsyncShardedCheckpointer(d)
    try:
        ckpt.save({"w": torch.ones(4, 4)}, step=1,
                  mesh_axes={"data": 2, "model": 2}, block=True)
    finally:
        ckpt.close()
    _, step, meta, _ = ca.restore_sharded(d, {"w": torch.zeros(4, 4)})
    assert step == 1 and meta["mesh_axes"] == {"data": 2, "model": 2}


def test_invalid_target_mesh_raises_before_placement(tmp_path):
    from kungfu_tpu_torch import checkpoint_async as ca

    d = str(tmp_path)
    tree = _bert_tree()
    ca.save_sharded(d, tree, step=1, rank=0, nprocs=1)
    with pytest.raises(R.PlanError, match="does not divide"):
        ca.restore_on_mesh(d, _zeros_like(tree),
                           mesh=_Mesh({"model": 3}, {"model": 0}),
                           rules_table=R.bert_tp_rules())


def test_resync_placement_reshards_after_broadcast():
    """`resync_params(placement=...)` over two in-process peers: the
    joiner adopts rank 0's tree, each rank keeps its block per the table,
    and the timings record the diff's size."""
    from kungfu_tpu_torch.elastic.harness import claim_port_span
    from kungfu_tpu_torch.elastic.hooks import ElasticCallback

    tree = {"w": {"kernel": torch.arange(64, dtype=torch.float32)
                  .reshape(8, 8)}}
    table = R.RuleTable("resync", ((r".*kernel", (None, "model")),
                                   (r".*", ())))
    shape = {"data": 1, "model": 2}
    with claim_port_span() as span:
        peers = _peers(2, int(span.split("-")[0]))
        try:
            _run_on_all(peers, lambda p, i: p.start())

            def work(p, i):
                cb = ElasticCallback(p, config_server="")
                src = tree if i == 0 else _zeros_like(tree)
                mesh = _Mesh(shape, {"data": 0, "model": i})
                out = cb.resync_params(
                    {"w": {"kernel": src["w"]["kernel"].clone()}},
                    placement=(mesh, table))
                return out, cb.last_resize_timings

            outs = _run_on_all(peers, work)
        finally:
            for p in peers:
                p.close()
    for i, (out, timings) in enumerate(outs):
        assert torch.equal(out["w"]["kernel"],
                           tree["w"]["kernel"][:, 4 * i:4 * (i + 1)])
        assert timings["reshard_leaves"] == 1
        assert timings["reshard_ms"] >= 0
    with pytest.raises(ValueError, match="mapping"):
        ElasticCallback.resync_params(None, [torch.zeros(2)],
                                      placement=(None, table))
