"""The port's monitors (`ops.state`, `ops.monitor`, `optimizers.monitors`)
and the closed adaptation loop (`elastic.gns_worker`) against the JAX
package, on the CPU.

Tolerances: the noise-scale arithmetic is f32 on both sides in the same
order of operations, held within 1e-6 relative (one rounding of a
python-scalar product may land on either side); the summed squared
norms and the gradient variance add the same f32 terms in another order
(a dot product and a norm per tensor), within 1e-6 relative.

- `update_noise_scale_from_sq` and `update_noise_scale` over a scripted
  sequence of norms (with a one-worker step that must freeze the EMAs),
  `tree_sq_norm`, the counter and the bias-corrected EMA: equal to the
  JAX functions.
- `gradient_variance` over two in-process libkf peers (threads) against
  the JAX function inside `shard_map` over two CPU devices, on the same
  per-worker gradients.
- `monitor_gradient_noise_scale` over two in-process peers: its
  estimate after each step equals the JAX `update_noise_scale_from_sq`
  chain fed the two norms (the local gradients' mean squared norm and
  the cluster mean's) as numpy forms them in float64, within 1e-5 (the
  f32 norms round differently and the estimate divides a difference),
  and the inner SGD steps on the mean; `monitor_gradient_variance`
  records the variance numpy forms, within 1e-5.
- the GNS loop through the port's harness grows the cluster 2 -> 4 on
  the monitor's reading, with the reference test's asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kungfu_tpu.ops import monitor as jmon
from kungfu_tpu.ops import state as jstate
from kungfu_tpu_torch.elastic import harness
from kungfu_tpu_torch.ops import monitor as mon
from kungfu_tpu_torch.ops import state as pstate
from kungfu_tpu_torch.optimizers import (monitor_gradient_noise_scale,
                                         monitor_gradient_variance)
from test_torch_grad_pipeline import make_peers, run_on_all


@pytest.fixture(autouse=True)
def _cold_joiners(monkeypatch):
    """This file's clusters start their joiners cold (``KF_PREWARM=0``).
    The warm pool has its own tests (test_torch_prewarm.py, and the
    scenario replays run with it), and each warm slot is an import of
    torch at nice 19 that would compete for a loaded host with the JAX
    package's warm-slot tests, whose slots wait 60 s at nice 19."""
    monkeypatch.setenv("KF_PREWARM", "0")


RTOL = 1e-6


def close(a, b, rtol=RTOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(1.0, abs(b)), (a, b)


NORMS = [(8, 16, 5.0, 3.0), (8, 16, 4.5, 2.9), (8, 8, 9.0, 9.0),
         (8, 32, 7.25, 1.5), (8, 16, 1.0, 2.0), (8, 64, 300.0, 1.0),
         (16, 32, 0.0, 0.0), (8, 16, 2.5, 2.25)]


@pytest.mark.parametrize("alpha", [0.6, 0.1])
def test_noise_scale_sequence_equals_the_reference(alpha):
    js, ps = jmon.init_noise_scale(), mon.init_noise_scale()
    for bs, bb, small, big in NORMS:
        js, jn = jmon.update_noise_scale_from_sq(
            js, bs, bb, jnp.float32(small), jnp.float32(big), alpha=alpha)
        ps, pn = mon.update_noise_scale_from_sq(
            ps, bs, bb, torch.tensor(small), torch.tensor(big), alpha=alpha)
        close(pn, jn)
        for a, b in zip(ps, js):
            close(a, b)
    assert float(ps.count) == len(NORMS) - 1  # the 8 == 8 step froze


def test_noise_scale_from_vectors_and_sq_norm():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((30, 7)).astype(np.float32),
            "b": rng.standard_normal(101).astype(np.float32)}
    close(mon.tree_sq_norm([torch.from_numpy(tree[k]) for k in sorted(tree)]),
          jmon.tree_sq_norm(tree))
    local = rng.standard_normal(500).astype(np.float32)
    avg = (0.5 * local + 0.1).astype(np.float32)
    # the vector form's two norms are the reference's within 1e-6 (another
    # summation order); the estimate divides a difference of nearly equal
    # terms, so it is held to the reference fed the SAME two norms
    tl, ta = torch.from_numpy(local), torch.from_numpy(avg)
    sq_small, sq_big = torch.sum(tl * tl), torch.sum(ta * ta)
    close(sq_small, jnp.sum(jnp.square(jnp.asarray(local))))
    close(sq_big, jnp.sum(jnp.square(jnp.asarray(avg))))
    js, jn = jmon.update_noise_scale_from_sq(
        jmon.init_noise_scale(), 8, 32, jnp.float32(float(sq_small)),
        jnp.float32(float(sq_big)))
    ps, pn = mon.update_noise_scale(mon.init_noise_scale(), 8, 32, tl, ta)
    close(pn, jn)
    close(ps.g_ema, js.g_ema)


def test_counter_and_ema_equal_the_reference():
    ji, ju = jstate.counter(3, 2)
    pi, pu = pstate.counter(3, 2)
    js, ps = ji(), pi()
    for _ in range(4):
        jv, js = ju(js)
        pv, ps = pu(ps)
        assert int(jv) == int(pv)
    ji, ju = jstate.ema(0.9)
    pi, pu = pstate.ema(0.9)
    js, ps = ji(), pi()
    for x in (1.0, 3.5, -2.0, 10.0):
        jv, js = ju(js, x)
        pv, ps = pu(ps, x)
        close(pv, jv)
        assert int(ps.count) == int(js.count)


def _worker_grads(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((6, 5)).astype(np.float32),
            (3 * rng.standard_normal(17)).astype(np.float32)]


def test_gradient_variance_equals_the_reference():
    per = [_worker_grads(s) for s in (0, 1)]
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    stacked = [jnp.stack([per[0][i], per[1][i]]) for i in range(2)]

    def body(a, b):
        v = jmon.gradient_variance([a[0], b[0]], "data")
        return v.reshape(1)

    f = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                  out_specs=P("data"), check_vma=False)
    want = np.asarray(jax.jit(f)(*stacked))[0]
    with harness.claim_port_span() as span:
        peers = make_peers(2, int(span.split("-")[0]))
        try:
            run_on_all(peers, lambda p, i: p.start())
            got = run_on_all(peers, lambda p, i: mon.gradient_variance(
                [torch.from_numpy(g) for g in per[i]], group=p))
        finally:
            for p in peers:
                p.close()
    for v in got:
        close(v, want)
    # a world of one has no variance
    assert float(mon.gradient_variance([torch.ones(3)])) == 0.0


def test_monitor_optimizers_over_two_peers():
    B, steps = 8, 4
    grads = {(r, s): _worker_grads(100 * r + s) for r in (0, 1)
             for s in range(steps)}
    with harness.claim_port_span() as span:
        peers = make_peers(2, int(span.split("-")[0]))
        try:
            run_on_all(peers, lambda p, i: p.start())

            def work(p, r):
                ws = [torch.zeros(6, 5, requires_grad=True),
                      torch.zeros(17, requires_grad=True)]
                gns = monitor_gradient_noise_scale(
                    torch.optim.SGD(ws, lr=0.5), device_batch_size=B,
                    group=p)
                vs = [torch.zeros(6, 5, requires_grad=True),
                      torch.zeros(17, requires_grad=True)]
                var = monitor_gradient_variance(torch.optim.SGD(vs, lr=0.5),
                                                group=p)
                readings = []
                for s in range(steps):
                    for opt, params in ((gns, ws), (var, vs)):
                        opt.zero_grad()
                        for w, g in zip(params, grads[(r, s)]):
                            w.grad = torch.from_numpy(g.copy())
                        opt.step(tag=f"0:{s}")
                    readings.append((float(gns.noise_scale),
                                     float(var.variance)))
                return readings, [w.detach().clone() for w in ws]

            out = run_on_all(peers, work)
        finally:
            for p in peers:
                p.close()
    st = jmon.init_noise_scale()
    for s in range(steps):
        loc = [np.concatenate([g.ravel() for g in grads[(r, s)]])
               for r in (0, 1)]
        small = np.mean([float(np.dot(v, v)) for v in loc])
        mean = (loc[0] + loc[1]) / 2
        st, want = jmon.update_noise_scale_from_sq(
            st, B, 2 * B, jnp.float32(small),
            jnp.float32(np.dot(mean, mean)))
        for readings, _ in out:
            close(readings[s][0], want, rtol=1e-5)
    # both workers stepped on the same mean gradient
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    want_w = -0.5 * sum((grads[(0, s)][1] + grads[(1, s)][1]) / 2
                        for s in range(steps))
    np.testing.assert_allclose(out[0][1][1].numpy(), want_w, rtol=1e-5,
                               atol=1e-6)
    for s in range(steps):
        want_v = sum(np.linalg.norm(
            (grads[(0, s)][i].astype(np.float64) ** 2
             + grads[(1, s)][i].astype(np.float64) ** 2) / 2
            - ((grads[(0, s)][i].astype(np.float64)
                + grads[(1, s)][i]) / 2) ** 2) for i in range(2))
        for readings, _ in out:
            close(readings[s][1], want_v, rtol=1e-5)


def test_gns_monitor_drives_the_resize(tmp_path):
    with harness.claim_port_span() as span:
        logs = harness.run_gns_adaptation(
            total_steps=10, ramp_step=4, start_np=2, slots=4,
            port_range=span, timeout=120, logdir=str(tmp_path),
            worker_flags=["--device", "cpu"],
            extra_env={"OMP_NUM_THREADS": "1"})
    # the reference test's asserts
    assert "target 4" in logs, logs
    assert "monitor-resize" in logs and "size=4" in logs, logs
    assert "joined at epoch" in logs, logs
    assert "finished rank=0 size=4 step=10" in logs, logs
