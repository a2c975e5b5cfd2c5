"""Monitor-driven cluster sizing: the adaptation loop, closed.

The reference computes the gradient noise scale and prints it
(reference: srcs/python/kungfu/tensorflow/optimizers/grad_noise_scale.py:
37-69) — the adaptation story (README "adaptive training") leaves acting
on it to the user. Here the statistic drives the elastic runtime
directly: a policy maps the observed noise scale to a desired cluster
size, and `ElasticCallback` proposes it through the config server, where
the consensus-resize machinery (peer.resize_from_url) takes over.

The sizing rule follows the GNS paper ("An Empirical Model of
Large-Batch Training"): training is efficient while the global batch is
below the noise scale, so the target worker count is the one whose
global batch tracks ``noise_scale / device_batch``.

`GoodputPolicy` extends the same loop from a statistical signal to a
COST signal: it reads the goodput families the `GoodputMeter`
maintains on the /metrics registry (``kf_useful_ms_total`` /
``kf_lost_ms_total{phase=...}``, trace/goodput.py) and prices its
decisions — ride out a transient straggler vs pay a resize to shed
it (ski-rental: shed only once the straggler has cost a resize's
worth), and grow only when the throughput gain amortizes the
recompile+resync stall over the remaining run. `NaiveStragglerPolicy`
is the static baseline the goodput benchmark compares against: shed
on the first sustained wire spike, no cost model — the policy that
pays a full resize for every thermal hiccup.

The port's copy of `kungfu_tpu/elastic/policy.py`, which imports no JAX:
only a docstring's module path changed. The policies read the port's
/metrics registry (`trace.metrics.REGISTRY`), which `trace.goodput.
GoodputMeter` feeds.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from statistics import median


@dataclass
class NoiseScalePolicy:
    """Maps an EMA'd noise-scale reading to a proposed cluster size.

    Use with :class:`~kungfu_tpu_torch.elastic.ElasticCallback`::

        policy = NoiseScalePolicy(device_batch=64, max_size=8)
        elastic = ElasticCallback(peer, policy=policy)
        ...
        policy.observe(float(opt_state.noise_scale))   # from GNS monitor
        if elastic.after_step():
            ...

    `hysteresis` consecutive identical targets are required before the
    policy emits a proposal, so one noisy estimate cannot churn the
    cluster (resizes cost a recompile + resync).
    """

    device_batch: int
    min_size: int = 1
    max_size: int = 8
    hysteresis: int = 2
    noise_scale: float = 0.0
    _pending: int = field(default=0, repr=False)
    _streak: int = field(default=0, repr=False)

    def observe(self, noise_scale: float) -> None:
        """Feed the latest monitor reading (e.g. GNSMonitorState.noise_scale)."""
        self.noise_scale = float(noise_scale)

    def target_size(self) -> int:
        want = round(self.noise_scale / max(self.device_batch, 1))
        return max(self.min_size, min(self.max_size, want))

    def __call__(self, current_size: int) -> int | None:
        """Desired cluster size, or None to leave the cluster alone."""
        if self.noise_scale <= 0.0:
            return None
        want = self.target_size()
        if want == current_size:
            self._streak = 0
            return None
        if want == self._pending:
            self._streak += 1
        else:
            self._pending, self._streak = want, 1
        if self._streak >= self.hysteresis:
            self._streak = 0
            return want
        return None


@dataclass
class SLOPolicy:
    """Queue-depth / latency-SLO sizing for the decode tier
    (docs/serving.md) — the serving sibling of `NoiseScalePolicy`
    (statistical signal) and `GoodputPolicy` (cost signal).

    The signal is the request ledger's ``/serve/stats``: each decode
    worker feeds ``observe()`` once per iteration, and the policy
    proposes a size through the SAME `ElasticCallback` propose ->
    consensus-resize path training uses. Grow when ingest outruns the
    tier (queue depth beyond ``backlog_per_worker`` per worker, or
    completed-request p99 above ``p99_target_ms``); shrink when the
    tier idles (empty queue AND in-flight work fits the smaller
    cluster) for ``idle_patience`` consecutive observations.
    `hysteresis` consecutive identical targets are required before a
    proposal — one bursty scrape must not churn the cluster, because
    a serving resize stalls EVERY in-flight request for the
    consensus + broadcast window (the p99-through-resize cell in
    BASELINE prices exactly that).

    Like the other policies, one instance runs per worker but only
    rank 0's proposals reach the config server.
    """

    p99_target_ms: float = 0.0       # 0 = latency signal off
    backlog_per_worker: float = 4.0
    capacity_per_worker: int = 8     # engine max_batch
    min_size: int = 1
    max_size: int = 8
    hysteresis: int = 2
    idle_patience: int = 8
    queue_depth: int = field(default=0, repr=False)
    running: int = field(default=0, repr=False)
    p99_ms: float = field(default=0.0, repr=False)
    _idle: int = field(default=0, repr=False)
    _pending: int = field(default=0, repr=False)
    _streak: int = field(default=0, repr=False)
    _seen: bool = field(default=False, repr=False)

    def observe(self, queue_depth: int, running: int,
                p99_ms: float) -> None:
        """Feed the latest ledger stats scrape."""
        self.queue_depth = int(queue_depth)
        self.running = int(running)
        self.p99_ms = float(p99_ms)
        self._seen = True
        if self.queue_depth == 0:
            self._idle += 1
        else:
            self._idle = 0

    def target_size(self, current_size: int) -> int:
        want = current_size
        backlogged = (self.queue_depth
                      > self.backlog_per_worker * current_size)
        slo_violated = (self.p99_target_ms > 0
                        and self.p99_ms > self.p99_target_ms)
        if backlogged or slo_violated:
            want = current_size + 1
        elif (self._idle >= self.idle_patience
              and self.running <= (current_size - 1)
              * self.capacity_per_worker):
            want = current_size - 1
        return max(self.min_size, min(self.max_size, want))

    def __call__(self, current_size: int) -> int | None:
        """Desired cluster size, or None to leave the tier alone."""
        if not self._seen:
            return None
        want = self.target_size(current_size)
        if want == current_size:
            self._streak = 0
            return None
        if want == self._pending:
            self._streak += 1
        else:
            self._pending, self._streak = want, 1
        if self._streak >= self.hysteresis:
            self._streak = 0
            if want < current_size:
                self._idle = 0  # one shrink per idle episode
            return want
        return None


# -- cost-aware policies over the goodput metrics plane -----------------------

class _WireSpikeReader:
    """Shared signal extraction for the straggler policies: per-step
    deltas of the goodput counters, a median clean-step wire
    baseline, and spike detection.

    A live rank cannot see WHICH peer is slow — what it sees is its
    own ``step.grad_wire`` wait inflating while compute stays flat
    (the collective barriers on the slowest peer). The meter feeds
    that wait into ``kf_lost_ms_total{phase="wire"}``; a step whose
    wire delta exceeds ``spike_factor`` x the clean-step baseline
    (floored at ``spike_floor_ms`` so loopback-noise microseconds
    cannot trigger) reads as straggler wait. The baseline is the
    MEDIAN of a recent-clean-step window, and the run's first
    ``warmup`` steps never enter it: step 0's wire wait carries the
    compile + join skew of whoever started last (tens to hundreds of
    ms even on a clean cluster) and a mean-style baseline seeded from
    it would need 3x-that before calling anything a spike — the
    straggler would ride under a poisoned threshold. Spike steps
    don't enter the window either, so a long straggler episode
    cannot normalize itself into the baseline.
    """

    spike_factor: float
    spike_floor_ms: float
    #: startup steps excluded from baseline learning AND spike
    #: detection (compile/join skew, not a signal)
    _WARMUP = 1
    #: clean-step deltas the median baseline is computed over
    _WINDOW = 8

    def observe_progress(self, step: int, total_steps: int) -> None:
        """Run-progress feed; the naive baseline ignores it (no cost
        model to amortize), `GoodputPolicy` overrides."""

    def _init_reader(self, registry) -> None:
        if registry is None:
            from ..trace.metrics import REGISTRY
            registry = REGISTRY
        self._registry = registry
        self._last_useful = 0.0
        self._last_wire = 0.0
        self._clean_wire: deque = deque(maxlen=self._WINDOW)
        self._wire_ema = 0.0
        self._step_ema = 0.0
        self._seen = 0

    def _read_step(self):
        """(useful_ms, wire_ms, spike) for the step since last call."""
        useful = self._registry.read("kf_useful_ms_total")
        wire = self._registry.read("kf_lost_ms_total", phase="wire")
        d_useful = max(0.0, useful - self._last_useful)
        d_wire = max(0.0, wire - self._last_wire)
        self._last_useful, self._last_wire = useful, wire
        warm = self._seen >= self._WARMUP
        threshold = max(self.spike_factor * self._wire_ema,
                        self.spike_floor_ms)
        # no spike call without a baseline: the floor is a noise
        # floor, not a baseline — if every clean step's wire wait sat
        # above it (routine off-loopback), classifying the first warm
        # step as a spike would keep the window empty FOREVER and
        # brand the whole run a straggler episode. The first warm
        # step always seeds the window; a straggler active that early
        # inflates the baseline for at most one window length (spike
        # steps never refresh it, clean steps evict it).
        spike = warm and bool(self._clean_wire) and d_wire > threshold
        if warm and not spike:
            self._clean_wire.append(d_wire)
            self._wire_ema = median(self._clean_wire)
        if warm:
            a = 0.3 if self._step_ema else 1.0
            self._step_ema = ((1 - a) * self._step_ema
                              + a * (d_useful + d_wire))
        self._seen += 1
        return d_useful, d_wire, spike


@dataclass
class NaiveStragglerPolicy(_WireSpikeReader):
    """The static baseline: shed the slow peer as soon as the wire
    spikes for `patience` consecutive steps. No cost model — it pays
    a resize (recompile + resync + a worker's throughput for the rest
    of the run) for ANY straggler, transient or not. Shrinks exactly
    once; shrinking evicts the highest rank, which is where the
    canned straggler scenarios pin the slow host."""

    patience: int = 2
    min_size: int = 1
    spike_factor: float = 3.0
    spike_floor_ms: float = 50.0
    registry: object = None

    def __post_init__(self):
        self._init_reader(self.registry)
        self._streak = 0
        self._shed = False

    def __call__(self, current_size: int) -> int | None:
        _, _, spike = self._read_step()
        if self._shed or current_size <= self.min_size:
            return None
        self._streak = self._streak + 1 if spike else 0
        if self._streak >= self.patience:
            self._shed = True
            return max(self.min_size, current_size - 1)
        return None


@dataclass
class GoodputPolicy(_WireSpikeReader):
    """Cost-aware sizing from the goodput registry families.

    Two priced decisions (docs/observability.md "GoodputPolicy"):

    - **shrink vs ride out a straggler** — ski-rental: accumulate the
      observed straggler excess (wire delta above baseline on spike
      steps, decayed on clean steps so a RECOVERED transient drains
      away) and shed the slow peer only once the accumulated excess
      exceeds ``shed_cost_ms`` — the priced resize (recompile +
      resync; default from the adaptation benchmark's measured
      resize latency). A transient straggler that stops before
      costing a resize's worth is ridden out: no proposal, no churn.
    - **is a resize worth its stall** — `worth_resize`: grow/shrink
      only when the useful rank-milliseconds the new size buys over
      the REMAINING run (`observe_progress`) exceed the stall every
      member pays. Applied to re-growing after a shed once spikes
      cease; exposed for any caller pricing a planned resize.

    Like `NoiseScalePolicy`, one instance runs per worker but only
    rank 0's proposals reach the config server.
    """

    min_size: int = 1
    max_size: int = 8
    shed_cost_ms: float = 1500.0
    spike_factor: float = 3.0
    spike_floor_ms: float = 50.0
    decay: float = 0.5
    regrow_patience: int = 3
    registry: object = None
    #: accumulated straggler excess (ms) — the ski-rental meter
    excess_ms: float = field(default=0.0, repr=False)

    def __post_init__(self):
        self._init_reader(self.registry)
        self._shed_from = 0
        self._calm = 0
        self._step = 0
        self._total_steps = 0

    def observe_progress(self, step: int, total_steps: int) -> None:
        """Feed run progress — the amortization horizon for
        `worth_resize` (a resize near the end of a run can never pay
        for itself)."""
        self._step = int(step)
        self._total_steps = int(total_steps)

    def worth_resize(self, current_size: int, want: int,
                     step_ms: float, remaining_steps: int) -> bool:
        """True when resizing `current_size` -> `want` pays: extra
        useful rank-ms over the remaining run vs the stall every
        member of the NEW cluster pays. A shrink never pays on
        throughput grounds (its rank-ms delta is a loss) — shedding a
        straggler is priced by the ski-rental meter, not here."""
        if remaining_steps <= 0 or step_ms <= 0:
            return False
        gain_ms = remaining_steps * step_ms * (want - current_size)
        return gain_ms > self.shed_cost_ms * max(want, current_size)

    def __call__(self, current_size: int) -> int | None:
        _, d_wire, spike = self._read_step()
        if spike:
            self._calm = 0
            self.excess_ms += max(0.0, d_wire - self._wire_ema)
            if self.excess_ms > self.shed_cost_ms \
                    and current_size > self.min_size:
                # the straggler has now cost a resize's worth: shedding
                # pays off even if it stops immediately (ski-rental)
                self._shed_from = current_size
                self.excess_ms = 0.0
                return current_size - 1
        else:
            self.excess_ms *= self.decay
            self._calm += 1
            if (self._shed_from > current_size
                    and self._calm >= self.regrow_patience
                    and self._shed_from <= self.max_size
                    and self.worth_resize(
                        current_size, self._shed_from, self._step_ema,
                        self._total_steps - self._step)):
                target, self._shed_from = self._shed_from, 0
                return target
        return None
