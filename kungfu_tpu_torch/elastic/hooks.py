"""Elastic training-loop hooks: schedule-driven resize + state resync.

Rebuild of the reference's elastic hooks (reference: srcs/python/kungfu/
tensorflow/hooks/elastic.py and experimental/hook/elastic.py): after every
step the callback checks the schedule, proposes a new cluster size to the
config server, polls for agreed membership changes, and — when the epoch
switches — resyncs the training position (max step / trained samples over
survivors) and re-broadcasts model state to joiners.

The port of `kungfu_tpu/elastic/hooks.py`: the state a resync carries is
a list of tensors in a fixed order (a model's parameters, then its
optimizer state), broadcast in place on the CPU or the card; the
``placement`` (kfspec resharding) of `resync_params` comes with the
parallel axes (ROADMAP queue 1 item 9). Everything else — the schedule,
the consensus resize, the `KF_MTTR` markers and trace events of
`recover` — is the reference's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import chaos, trace
from ..ops.collective import pack_bytes, unpack_bytes
from ..peer import Peer
from .schedule import step_based_schedule


@dataclass
class ElasticState:
    # both counters advance in lockstep on every member and are
    # re-agreed by sync_position()'s max all-reduce at every epoch
    # switch and recovery, so a joiner adopts the survivors' values
    # before its first wire name uses them
    # kf: cluster-agreed — re-synced via sync_position (max all-reduce)
    step: int = 0
    # kf: cluster-agreed — re-synced via sync_position (max all-reduce)
    trained_samples: int = 0
    changed: bool = False
    keep: bool = True


class ElasticCallback:
    """Drives propose -> consensus-resize -> resync from a training loop.

    Usage:
        elastic = ElasticCallback(peer, schedule="100:2,100:4")
        while elastic.state.keep and elastic.state.step < max_steps:
            params_s, opt_s, loss = train_step(...)
            if elastic.after_step():       # True => epoch switched
                params = elastic.resync_params(params)   # joiners synced
                # rebuild mesh/jit for the new cluster size here
    """

    def __init__(
        self,
        peer: Peer,
        schedule: str = "",
        config_server: str = "",
        samples_per_step: int = 0,
        policy=None,
    ):
        """`policy` is a callable ``(current_size) -> Optional[int]``
        (e.g. :class:`~kungfu_tpu.elastic.NoiseScalePolicy`) consulted
        when no static schedule is given — the monitor-driven form of
        the reference's schedule-driven resize."""
        self.peer = peer
        self.schedule = schedule
        self.policy = policy
        self.config_server = config_server or peer.config.config_server
        self.samples_per_step = samples_per_step
        self.state = ElasticState()
        # consecutive propose failures — bounded visibility, not silence
        self._propose_failures = 0
        #: per-phase wall times (ms) of the last completed epoch switch,
        #: merged from peer.last_resize_phases + the resync phases below
        self.last_resize_timings: dict = {}

    def after_step(self) -> bool:
        """Advance one step; returns True when cluster membership changed
        (caller must then resync state and rebuild its mesh)."""
        st = self.state
        st.step += 1
        st.trained_samples += self.samples_per_step * self.peer.size
        # the SPMD trace context follows the cluster-agreed counters:
        # every event this process emits from here on is attributed to
        # the step that is actually running
        trace.set_context(step=st.step, version=self.peer.version)
        # deterministic fault injection: a scheduled crash_worker (or
        # host-scoped crash_host) fault for (rank/host, step) fires
        # here, so chaos tests drive the SAME step boundary production
        # failures hit (kungfu_tpu/chaos.py)
        chaos.on_step(self.peer.rank, st.step,
                      host=self.peer.host_index)
        want = None
        if self.schedule:
            want = step_based_schedule(self.schedule, st.step)
            if want == self.peer.size:
                want = None
        elif self.policy is not None:
            want = self.policy(self.peer.size)
        if want is not None and self.peer.rank == 0:
            try:
                # propose_new_size's fetch/put ride the shared retry
                # policy (kungfu_tpu/retrying.py) — transient server
                # hiccups are backed off and LOGGED there; what reaches
                # this handler already exhausted its bounded attempts
                self.peer.propose_new_size(want, self.config_server)
                self._propose_failures = 0
            except (RuntimeError, OSError, ValueError, KeyError,
                    TypeError) as e:
                # retrying.py's taxonomy: RuntimeError covers KfError,
                # OSError the HTTP layer, ValueError/KeyError/TypeError
                # a torn or malformed stage (int(None) is TypeError) —
                # anything else is a bug and raises
                self._propose_failures += 1
                print(
                    f"[kf-elastic] propose(size={want}) gave up after "
                    f"bounded retries ({self._propose_failures} "
                    f"consecutive): {e}",
                    flush=True,
                )
        changed, keep = self.peer.resize_from_url(self.config_server)
        st.changed, st.keep = changed, keep
        if changed:
            # rank/version may both have moved with the new epoch
            trace.set_context(rank=self.peer.rank,
                              version=self.peer.version)
            trace.event("resize.adopted", cat="elastic",
                        size=self.peer.size, keep=keep)
        # straggler sleeps fire AFTER the consensus round so a slow
        # host is late to the next step's gradient all-reduce, not to
        # the control-plane barrier above (kungfu_tpu/chaos.py)
        chaos.on_step_end(self.peer.rank, st.step)
        return changed

    # -- survivor-driven failure recovery ------------------------------------

    def recover(self, params: Optional[Sequence[torch.Tensor]] = None,
                deadline_s: float = 30.0):
        """Rejoin training after a collective failed with a peer death.

        Polls the config server until the detecting runner's shrunken
        stage appears, adopts it (`Peer.recover_from_url` — no vote from
        the dead peer needed), then restores state across the survivors:
        re-broadcast `params` from the new rank 0 and re-agree the
        training position. Emits `KF_MTTR` markers for each phase so the
        recovery benchmark can decompose detect/consensus/restore.

        Returns `params` (re-broadcast in place) on success — True when
        no params were given — and None when
        no recovery stage arrived within `deadline_s` or this worker was
        evicted — the caller should then fall back to fail-fast (raise /
        exit nonzero).

        Multi-death shape (a whole host SIGKILLed, several peers gone
        at once — the `crash_host` chaos fault): the detecting runner
        proposes one shrunken stage covering every reaped death, but a
        survivor can race an intermediate stage that still contains a
        dead peer, or a second death can land while the restore
        collectives run. Both surface as KF_ERR_CONN/TIMEOUT/CORRUPT
        *inside* the restore — the same fail-fast taxonomy that got us
        here — so the restore failure loops back into the adopt poll
        (bounded by the shared deadline) instead of killing the
        survivor: every transport and topology role fails into ONE
        recovery state machine (docs/fault_tolerance.md)."""
        from ..ffi import KfError

        t0 = time.time()
        print(f"KF_MTTR error t={t0 * 1e3:.1f} rank={self.peer.rank} "
              f"epoch={self.peer.version}", flush=True)
        # flight-record the ring NOW: the epoch that just failed is
        # about to be torn down, and if recovery itself dies this is
        # the only record of what the step was doing when the peer
        # vanished (docs/observability.md, flight-recorder lifecycle)
        trace.event("recovery.caught", cat="recovery",
                    epoch=self.peer.version)
        trace.flight_dump(reason="recovery")
        deadline = time.monotonic() + deadline_s
        while True:
            with trace.span("recovery.adopt", cat="recovery") as sp:
                recovered, keep = self.peer.recover_from_url(
                    self.config_server,
                    deadline_s=max(0.0, deadline - time.monotonic()))
                sp.set(recovered=recovered, keep=keep)
            if not recovered or not keep:
                # state.keep lets the caller tell a legitimate eviction
                # (exit 0, like the planned-resize path) from a recovery
                # timeout (fail fast)
                self.state.changed, self.state.keep = recovered, keep
                print(f"KF_MTTR giveup t={time.time() * 1e3:.1f} "
                      f"recovered={recovered} keep={keep}", flush=True)
                return None
            t1 = time.time()
            print(f"KF_MTTR adopted t={t1 * 1e3:.1f} "
                  f"rank={self.peer.rank} epoch={self.peer.version} "
                  f"size={self.peer.size}", flush=True)
            # the recovered epoch is live: re-bind the trace context
            # before the restore collectives emit under it
            trace.set_context(rank=self.peer.rank,
                              version=self.peer.version)
            try:
                with trace.span("recovery.restore", cat="recovery",
                                size=self.peer.size):
                    if params is not None:
                        params = self.resync_params(params)
                    else:
                        self.sync_position()
                break
            except KfError as e:
                # another peer died while the restore collectives ran
                # (whole-host deaths arrive as a burst): fail back into
                # the adopt poll for the next shrunken stage
                if time.monotonic() >= deadline:
                    self.state.changed, self.state.keep = False, True
                    print(f"KF_MTTR giveup t={time.time() * 1e3:.1f} "
                          f"restore-failed={e}", flush=True)
                    return None
                print(f"[kf-recover] restore in epoch "
                      f"{self.peer.version} failed ({e}); re-entering "
                      "the recovery poll", flush=True)
                trace.event("recovery.restore_failed", cat="recovery",
                            epoch=self.peer.version)
        t2 = time.time()
        print(f"KF_MTTR restored t={t2 * 1e3:.1f} rank={self.peer.rank} "
              f"adopt_ms={(t1 - t0) * 1e3:.1f} "
              f"restore_ms={(t2 - t1) * 1e3:.1f}", flush=True)
        self.state.changed, self.state.keep = True, True
        return params if params is not None else True

    # -- state resync over the control plane --------------------------------

    def sync_position(self) -> Tuple[int, int]:
        """Agree on (step, trained_samples) = max over survivors
        (reference: hooks/elastic.py:43-47, experimental elastic.py:25-37)."""
        buf = np.array([self.state.step, self.state.trained_samples],
                       dtype=np.int64)
        agreed = self.peer.all_reduce(buf, op="max", name="kf::elastic::pos")
        self.state.step = int(agreed[0])
        self.state.trained_samples = int(agreed[1])
        return self.state.step, self.state.trained_samples

    def resync_params(self, params: Sequence[torch.Tensor], root: int = 0,
                      chunk_mb: Optional[float] = None
                      ) -> List[torch.Tensor]:
        """Broadcast `params` (a list of tensors in a fixed order, e.g.
        a model's parameters followed by its optimizer state) from
        `root` so joiners adopt survivor state, in place (the
        reference's BroadcastGlobalVariablesOp at the epoch boundary).
        Byte-exact: every dtype survives. Returns the list.

        Default data path is the chunked pipeline
        (`elastic.streaming.stream_broadcast`); `chunk_mb` overrides the
        chunk size (else KF_STREAM_CHUNK_MB, else the module default),
        and a non-positive value selects the monolithic `pack_bytes ->
        broadcast -> unpack_bytes` path.

        Records the phase decomposition into `last_resize_timings`
        (merged with the peer's fetch/consensus/adopt-barrier phases):
        `pack_ms` / `broadcast_ms` / `position_ms`, plus `overlap_ms`,
        `stream_chunks` and `bytes` on the streaming path."""
        from .streaming import stream_broadcast, stream_chunk_bytes

        params = list(params)
        t0 = time.perf_counter()
        chunk_bytes = stream_chunk_bytes(chunk_mb)
        with trace.span("resize.resync", cat="elastic",
                        size=self.peer.size) as sp:
            if chunk_bytes > 0:
                out, phases = stream_broadcast(
                    self.peer, params, root=root,
                    chunk_bytes=chunk_bytes,
                    name="kf::elastic::model")
                t_bcast = time.perf_counter()
                self.sync_position()
                t_pos = time.perf_counter()
                self.last_resize_timings = {
                    **self.peer.last_resize_phases,
                    "pack_ms": phases["pack_ms"],
                    "broadcast_ms": phases["broadcast_ms"],
                    "overlap_ms": phases["overlap_ms"],
                    "stream_wall_ms": phases["wall_ms"],
                    "stream_chunks": phases["chunks"],
                    "bytes": phases["bytes"],
                    "position_ms": (t_pos - t_bcast) * 1e3,
                }
            else:
                packed = pack_bytes(params)
                t_pack = time.perf_counter()
                synced = self.peer.broadcast(packed, root=root,
                                             name="kf::elastic::model")
                t_bcast = time.perf_counter()
                self.sync_position()
                t_pos = time.perf_counter()
                with torch.no_grad():
                    for t, u in zip(params, unpack_bytes(synced, params)):
                        t.copy_(u)
                out = params
                self.last_resize_timings = {
                    **self.peer.last_resize_phases,
                    "pack_ms": (t_pack - t0) * 1e3,
                    "broadcast_ms": (t_bcast - t_pack) * 1e3,
                    "position_ms": (t_pos - t_bcast) * 1e3,
                    "bytes": int(packed.nbytes),
                }
            sp.set(**{k: round(v, 3) if isinstance(v, float) else v
                      for k, v in self.last_resize_timings.items()})
            return out


def shard_offset(
    trained_samples: int, rank: int, size: int, batch: int
) -> int:
    """Dataset offset for a joining worker (the reference's elastic dataset
    adaptor skips `trained_samples` then shards by rank;
    reference: v1/datasets/adaptor.py:28-33)."""
    return trained_samples + rank * batch
