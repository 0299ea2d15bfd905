"""Request-scoped tracing: per-request phase breakdown + tail-sampled
flight recorder.

Process-level telemetry (spans, counters, the journal) answers "how is the
server doing"; it cannot answer the question that matters at tail-latency
scale: *why was this specific request slow* — queue wait, batch assembly,
a cold-bucket compile, device compute, or the response write? The
standard answer is per-request causal tracing (Dapper, Sigelman et al.
2010) with tail-based retention (The Tail at Scale, Dean & Barroso 2013):
every request carries a trace context, but only the *interesting* traces
are kept.

``RequestTrace`` is the context the HTTP handler creates at admission and
threads through ``MicroBatcher.submit`` → ``_flush`` → the engine: each
layer stamps its phase boundaries (``time.perf_counter`` throughout, one
clock for the whole request) and annotations (flush sequence, bucket,
whether the flush hit a cold compile). Phases partition the server-side
request interval, so their durations sum to the end-to-end latency.

``FlightRecorder`` is the bounded ring completed traces report into, with
**tail-based sampling**: every error / timeout / shed trace is kept, and
an ok trace is kept only when its latency reaches the recorder's moving
tail quantile (default p99 over a ring of recent ok latencies — the slow
tail, exactly the traces worth a human's time). The fast majority is
dropped after updating the quantile window; sampling decisions are
counted in the global registry (``reqtrace_sampled_total{reason=…}`` /
``reqtrace_dropped_total``) so the drop rate itself is observable.

A sampled trace is also merged into the active Chrome-trace export
(``obs.spans``): its phases render on a per-request virtual lane, and a
``req:<id>`` slice lands *inside* the batcher's ``serve:flush`` span (on
the flush thread's track, within the device-compute window), so a
Perfetto timeline shows each flush with its constituent sampled requests.

Import-safe without jax (stdlib + numpy), same as ``journal``/``registry``.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Any

import numpy as np

from machine_learning_replications_tpu_torch.obs import spans
from machine_learning_replications_tpu_torch.obs.registry import REGISTRY

# Registered at import (rule metrics-catalog): present on the first
# scrape, before any recorder is constructed.
REQTRACE_SAMPLED = REGISTRY.counter(
    "reqtrace_sampled_total",
    "Request traces kept by the flight recorder, by keep reason.",
    labels=("reason",),
)
REQTRACE_DROPPED = REGISTRY.counter(
    "reqtrace_dropped_total",
    "Completed request traces dropped by tail sampling (fast majority).",
)

#: Phase names in request order (docs/OBSERVABILITY.md "Request traces").
#: A device-path request records parse → queue_wait → batch_assembly →
#: device_compute → respond; a host-path request (dual-path scoring,
#: docs/SERVING.md) records parse → queue_wait (host-slot wait) →
#: host_compute → respond. Every /predict trace carries a ``path``
#: annotation (``host`` | ``device``) plus the router's ``path_reason``,
#: so tail samples say not just where the time went but which engine the
#: request was routed to and why.
PHASES = (
    "parse", "queue_wait", "batch_assembly", "device_compute",
    "host_compute", "respond",
)

_ID_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)
MAX_ID_LEN = 128

# Request ids are a random per-process prefix + a monotonic counter: the
# counter guarantees in-process uniqueness, the prefix disambiguates
# SO_REUSEPORT workers sharing one port. uuid4 per request would cost an
# os.urandom syscall (~100 µs of the event loop's per-request budget);
# trace ids are correlation keys, not security tokens.
_ID_PREFIX = os.urandom(2).hex()
_ID_COUNTER = itertools.count(1)  # next() is atomic under the GIL


def new_request_id() -> str:
    return _ID_PREFIX + format(next(_ID_COUNTER) & 0xFFFFFFFFFFFF, "012x")


def sanitize_request_id(raw: str | None) -> str:
    """An inbound ``X-Request-Id`` → a safe id (hostile headers must not
    inject into JSON logs or response headers): charset-restricted,
    length-capped, regenerated when empty/invalid."""
    if not raw:
        return new_request_id()
    raw = raw.strip()
    if not raw or len(raw) > MAX_ID_LEN or not set(raw) <= _ID_OK:
        return new_request_id()
    return raw


class RequestTrace:
    """One request's causal record: id, phase boundaries, annotations.

    Stamps are raw ``time.perf_counter`` values; ``add_phase`` intervals
    may be recorded from any thread (the handler stamps parse/respond, the
    batcher's flush thread stamps queue_wait/batch_assembly/
    device_compute) — same monotonic clock, so the phases compose into one
    timeline. A small lock covers the phase/meta dicts: on the
    deadline-expiry path the handler can snapshot a trace the flush
    thread is still stamping (cancel lost the claim race), and a dict
    mutating under iteration would take the snapshot down."""

    __slots__ = (
        "request_id", "t_start", "wall_start", "phases", "meta", "status",
        "t_end", "error", "_lock",
    )

    def __init__(self, request_id: str | None = None) -> None:
        self.request_id = request_id or new_request_id()
        self.t_start = time.perf_counter()
        # Display timestamp on the exported trace; phase durations
        # use the span clock, never this.
        self.wall_start = time.time()  # graftcheck: disable=monotonic-clock
        self.phases: dict[str, tuple[float, float]] = {}
        self.meta: dict[str, Any] = {}
        self.status: str | None = None
        self.t_end: float | None = None
        self.error: str | None = None
        self._lock = threading.Lock()

    def add_phase(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            # A finished trace is immutable: on the 504 path the flush
            # thread can win the cancel race and try to stamp compute
            # phases AFTER the handler closed the trace — accepting them
            # would push phase ends past t_end and break the
            # phases-partition-the-interval invariant /debug/requests
            # publishes.
            if self.t_end is not None:
                return
            self.phases[name] = (t0, t1)

    def add_phases(self, phases: dict[str, tuple[float, float]],
                   **meta: Any) -> None:
        """Stamp several phases (and meta annotations) under ONE lock
        round-trip — the batcher stamps three flush-side phases plus its
        annotations per batch member, and per-phase locking is measurable
        at event-loop throughput. Same immutability rule as
        ``add_phase``."""
        with self._lock:
            if self.t_end is not None:
                return
            self.phases.update(phases)
            if meta:
                self.meta.update(meta)

    def drop_phases(self, *names: str) -> None:
        """Remove phases from a live trace. The host→device failure
        fallback uses this: the failed host attempt's queue_wait /
        host_compute would otherwise overlap the device path's fresh
        queue_wait (which restarts at parse end) and break the
        phases-partition-the-interval invariant — the abandoned attempt's
        time is deliberately re-attributed as device-path queueing."""
        with self._lock:
            if self.t_end is not None:
                return
            for name in names:
                self.phases.pop(name, None)

    def phase_end(self, name: str, default: float) -> float:
        """End stamp of a recorded phase (``default`` when absent) — the
        hand-off point the next phase starts from."""
        with self._lock:
            interval = self.phases.get(name)
        return interval[1] if interval is not None else default

    def note(self, **kv: Any) -> None:
        with self._lock:
            if self.t_end is not None:
                return
            self.meta.update(kv)

    def finish(self, status: str, error: str | None = None) -> "RequestTrace":
        with self._lock:
            if self.t_end is None:  # first finish wins; then immutable
                self.status = status
                self.error = error
                self.t_end = time.perf_counter()
        return self

    @property
    def total_s(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return end - self.t_start

    def phase_seconds(self) -> dict[str, float]:
        with self._lock:
            phases = dict(self.phases)
        return {
            name: max(t1 - t0, 0.0) for name, (t0, t1) in phases.items()
        }

    def snapshot(self) -> dict:
        """The JSON-friendly record ``/debug/requests`` serves: durations
        in seconds (6-decimal µs precision), phase start offsets from
        request start so a consumer can reconstruct the timeline."""
        with self._lock:
            phases = dict(self.phases)
            meta = dict(self.meta)
        return {
            "request_id": self.request_id,
            "status": self.status,
            "ts": self.wall_start,
            # Raw perf_counter admission stamp: the anchor the fleet
            # trace join (obs.fleettrace) maps through the per-replica
            # clock offset — offsets alone cannot place this trace on
            # another process's timeline.
            "t_start_perf": round(self.t_start, 6),
            "total_seconds": round(self.total_s, 6),
            "phases": {
                name: {
                    "offset_seconds": round(t0 - self.t_start, 6),
                    "seconds": round(max(t1 - t0, 0.0), 6),
                }
                for name, (t0, t1) in phases.items()
            },
            **({"error": self.error} if self.error else {}),
            **meta,
        }


#: Lanes for merged request timelines: a small fixed pool keeps the
#: Perfetto track count bounded no matter how many requests are sampled
#: over a long run (lanes are reused once their previous occupant ends).
_N_LANES = 8


class FlightRecorder:
    """Bounded ring of completed request traces with tail-based sampling.

    Keep policy, in order:
      * ``status != "ok"`` (error / timeout / shed / engine failure):
        always kept — failures are never sampled away;
      * ok and the latency window is still warming up (< ``min_window``
        observations): kept, so a fresh process has samples immediately;
      * ok and ``total_s`` ≥ the ``tail_quantile`` (default 0.99) of the
        recent-ok-latency ring: kept — the p99 tail;
      * otherwise dropped (counted, never stored).

    The ring holds at most ``capacity`` snapshots (dicts, not live trace
    objects); memory stays bounded for the life of the process.

    Separately from the sampled ring, EVERY completed trace is indexed by
    request id in a bounded FIFO (``index_capacity`` most recent) for
    ``lookup`` — the ``/debug/requests?id=`` exact fetch the fleet trace
    join rides on. Tail sampling alone cannot serve that join: the router
    and a replica sample independently, so a router-sampled request would
    usually be dropped replica-side. The index stores the finished (hence
    immutable) trace *objects* and snapshots only on lookup, so the hot
    path pays one dict insert, not a snapshot build per request.
    """

    def __init__(
        self,
        capacity: int = 256,
        tail_quantile: float = 0.99,
        window: int = 2048,
        min_window: int = 32,
        index_capacity: int = 4096,
    ) -> None:
        if not 0.0 < tail_quantile < 1.0:
            raise ValueError(
                f"tail_quantile must be in (0, 1), got {tail_quantile}"
            )
        if capacity < 1 or window < 1:
            raise ValueError(
                f"capacity and window must be >= 1, got {capacity}/{window}"
            )
        if index_capacity < 1:
            raise ValueError(
                f"index_capacity must be >= 1, got {index_capacity}"
            )
        self.capacity = int(capacity)
        self.tail_quantile = float(tail_quantile)
        self.min_window = int(min_window)
        self.index_capacity = int(index_capacity)
        self._lock = threading.Lock()
        self._by_id: collections.OrderedDict[str, RequestTrace] = \
            collections.OrderedDict()
        self._samples: list[dict] = []
        self._next = 0  # ring write index
        self._lat = np.empty(int(window), np.float64)
        self._lat_n = 0
        # The tail threshold is CACHED and refreshed every
        # _REFRESH_EVERY ok completions: an exact per-request percentile
        # over the window would serialize every handler thread on an
        # O(window log window) sort inside this lock — the hot path pays
        # a ring write and a float compare instead.
        self._threshold: float | None = None
        self._threshold_age = 0
        self._dropped_n = 0  # THIS recorder's drops (the registry
        # counters below are process-global and would mix recorders)
        self._lane_busy_until = [0.0] * _N_LANES
        self._sampled = REQTRACE_SAMPLED
        self._dropped = REQTRACE_DROPPED

    # -- sampling ----------------------------------------------------------

    #: ok completions between threshold refreshes (the cached quantile
    #: lags current traffic by at most this many requests).
    _REFRESH_EVERY = 64

    def _tail_threshold_locked(self) -> float | None:
        n = min(self._lat_n, self._lat.shape[0])
        if n < self.min_window:
            return None
        if self._threshold is None or self._threshold_age >= \
                self._REFRESH_EVERY:
            self._threshold = float(np.percentile(
                self._lat[:n], self.tail_quantile * 100.0
            ))
            self._threshold_age = 0
        return self._threshold

    def record(self, trace: RequestTrace) -> bool:
        """Apply the keep policy to a finished trace; returns whether it
        was kept. Kept traces are stored and merged into the active
        Chrome-trace export."""
        total = trace.total_s
        with self._lock:
            # Exact-lookup index first: EVERY completed trace, sampled or
            # not (a re-used request id overwrites — latest completion
            # wins, and re-inserting refreshes its FIFO position).
            self._by_id[trace.request_id] = trace
            self._by_id.move_to_end(trace.request_id)
            while len(self._by_id) > self.index_capacity:
                self._by_id.popitem(last=False)
            if trace.status == "ok":
                threshold = self._tail_threshold_locked()
                self._lat[self._lat_n % self._lat.shape[0]] = total
                self._lat_n += 1
                self._threshold_age += 1
                if threshold is None:
                    reason = "bootstrap"
                elif total >= threshold:
                    reason = "tail"
                else:
                    reason = None
            else:
                reason = "failure"
            if reason is None:
                keep = False
                self._dropped_n += 1
            else:
                snap = trace.snapshot()
                snap["sampled_reason"] = reason
                if len(self._samples) < self.capacity:
                    self._samples.append(snap)
                else:
                    self._samples[self._next % self.capacity] = snap
                self._next += 1
                keep = True
        if keep:
            self._sampled.inc(reason=reason)
            self._emit_to_tracer(trace)
        else:
            self._dropped.get().inc()
        return keep

    # -- inspection --------------------------------------------------------

    def snapshot(self, n: int | None = None) -> list[dict]:
        """Most-recent-first sampled traces (at most ``n``)."""
        with self._lock:
            if len(self._samples) < self.capacity:
                ordered = list(self._samples)
            else:
                i = self._next % self.capacity
                ordered = self._samples[i:] + self._samples[:i]
        ordered.reverse()
        return ordered if n is None else ordered[: max(int(n), 0)]

    def lookup(self, request_id: str) -> dict | None:
        """Exact fetch by request id over the completed-trace index (the
        ``/debug/requests?id=`` primitive). None when the id never
        completed here or has been evicted (FIFO, ``index_capacity``
        most recent)."""
        with self._lock:
            trace = self._by_id.get(request_id)
        return None if trace is None else trace.snapshot()

    def stats(self) -> dict:
        with self._lock:
            n_lat = min(self._lat_n, self._lat.shape[0])
            threshold = self._tail_threshold_locked()
            dropped = self._dropped_n
            indexed = len(self._by_id)
        return {
            "capacity": self.capacity,
            "stored": min(self._next, self.capacity),
            "kept_total": self._next,
            "dropped_total": dropped,
            "indexed": indexed,
            "index_capacity": self.index_capacity,
            "tail_quantile": self.tail_quantile,
            "tail_threshold_seconds": (
                None if threshold is None else round(threshold, 6)
            ),
            "latency_window": n_lat,
        }

    # -- Chrome-trace merge ------------------------------------------------

    def _lane(self, t0: float, t1: float) -> int:
        """First lane free at ``t0`` (its previous request already ended);
        falls back to lane 0 — overlap there is cosmetic, not data loss."""
        with self._lock:
            for i, busy_until in enumerate(self._lane_busy_until):
                if busy_until <= t0:
                    self._lane_busy_until[i] = t1
                    return i
            return 0

    def _emit_to_tracer(self, trace: RequestTrace) -> None:
        """Merge a kept trace into the active tracer: the request and its
        phases on a per-request lane, plus a ``req:<id>`` slice inside the
        flush span's device-compute window on the flush thread's track —
        the containment Perfetto renders as request-under-flush."""
        tracer = spans.get_tracer()
        if tracer is None or trace.t_end is None:
            return
        with trace._lock:
            phases = dict(trace.phases)
            meta = dict(trace.meta)
        lane = tracer.virtual_tid(
            f"req-lane-{self._lane(trace.t_start, trace.t_end)}"
        )
        args = {
            "request_id": trace.request_id,
            "status": trace.status,
            **{
                k: v for k, v in meta.items()
                if isinstance(v, (str, int, float, bool, type(None)))
            },
        }
        tracer.add_complete_event(
            f"request {trace.request_id}", trace.t_start, trace.t_end,
            tid=lane, cat="request", args=args,
        )
        for name, (t0, t1) in phases.items():
            tracer.add_complete_event(
                name, t0, t1, tid=lane, cat="request",
                args={"request_id": trace.request_id},
            )
        # Under-the-flush slice: the flush thread stamped its tid and the
        # device-compute window; each batch member owns an equal sub-slice
        # (indexed by its position in the batch) so sampled batchmates
        # render side by side inside the flush span instead of as a
        # degenerate equal-interval nesting stack.
        flush_tid = meta.get("flush_tid")
        compute = phases.get("device_compute")
        rows = meta.get("batch_rows")
        idx = meta.get("flush_index")
        if flush_tid is None or compute is None or not rows or idx is None:
            return
        c0, c1 = compute
        width = (c1 - c0) / float(rows)
        tracer.add_complete_event(
            f"req:{trace.request_id}",
            c0 + idx * width, c0 + (idx + 1) * width,
            tid=int(flush_tid), cat="request",
            args={
                "request_id": trace.request_id, "status": trace.status,
                "slice": "flush membership (width = compute/rows)",
                "compute_seconds": round(c1 - c0, 6),
            },
        )
